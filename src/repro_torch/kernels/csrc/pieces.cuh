// Piece tables shared by K1 (bsr_spmv.cu) and K2 (segment_sum.cu): a sorted
// list of owner ids (a tile's row block, a chunk's output block) is split
// into each owner's contiguous run of items, and each run into pieces of at
// most `piece` items, one CTA each.  The tables are built on the device,
// with no host sync; kernels/pieces.py's `piece_table` is their plain
// version.  A second pass (`piece_combine`) adds an owner's piece partials
// in piece order, Kahan-compensated, so no float atomics are needed and two
// launches give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace {

// run_start[b] = first i with owner[i] >= b, for b in [0, nb]: thread i in
// [0, n] writes the b in (owner[i - 1], owner[i]]
__global__ void piece_bounds(const int* __restrict__ owner, int n, int nb,
                             int* __restrict__ run_start) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int lo = i == 0 ? 0 : max(0, __ldg(owner + i - 1) + 1);
  const int hi = i == n ? nb : min(nb, __ldg(owner + i));
  for (int b = lo; b <= hi; ++b) run_start[b] = i;
}

constexpr int kPlanThreads = 1024;

// exclusive scan of one int per thread over a CTA of kPlanThreads threads;
// *total receives the sum (every thread reads it after the call)
__device__ __forceinline__ int block_exclusive_scan(int local, int* total) {
  __shared__ int warp_sum[kPlanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int incl = local;   // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    warp_sum[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  *total = warp_sum[kPlanThreads / 32 - 1];
  return incl - local + (warp > 0 ? warp_sum[warp - 1] : 0);
}

// piece_off[b] = sum over b' < b of max(ceil(n_b' / piece), 1), one CTA:
// each thread sums a contiguous range of owners, then a block-wide scan
__global__ void __launch_bounds__(kPlanThreads)
piece_plan(const int* __restrict__ run_start, int nb, int piece,
           int* __restrict__ piece_off) {
  const int tid = threadIdx.x;
  const int per = (nb + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(nb, tid * per), hi = min(nb, lo + per);
  int local = 0;
  for (int b = lo; b < hi; ++b) {
    const int n = run_start[b + 1] - run_start[b];
    local += max((n + piece - 1) / piece, 1);
  }
  int total;
  int run = block_exclusive_scan(local, &total);
  for (int b = lo; b < hi; ++b) {
    piece_off[b] = run;
    const int n = run_start[b + 1] - run_start[b];
    run += max((n + piece - 1) / piece, 1);
  }
  if (tid == kPlanThreads - 1) piece_off[nb] = total;
}

// the owner of piece p: the largest b with piece_off[b] <= p
__device__ __forceinline__ int piece_owner(const int* __restrict__ piece_off, int nb, int p) {
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(piece_off + mid) <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// one CTA of `width` threads per owner: out[b, j] = the Kahan-compensated
// sum of partial[p, j] over the owner's pieces p in order; an owner with
// one piece was written by the pass that made the partials
__global__ void piece_combine(const int* __restrict__ piece_off, const float* __restrict__ partial,
                              float* __restrict__ out, int width) {
  const int b = blockIdx.x, j = threadIdx.x;
  const int p0 = __ldg(piece_off + b), p1 = __ldg(piece_off + b + 1);
  if (p1 - p0 <= 1) return;
  float s = 0.f, cs = 0.f;
  for (int p = p0; p < p1; ++p) {
    const float y = __ldg(partial + static_cast<size_t>(p) * width + j) - cs;
    const float t = s + y;
    cs = (t - s) - y;
    s = t;
  }
  out[static_cast<size_t>(b) * width + j] = s;
}

}  // namespace
