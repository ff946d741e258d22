// Chunked segment sum, out[chunk_block[c], local_ids[c, l]] += vals[c, l]
// (ids >= 128 are padding and add nothing): the sum reductions of the
// engine's "pallas" backend (PageRank's pull, HITS's pull and push).
//
// Replaces the Pallas TPU kernel `segment_sum_chunked` / `_segsum_kernel` in
// src/repro/kernels/segment_sum.py, which turns each chunk into a one-hot
// (L x 128) matrix product on the MXU, with the owning 128-wide output block
// resident in VMEM across the block's consecutive chunks.
//
// Bound on the H100: memory.  Each slot is 8 bytes (an f32 value and an
// int32 id) read once for one add.  The scale-22 PageRank layout holds about
// 0.6 GB of slots per reduction: at least ~0.2 ms at 3.35 TB/s.
//
// Design: one CTA of 128 threads per output block loops over the block's run
// of chunks in order, staging one chunk's ids and values in shared memory.
// Thread j owns output lane j and scans the staged chunk for id j, adding
// matches in slot order.  Ids need not be sorted within a chunk, no float
// atomics are used, and each lane's sum has one fixed order, so the result
// is deterministic.  A hub's segment spans ~10^5 entries at scale 22, where
// a plain sequential f32 sum drifts ~1e-5 relative; the lane's sum is
// Kahan-compensated, which costs a few adds per match and no bytes.  The
// scan costs 128*L compares per chunk against L useful adds; that keeps the
// kernel simple and right, and far from the memory bound.  A faster design (warp-level segmented scans over sorted
// ids) is left to a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // output lanes per block (the reference's DEFAULT_BLOCK)

__global__ void __launch_bounds__(kBlock)
segment_sum_kernel(const float* __restrict__ vals, const int* __restrict__ local_ids,
                   const int* __restrict__ block_start, float* __restrict__ out,
                   int chunk) {
  extern __shared__ unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + chunk);
  const int blk = blockIdx.x, j = threadIdx.x;
  float acc = 0.f, comp = 0.f;  // Kahan-compensated running sum
  for (int c = block_start[blk]; c < block_start[blk + 1]; ++c) {
    const size_t base = static_cast<size_t>(c) * chunk;
    for (int s = j; s < chunk; s += kBlock) {
      sv[s] = vals[base + s];
      si[s] = local_ids[base + s];
    }
    __syncthreads();
    for (int s = 0; s < chunk; ++s) {
      if (si[s] == j) {
        const float y = sv[s] - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
      }
    }
    __syncthreads();  // the chunk buffer is restaged next iteration
  }
  out[static_cast<size_t>(blk) * kBlock + j] = acc;
}

}  // namespace

// vals, local_ids: (C, chunk); block_start: (n_out_blocks + 1,) int32 offsets
// of each output block's chunk run (chunk_block sorted ascending);
// out: (n_out_blocks, 128) f32.  chunk * 8 bytes must fit in 48 KiB.
extern "C" int segment_sum_chunked(const void* vals, const void* local_ids,
                                   const void* block_start, void* out,
                                   int n_out_blocks, int chunk, void* stream) {
  if (n_out_blocks > 0) {
    const size_t smem = static_cast<size_t>(chunk) * (sizeof(float) + sizeof(int));
    segment_sum_kernel<<<n_out_blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(local_ids),
        static_cast<const int*>(block_start), static_cast<float*>(out), chunk);
  }
  return cudaGetLastError();
}
