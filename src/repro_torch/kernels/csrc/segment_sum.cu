// Chunked segment sum, out[chunk_block[c], local_ids[c, l]] += vals[c, l]
// (ids outside [0, 128) are padding and add nothing): the sum reductions of
// the engine's "pallas" backend (PageRank's pull, HITS's pull and push).
//
// Replaces the Pallas TPU kernel `segment_sum_chunked` / `_segsum_kernel` in
// src/repro/kernels/segment_sum.py:97, which turns each chunk into a one-hot
// (L x 128) matrix product on the MXU, with the owning 128-wide output block
// resident in VMEM across the block's consecutive chunks.
//
// Bound on the H100: memory.  Each slot is 8 bytes (an f32 value and an
// int32 id) read once for one add.  The scale-22 PageRank layout holds
// 136,693 chunks of 512 slots, 560 MB: at least 0.17 ms at 3.35 TB/s.
//
// Design: a balanced, deterministic warp-level reduction: two passes, after
// a pass that builds their tables.
//
// Pass 0 builds the tables on the device, with no host sync: block_start
// (each block's first chunk, from the sorted chunk_block, one thread per
// chunk boundary) and the piece table piece_off (one CTA: an exclusive scan
// of max(ceil(n_b / P), 1)), by the kernels of pieces.cuh, which K1 shares.
// kernels/pieces.py's `piece_table` is their plain version.
//
// Pass 1 splits each block's run of chunks into pieces of at most P chunks,
// so a hub block that owns thousands of chunks spreads over many CTAs
// instead of one.  One CTA of kWarps warps runs per piece; warp w takes the
// piece's chunks w, w + kWarps, ... in order.  A warp reads a 512-slot span of a chunk once, 16 consecutive slots
// per lane (four 16-byte loads each of values and ids when L % 16 == 0).
// It tests whether the span's ids are non-decreasing: each lane checks its
// own slots, a shuffle compares lane boundaries, then __all_sync.
//  * Sorted span (every span `chunk_layout` makes): each lane sums its runs
//    of equal ids; a segmented inclusive scan over lanes (__shfl_up_sync with
//    head flags) joins the runs that cross lanes; the lane holding the last
//    slot of each id's run adds that id's partial into the warp's 128-float
//    row in shared memory.  Each id of a span is added by exactly one lane.
//  * Unsorted span: each lane owns ids lane + 32 t (t < 4) and walks the
//    span's 512 slots in order through shuffles, summing its ids' values.
//    Right for any order of ids, and off the main path.
// Rows accumulate with Kahan compensation; at the end thread j sums the
// warps' rows for id j in warp order into the piece's partial, or straight
// into `out` when the block has one piece.
//
// Pass 2 (pieces.cuh's piece_combine), one thread per (block, id) of a
// block with more than one piece, sums the block's piece partials in piece
// order, Kahan-compensated.
//
// No float atomics; every sum has one order fixed by the layout and P, so
// two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pieces.cuh"

namespace {

constexpr int kBlock = 128;           // output lanes per block (the reference's DEFAULT_BLOCK)
constexpr int kWarps = 4;             // warps per CTA of pass 1
constexpr int kPerLane = 16;          // consecutive slots a lane reads
constexpr int kSpan = 32 * kPerLane;  // slots a warp reads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadId = 0x7fffffff;    // slots past the chunk's end

__device__ __forceinline__ void kahan_add(float* acc, float* comp, int id, float x) {
  const float y = x - comp[id];
  const float t = acc[id] + y;
  comp[id] = (t - acc[id]) - y;
  acc[id] = t;
}

__device__ __forceinline__ bool valid_id(int id) { return id >= 0 && id < kBlock; }

// One warp folds slots [s0, s0 + 512) of chunk `c` into its row.
__device__ __forceinline__ void warp_span(const float* __restrict__ vals,
                                          const int* __restrict__ local_ids,
                                          size_t chunk_base, int s0, int chunk,
                                          bool vec, int lane, float* acc,
                                          float* comp) {
  float v[kPerLane];
  int id[kPerLane];
  const int first = s0 + lane * kPerLane;
  if (vec) {  // chunk % 16 == 0: a lane's 16 slots lie all inside or all past the end
    if (first < chunk) {
      const float4* vp = reinterpret_cast<const float4*>(vals + chunk_base + first);
      const int4* ip = reinterpret_cast<const int4*>(local_ids + chunk_base + first);
#pragma unroll
      for (int q = 0; q < kPerLane / 4; ++q) {
        const float4 a = __ldg(vp + q);
        const int4 b = __ldg(ip + q);
        v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
        id[4 * q] = b.x; id[4 * q + 1] = b.y; id[4 * q + 2] = b.z; id[4 * q + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) { v[k] = 0.f; id[k] = kPadId; }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int s = first + k;
      const bool in = s < chunk;
      v[k] = in ? __ldg(vals + chunk_base + s) : 0.f;
      id[k] = in ? __ldg(local_ids + chunk_base + s) : kPadId;
    }
  }

  bool sorted = true;
#pragma unroll
  for (int k = 1; k < kPerLane; ++k) sorted = sorted && id[k - 1] <= id[k];
  const int head = id[0], tail = id[kPerLane - 1];
  const int prev_tail = __shfl_up_sync(kFull, tail, 1);
  if (lane > 0) sorted = sorted && prev_tail <= head;

  if (__all_sync(kFull, sorted)) {
    // runs inside the lane: the first run waits for the carry from the
    // lanes before; runs strictly inside are complete and added now
    float run = v[0], first_sum = 0.f;
    int rid = head;
    bool in_first = true;
#pragma unroll
    for (int k = 1; k < kPerLane; ++k) {
      if (id[k] == rid) {
        run += v[k];
      } else {
        if (in_first) {
          first_sum = run;
          in_first = false;
        } else if (valid_id(rid)) {
          kahan_add(acc, comp, rid, run);
        }
        rid = id[k];
        run = v[k];
      }
    }
    const bool uniform = in_first;   // one run fills the lane
    // segmented inclusive scan of the tail runs: a lane starts a segment
    // unless it is one run continuing the previous lane's tail
    float seg = run;
    int start = (lane == 0 || !uniform || prev_tail != tail) ? 1 : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float so = __shfl_up_sync(kFull, seg, off);
      const int fo = __shfl_up_sync(kFull, start, off);
      if (lane >= off) {
        if (!start) seg = so + seg;
        start |= fo;
      }
    }
    const float seg_prev = __shfl_up_sync(kFull, seg, 1);
    const int next_head = __shfl_down_sync(kFull, head, 1);
    const bool continues = lane < 31 && next_head == tail;
    if (!uniform) {
      const float carry = (lane > 0 && prev_tail == head) ? seg_prev : 0.f;
      if (valid_id(head)) kahan_add(acc, comp, head, carry + first_sum);
    }
    if (!continues && valid_id(tail)) kahan_add(acc, comp, tail, seg);
  } else {
    // any order: lane owns ids lane + 32 t and walks the slots in order
    float part[kBlock / 32];
#pragma unroll
    for (int t = 0; t < kBlock / 32; ++t) part[t] = 0.f;
    for (int src = 0; src < 32; ++src) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int i = __shfl_sync(kFull, id[k], src);
        const float x = __shfl_sync(kFull, v[k], src);
        if (valid_id(i) && (i & 31) == lane) {
#pragma unroll
          for (int t = 0; t < kBlock / 32; ++t)
            if ((i >> 5) == t) part[t] += x;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kBlock / 32; ++t) kahan_add(acc, comp, lane + 32 * t, part[t]);
  }
  __syncwarp();   // the row's next update may come from another lane
}

__global__ void __launch_bounds__(kWarps * 32)
segment_sum_pieces(const float* __restrict__ vals, const int* __restrict__ local_ids,
                   const int* __restrict__ block_start, const int* __restrict__ piece_off,
                   float* __restrict__ partial, float* __restrict__ out, int nb,
                   int chunk, int piece) {
  __shared__ float acc[kWarps][kBlock];
  __shared__ float comp[kWarps][kBlock];
  const int p = blockIdx.x;
  if (p >= __ldg(piece_off + nb)) return;   // the grid is an upper bound
  const int b = piece_owner(piece_off, nb, p);
  const int k = p - __ldg(piece_off + b);
  const int n_pieces = __ldg(piece_off + b + 1) - __ldg(piece_off + b);
  const int c0 = __ldg(block_start + b) + k * piece;
  const int c1 = min(__ldg(block_start + b + 1), c0 + piece);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int j = lane; j < kBlock; j += 32) {
    acc[warp][j] = 0.f;
    comp[warp][j] = 0.f;
  }
  __syncwarp();
  const bool vec = (chunk % kPerLane) == 0;
  for (int c = c0 + warp; c < c1; c += kWarps) {
    const size_t base = static_cast<size_t>(c) * chunk;
    for (int s0 = 0; s0 < chunk; s0 += kSpan)
      warp_span(vals, local_ids, base, s0, chunk, vec, lane, acc[warp], comp[warp]);
  }
  __syncthreads();
  if (tid < kBlock) {
    float s = 0.f, cs = 0.f;   // Kahan over the warps' rows, in warp order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float y = (acc[w][tid] - comp[w][tid]) - cs;
      const float t = s + y;
      cs = (t - s) - y;
      s = t;
    }
    float* dst = n_pieces == 1 ? out + static_cast<size_t>(b) * kBlock
                               : partial + static_cast<size_t>(p) * kBlock;
    dst[tid] = s;
  }
}

}  // namespace

// vals, local_ids: (C, chunk), 16-byte aligned; chunk_block: (C,) int32,
// sorted; tables: (2 * (nb + 1),) int32 scratch that receives block_start
// and piece_off; partial: (max_pieces, 128) f32 scratch; out: (nb, 128)
// f32.  max_pieces >= nb + ceil(C / piece) bounds piece_off[nb] (the grid
// of pass 1).
extern "C" int segment_sum_chunked(const void* vals, const void* local_ids,
                                   const void* chunk_block, void* tables,
                                   void* partial, void* out, int n_chunks,
                                   int n_out_blocks, int chunk, int piece,
                                   int max_pieces, void* stream) {
  if (n_out_blocks <= 0) return cudaGetLastError();
  if (n_chunks < 0 || chunk <= 0 || piece <= 0 || max_pieces <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* block_start = static_cast<int*>(tables);
  int* piece_off = block_start + n_out_blocks + 1;
  piece_bounds<<<n_chunks / 256 + 1, 256, 0, s>>>(
      static_cast<const int*>(chunk_block), n_chunks, n_out_blocks, block_start);
  piece_plan<<<1, kPlanThreads, 0, s>>>(block_start, n_out_blocks, piece, piece_off);
  segment_sum_pieces<<<max_pieces, kWarps * 32, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(local_ids),
      block_start, piece_off, static_cast<float*>(partial), static_cast<float*>(out),
      n_out_blocks, chunk, piece);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  piece_combine<<<n_out_blocks, kBlock, 0, s>>>(
      piece_off, static_cast<const float*>(partial), static_cast<float*>(out), kBlock);
  return cudaGetLastError();
}
