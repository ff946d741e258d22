// Block-sparse SpMV, y[R] = sum over tiles t with rows[t] == R of
// tiles[t] @ x[cols[t]]: PageRank's and HITS's pull/push on the "bsr" backend.
//
// Replaces the Pallas TPU kernel `bsr_spmv` / `_bsr_spmv_kernel` in
// src/repro/kernels/bsr_spmv.py (one grid step per tile, the output block
// resident in VMEM across a row block's consecutive tiles).
//
// Bound on the H100: memory.  Every tile byte is read once and used for one
// multiply-add (B*B*4 bytes for 2*B*B flops, 0.5 flop/byte), far below the
// card's ~20 flop/byte f32 balance point.  A scale-14 graph's 9,604 tiles of
// 128x128 f32 are 0.63 GB per stream: at least ~0.19 ms at 3.35 TB/s.
// Tensor cores cannot help a matrix-vector product; what helps is keeping
// every SM busy with 16-byte loads in flight.
//
// Design: a balanced, deterministic stream, in the passes of K2
// (segment_sum.cu):
//
// Pass 0 (pieces.cuh) builds on the device, with no host sync, each row
// block's first tile (from the sorted rows) and the piece table: a row
// block's run of n tiles is cut into max(ceil(n / P), 1) pieces of at most
// P tiles.  kernels/pieces.py's `piece_table` is its plain version.
//
// Pass 1, one CTA of 256 threads per piece (the grid is the host-known
// bound nb + ceil(nnzb / P); surplus CTAs exit).  A tile is read as 16-byte
// vectors (4 f32 or 8 bf16 values): a thread owns one column vector and every
// RSTEP-th row, so for B = 128 in f32 a warp reads one 512-byte tile row
// per load instruction and each thread issues its 16 loads of a tile before
// it uses them.  Each thread reads its own x values once per tile with
// vector loads, rounded to the tile type as the reference does
// (`x.astype(a.dtype)`): no shared-memory staging and no barrier per tile.
// Tiles smaller than the CTA (B <= 32) are read several at a time, one per
// group of threads.  Each thread keeps a Kahan-compensated f32 partial per
// owned row across the piece's tiles; a fixed xor-shuffle tree joins the
// threads of a row, the groups join in order, and the piece's (B,) partial
// goes to `partial`, or straight to y when the row block has one piece.
//
// Pass 2 (pieces.cuh's piece_combine) adds a row block's piece partials in
// piece order, Kahan-compensated.  No float atomics: two launches give the
// same bits.
//
// A pass 1 that streamed each piece through a shared-memory ring filled by
// bulk copies measured no faster on the H100 (PERF.md), so loads go
// straight from global memory into registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pieces.cuh"

namespace {

constexpr int kThreads = 256;   // threads that read tiles

__device__ __forceinline__ void to_f32(const float4& v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> struct Vec;
template <> struct Vec<float> {   // 4 f32 values in one 16-byte load
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    to_f32(__ldg(reinterpret_cast<const float4*>(p)), o);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Vec<__nv_bfloat16> {   // 8 bf16 values in one 16-byte load
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(p)), o);
  }
  static __device__ __forceinline__ float round(float v) {   // to nearest even
    return __bfloat162float(__float2bfloat16(v));
  }
};

template <typename T, int B> struct Shape {
  static constexpr int VEC = Vec<T>::N;                        // values per load
  static constexpr int VPR = B / VEC;                          // loads per tile row
  static constexpr int NV = B * B / VEC;                       // loads per tile
  static constexpr int TPT = NV < kThreads ? NV : kThreads;    // threads per tile
  static constexpr int GROUPS = kThreads / TPT;                // tiles read at once
  static constexpr int ROWS = NV / TPT;                        // rows per thread
  static constexpr int RSTEP = TPT / VPR;                      // between a thread's rows
};

// the piece a CTA reads: row block R, tiles t0 .. t1 - 1, and whether R
// has more than one piece
struct Piece {
  int R, t0, t1;
  bool split;
};

__device__ __forceinline__ Piece find_piece(const int* __restrict__ row_start,
                                            const int* __restrict__ piece_off, int nb,
                                            int piece, int p) {
  const int R = piece_owner(piece_off, nb, p);
  const int k = p - __ldg(piece_off + R);
  const int t0 = __ldg(row_start + R) + k * piece;
  return {R, t0, min(__ldg(row_start + R + 1), t0 + piece),
          __ldg(piece_off + R + 1) - __ldg(piece_off + R) > 1};
}

// one tile's rows of this thread, already in registers, against its x
// values (rounded to the tile type), into the compensated row partials
template <typename T, int B>
__device__ __forceinline__ void add_tile(const float (&a)[Shape<T, B>::ROWS][Shape<T, B>::VEC],
                                         const float* __restrict__ xp, float* acc,
                                         float* comp) {
  using S = Shape<T, B>;
  float xv[S::VEC];
#pragma unroll
  for (int q = 0; q < S::VEC / 4; ++q) to_f32(__ldg(reinterpret_cast<const float4*>(xp) + q), xv + 4 * q);
#pragma unroll
  for (int e = 0; e < S::VEC; ++e) xv[e] = Vec<T>::round(xv[e]);
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) d = fmaf(a[i][e], xv[e], d);
    const float yk = d - comp[i];
    const float s = acc[i] + yk;
    comp[i] = (s - acc[i]) - yk;
    acc[i] = s;
  }
}

// the VPR threads of a row are consecutive lanes of one warp: a fixed xor
// tree joins them into rows_sum[g]
template <typename T, int B>
__device__ __forceinline__ void rows_to_shared(const float* acc, const float* comp,
                                               float (*rows_sum)[B], int g, int cv, int r0) {
  using S = Shape<T, B>;
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i) {
    float v = acc[i] - comp[i];
#pragma unroll
    for (int off = S::VPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (cv == 0) rows_sum[g][r0 + i * S::RSTEP] = v;
  }
  __syncthreads();
}

// the groups' rows joined in order, to y or to the piece's partial
template <typename T, int B>
__device__ __forceinline__ void write_piece(float (*rows_sum)[B], const Piece& pc, int p,
                                            float* __restrict__ partial, float* __restrict__ y) {
  const int tid = threadIdx.x;
  if (tid < B) {
    float s = 0.f, cs = 0.f;
#pragma unroll
    for (int q = 0; q < Shape<T, B>::GROUPS; ++q) {
      const float yk = rows_sum[q][tid] - cs;
      const float u = s + yk;
      cs = (u - s) - yk;
      s = u;
    }
    float* dst = pc.split ? partial + static_cast<size_t>(p) * B : y + static_cast<size_t>(pc.R) * B;
    dst[tid] = s;
  }
}

// pass 1: every thread loads its vectors of a tile straight from global
// memory, all of them before it uses any
template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_pieces(const T* __restrict__ tiles, const int* __restrict__ cols,
                const float* __restrict__ x, const int* __restrict__ row_start,
                const int* __restrict__ piece_off, float* __restrict__ partial,
                float* __restrict__ y, int nb, int piece) {
  using S = Shape<T, B>;
  __shared__ float rows_sum[S::GROUPS][B];
  const int p = blockIdx.x;
  if (p >= __ldg(piece_off + nb)) return;   // the grid is an upper bound
  const Piece pc = find_piece(row_start, piece_off, nb, piece, p);
  const int tid = threadIdx.x, g = tid / S::TPT, gt = tid % S::TPT;
  const int cv = gt % S::VPR;       // this thread's column vector
  const int r0 = gt / S::VPR;       // its first row; then every RSTEP rows
  float acc[S::ROWS], comp[S::ROWS];
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i) acc[i] = comp[i] = 0.f;

  for (int t = pc.t0 + g; t < pc.t1; t += S::GROUPS) {
    const T* tile = tiles + static_cast<size_t>(t) * B * B + r0 * B + cv * S::VEC;
    float a[S::ROWS][S::VEC];
#pragma unroll
    for (int i = 0; i < S::ROWS; ++i) Vec<T>::load(tile + i * S::RSTEP * B, a[i]);
    add_tile<T, B>(a, x + static_cast<size_t>(__ldg(cols + t)) * B + cv * S::VEC, acc, comp);
  }
  rows_to_shared<T, B>(acc, comp, rows_sum, g, cv, r0);
  write_piece<T, B>(rows_sum, pc, p, partial, y);
}

template <typename T, int B>
cudaError_t launch(const void* tiles, const void* rows, const void* cols, const void* x,
                   void* tables, void* partial, void* y, int nnzb, int nb, int piece,
                   int max_pieces, cudaStream_t s) {
  int* row_start = static_cast<int*>(tables);
  int* piece_off = row_start + nb + 1;
  piece_bounds<<<nnzb / 256 + 1, 256, 0, s>>>(static_cast<const int*>(rows), nnzb, nb,
                                               row_start);
  piece_plan<<<1, kPlanThreads, 0, s>>>(row_start, nb, piece, piece_off);
  const T* t = static_cast<const T*>(tiles);
  const int* c = static_cast<const int*>(cols);
  const float* xf = static_cast<const float*>(x);
  float* part = static_cast<float*>(partial);
  float* yf = static_cast<float*>(y);
  bsr_spmv_pieces<T, B><<<max_pieces, kThreads, 0, s>>>(t, c, xf, row_start, piece_off, part, yf,
                                                        nb, piece);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  piece_combine<<<nb, B, 0, s>>>(piece_off, part, yf, B);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* tiles, const void* rows, const void* cols, const void* x,
             void* tables, void* partial, void* y, int nnzb, int nb, int b, int piece,
             int max_pieces, void* stream) {
  if (nb <= 0) return cudaGetLastError();
  if (nnzb < 0 || piece <= 0 || max_pieces <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SPMV_CASE(BB) \
  case BB: return launch<T, BB>(tiles, rows, cols, x, tables, partial, y, nnzb, nb, piece, \
                                max_pieces, s);
  switch (b) {
    REPRO_SPMV_CASE(8)
    REPRO_SPMV_CASE(16)
    REPRO_SPMV_CASE(32)
    REPRO_SPMV_CASE(64)
    REPRO_SPMV_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SPMV_CASE
}

}  // namespace

// tiles: (nnzb, b, b) and x: (n_col_blocks, b) f32 (bf16 tiles in the
// _bf16 entries), both 16-byte aligned; rows: (nnzb,) int32 sorted
// ascending; cols: (nnzb,) int32; tables: (2 * (nb + 1),) int32 scratch
// that receives row_start and piece_off; partial: (max_pieces, b) f32
// scratch; y: (nb, b) f32.  max_pieces >= nb + ceil(nnzb / piece) bounds
// piece_off[nb] (the grid of pass 1).
#define REPRO_SPMV_ENTRY(NAME, T)                                                           \
  extern "C" int NAME(const void* tiles, const void* rows, const void* cols, const void* x, \
                      void* tables, void* partial, void* y, int nnzb, int n_row_blocks,     \
                      int b, int piece, int max_pieces, void* stream) {                     \
    return dispatch<T>(tiles, rows, cols, x, tables, partial, y, nnzb, n_row_blocks, b,     \
                       piece, max_pieces, stream);                                          \
  }
REPRO_SPMV_ENTRY(bsr_spmv_f32, float)
REPRO_SPMV_ENTRY(bsr_spmv_bf16, __nv_bfloat16)
