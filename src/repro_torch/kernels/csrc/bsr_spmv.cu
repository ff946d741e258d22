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
//
// Design: one CTA per row block walks that block's contiguous run of tiles
// in order (the TPU's sequential grid becomes a loop inside the block, so
// no partial sum leaves the CTA and no atomics are needed).  x[cols[t]] is
// staged in shared memory, rounded to the tile type as the reference does
// (`x.astype(a.dtype)`).  Each warp owns B/WARPS consecutive tile rows; its
// lanes read consecutive columns, so every row load is coalesced.  Each lane
// keeps one f32 partial per owned row across all tiles, Kahan-compensated
// (a long row's sum then does not drift with its length, and the extra adds
// cost no bytes); a fixed __shfl_down_sync tree reduces the lanes' partials
// at the end, so the sum is deterministic.
// Tensor cores are not used: a matrix-vector product has no MMA shape, and
// the kernel is memory-bound anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float round_like(float v);
template <> __device__ __forceinline__ float round_like<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_like<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

template <int B> struct Shape {
  static constexpr int WARPS = B < 16 ? B : 16;  // warps per CTA
  static constexpr int ROWS = B / WARPS;          // tile rows per warp
  static constexpr int COLS = (B + 31) / 32;      // tile columns per lane
};

template <typename T, int B>
__global__ void __launch_bounds__(Shape<B>::WARPS * 32)
bsr_spmv_kernel(const T* __restrict__ tiles, const int* __restrict__ row_start,
                const int* __restrict__ cols, const float* __restrict__ x,
                float* __restrict__ y) {
  constexpr int ROWS = Shape<B>::ROWS, COLS = Shape<B>::COLS;
  __shared__ float xs[B];
  const int R = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[ROWS], comp[ROWS];  // Kahan-compensated partial per owned row
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = comp[i] = 0.f;

  const int t0 = row_start[R], t1 = row_start[R + 1];
  for (int t = t0; t < t1; ++t) {
    const float* xb = x + static_cast<size_t>(cols[t]) * B;
    for (int c = threadIdx.x; c < B; c += blockDim.x) xs[c] = round_like<T>(xb[c]);
    __syncthreads();
    const T* tile = tiles + static_cast<size_t>(t) * B * B +
                    static_cast<size_t>(warp) * ROWS * B;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = lane + 32 * j;
        if (c < B) {
          const float y = to_f32(tile[i * B + c]) * xs[c] - comp[i];
          const float s = acc[i] + y;
          comp[i] = (s - acc[i]) - y;
          acc[i] = s;
        }
      }
    }
    __syncthreads();  // xs is restaged for the next tile
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) y[static_cast<size_t>(R) * B + warp * ROWS + i] = v;
  }
}

template <typename T, int B>
cudaError_t launch(const void* tiles, const void* row_start, const void* cols,
                   const void* x, void* y, int n_row_blocks, cudaStream_t stream) {
  if (n_row_blocks > 0) {
    bsr_spmv_kernel<T, B><<<n_row_blocks, Shape<B>::WARPS * 32, 0, stream>>>(
        static_cast<const T*>(tiles), static_cast<const int*>(row_start),
        static_cast<const int*>(cols), static_cast<const float*>(x),
        static_cast<float*>(y));
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* tiles, const void* row_start, const void* cols,
             const void* x, void* y, int n_row_blocks, int b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8: return launch<T, 8>(tiles, row_start, cols, x, y, n_row_blocks, s);
    case 16: return launch<T, 16>(tiles, row_start, cols, x, y, n_row_blocks, s);
    case 32: return launch<T, 32>(tiles, row_start, cols, x, y, n_row_blocks, s);
    case 64: return launch<T, 64>(tiles, row_start, cols, x, y, n_row_blocks, s);
    case 128: return launch<T, 128>(tiles, row_start, cols, x, y, n_row_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// row_start: (n_row_blocks + 1,) int32 offsets of each row block's tile run
// (rows sorted ascending); x: (n_col_blocks, b) f32; y: (n_row_blocks, b) f32.
extern "C" int bsr_spmv_f32(const void* tiles, const void* row_start, const void* cols,
                            const void* x, void* y, int n_row_blocks, int b,
                            void* stream) {
  return dispatch<float>(tiles, row_start, cols, x, y, n_row_blocks, b, stream);
}

extern "C" int bsr_spmv_bf16(const void* tiles, const void* row_start, const void* cols,
                             const void* x, void* y, int n_row_blocks, int b,
                             void* stream) {
  return dispatch<__nv_bfloat16>(tiles, row_start, cols, x, y, n_row_blocks, b, stream);
}
