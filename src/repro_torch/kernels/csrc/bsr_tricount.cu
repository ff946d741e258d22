// Block-sparse triangle count: sum over block triples (IJ, IK, KJ) of
// sum(A_IJ o (A_IK . A_KJ)) over 0/1 adjacency tiles, which is 6 x the
// triangle count of a symmetric simple graph.
//
// Replaces the Pallas TPU kernel `bsr_tricount` / `_tricount_kernel` in
// src/repro/kernels/bsr_tricount.py (one B x B x B MXU product per grid step,
// masked and summed into one f32 scalar resident in VMEM).
//
// Bound on the H100: operations.  Each triple is a dense 128^3 product, 2*B^3
// flops for at most 3 tiles read.  At the scale-14 undirected graph's ~0.94M
// triples that is ~3.9 TFLOP: at least ~4 ms at 989 TFLOP/s dense fp16.
//
// Design: a CTA of 8 warps takes a contiguous range of triples (consecutive
// triples share their IJ tile, so the mask stays in cache).  For each triple
// it stages 32-deep k-slabs of A_IK and A_KJ in shared memory as fp16 (0/1
// is exact in fp16) and multiplies them on the tensor cores with WMMA
// 16x16x16 fragments and f32 accumulation.  Every accumulator entry is an
// integer <= B, so it is exact.  The A_IJ mask is loaded straight into an
// accumulator-shaped fragment, so element i of the mask and of the product
// are the same matrix entry, and the masked sum needs no shared memory.
// Each thread's per-triple partial (<= 8 fragments x 8 entries x B = 8192) is
// exact in f32 and is added to a per-thread int64 total; one int64 atomicAdd
// per warp ends the kernel.  Integer atomics do not depend on order, so the
// count is exact and the same on every run.  wgmma, TMA and a shared fp16
// copy of the tiles are left to a later change.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;

template <int B>
__global__ void __launch_bounds__(kWarps * 32)
bsr_tricount_kernel(const float* __restrict__ tiles, const int* __restrict__ t_ij,
                    const int* __restrict__ t_ik, const int* __restrict__ t_kj,
                    int n_triples, unsigned long long* __restrict__ out) {
  constexpr int F = B / 16;                           // fragments per side
  constexpr int NFRAG = F * F;
  constexpr int FPW = (NFRAG + kWarps - 1) / kWarps;  // fragments per warp
  constexpr int KS = B < 32 ? B : 32;                 // k-slab depth
  constexpr int LDA = KS + 8, LDB = B + 8;            // +8 halves: skew banks
  __shared__ __align__(32) half sa[B * LDA];          // A_IK[:, k0:k0+KS]
  __shared__ __align__(32) half sb[KS * LDB];         // A_KJ[k0:k0+KS, :]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_cta = (n_triples + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per_cta;
  const int last = min(n_triples, first + per_cta);
  long long total = 0;

  for (int t = first; t < last; ++t) {
    const float* a_ij = tiles + static_cast<size_t>(t_ij[t]) * B * B;
    const float* a_ik = tiles + static_cast<size_t>(t_ik[t]) * B * B;
    const float* a_kj = tiles + static_cast<size_t>(t_kj[t]) * B * B;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
    for (int i = 0; i < FPW; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int k0 = 0; k0 < B; k0 += KS) {
      for (int e = threadIdx.x; e < B * KS; e += blockDim.x) {
        const int r = e / KS, c = e % KS;
        sa[r * LDA + c] = __float2half(a_ik[r * B + k0 + c]);
      }
      for (int e = threadIdx.x; e < KS * B; e += blockDim.x) {
        const int r = e / B, c = e % B;
        sb[r * LDB + c] = __float2half(a_kj[(k0 + r) * B + c]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
          const int f = warp + kWarps * i;
          if (f < NFRAG) {  // uniform across the warp
            wmma::fragment<wmma::matrix_a, 16, 16, 16, half, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, half, wmma::row_major> b;
            wmma::load_matrix_sync(a, sa + (f / F) * 16 * LDA + kk, LDA);
            wmma::load_matrix_sync(b, sb + kk * LDB + (f % F) * 16, LDB);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
      __syncthreads();  // the slabs are restaged for the next k0
    }

    float part = 0.f;
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int f = warp + kWarps * i;
      if (f < NFRAG) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> mask;
        wmma::load_matrix_sync(mask, a_ij + (f / F) * 16 * B + (f % F) * 16, B,
                               wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < mask.num_elements; ++e) part += acc[i].x[e] * mask.x[e];
      }
    }
    total += static_cast<long long>(part);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  if (lane == 0 && total != 0) atomicAdd(out, static_cast<unsigned long long>(total));
}

template <int B>
cudaError_t launch(const void* tiles, const void* t_ij, const void* t_ik,
                   const void* t_kj, void* out, int n_triples, cudaStream_t s) {
  if (n_triples > 0) {
    const int grid = n_triples < 4096 ? n_triples : 4096;
    bsr_tricount_kernel<B><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(t_ij),
        static_cast<const int*>(t_ik), static_cast<const int*>(t_kj), n_triples,
        static_cast<unsigned long long*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// tiles: (nnzb, b, b) f32 holding 0/1, 32-byte aligned; t_*: (n_triples,)
// int32 tile indices; out: one int64, zeroed by the caller, receives
// 6 x triangles.
extern "C" int bsr_tricount(const void* tiles, const void* t_ij, const void* t_ik,
                            const void* t_kj, void* out, int n_triples, int b,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 16: return launch<16>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 32: return launch<32>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 64: return launch<64>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 128: return launch<128>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    default: return cudaErrorInvalidValue;
  }
}
