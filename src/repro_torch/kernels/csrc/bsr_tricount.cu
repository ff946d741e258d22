// Block-sparse triangle count: sum over block triples (IJ, IK, KJ) of
// sum(A_IJ o (A_IK . A_KJ)) over 0/1 adjacency tiles, which is 6 x the
// triangle count of a symmetric simple graph.
//
// Replaces the Pallas TPU kernel `bsr_tricount` / `_tricount_kernel` in
// src/repro/kernels/bsr_tricount.py (one B x B x B MXU product per grid step,
// masked and summed into one f32 scalar resident in VMEM).
//
// Bound on the H100: operations.  Each triple is a dense B^3 product, 2*B^3
// flops.  At the scale-14 undirected graph's 941,192 triples of 128^3 that
// is ~3.9 TFLOP: at least ~4 ms at 989 TFLOP/s dense fp16.  The operands
// are 61.7 GB of tile loads (two 32 KB fp16 tiles a triple) from a 315 MB
// tile set, six times the 50 MB L2, so L2 or HBM traffic decides how close
// the kernel comes.
//
// Two variants (kernels/bsr_tricount.py chooses by tile size):
//
// "sm90_wgmma" (B in {64, 128}).  The identity
//   sum_K sum(A_IJ o (A_IK . A_KJ)) = sum(A_IJ o sum_K A_IK . A_KJ)
// lets a run of consecutive triples with the same IJ tile accumulate all its
// products in one wgmma accumulator, and mask and reduce once per run.
//  * Pass 0, one CTA: the run table.  A run starts where t_ij changes, and
//    also at every multiple of kMaxRun triples, so no accumulator entry
//    (<= run length x B) reaches 2^24 and f32 stays exact for any triple
//    list.  The run count stays in device memory: no host sync.
//    kernels/bsr_tricount.py's `run_table` is its plain version.
//  * Pass 1, a persistent grid of one CTA per SM; CTA c takes runs c,
//    c + G, ... so the CTAs in flight work on neighbouring IJ tiles (the
//    same block row I in the sorted order) and share A_IK in L2.  A CTA is
//    one producer warp and B/64 consumer warpgroups.  One producer thread
//    keeps a ring of kStages (A_IK, A_KJ) pairs in flight with TMA: a 3-D
//    tensor map over (B, B, nnzb) of the wrapper's fp16 copy of the tiles
//    (0/1 is exact in fp16), 64-column boxes with the 128-byte swizzle, so
//    B = 128 takes two boxes a tile.  Warpgroup w multiplies rows 64w..64w+63:
//    wgmma m64nBk16, B/16 k-steps a triple, A_IK as the K-major A operand
//    and A_KJ as the B operand read MN-major with the transpose bit, so no
//    tile is transposed.  A stage is released once the next triple's
//    products are issued (wgmma.wait_group 1).  At a run's end each thread
//    loads its entries of A_IJ in the accumulator's fragment layout, turns
//    each masked entry into an integer, and adds them into an int64.
//  * One int64 atomicAdd per CTA.  Integer atomics do not depend on order,
//    so the count is exact and the same on every run.
// Dynamic shared memory: kStages x 2 x B*B*2 bytes (192 KB at B = 128).
//
// "wmma" (B in {16, 32}, and at any B for comparison): the first design.  A
// CTA of 8 warps takes a contiguous range of triples; for each it stages
// 32-deep k-slabs of A_IK and A_KJ as fp16 in shared memory and multiplies
// them with WMMA 16x16x16 fragments and f32 accumulation; the A_IJ mask is
// loaded straight into an accumulator-shaped fragment and applied per
// triple; one int64 atomicAdd per warp.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "pieces.cuh"
#include "sm90.cuh"

namespace {

using namespace nvcuda;

// ---- "wmma" ----

constexpr int kWarps = 8;

template <int B>
__global__ void __launch_bounds__(kWarps * 32)
tricount_wmma_kernel(const float* __restrict__ tiles, const int* __restrict__ t_ij,
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
cudaError_t launch_wmma(const void* tiles, const void* t_ij, const void* t_ik,
                        const void* t_kj, void* out, int n_triples, cudaStream_t s) {
  if (n_triples > 0) {
    const int grid = n_triples < 4096 ? n_triples : 4096;
    tricount_wmma_kernel<B><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(t_ij),
        static_cast<const int*>(t_ik), static_cast<const int*>(t_kj), n_triples,
        static_cast<unsigned long long*>(out));
  }
  return cudaGetLastError();
}

// ---- "sm90_wgmma" ----

constexpr int kStages = 3;                  // (A_IK, A_KJ) ring depth
constexpr int kAtom = 64;                   // fp16 columns in one 128-byte swizzle span

template <int B>
struct Sm90 {
  static constexpr int kGroups = B / 64;                 // consumer warpgroups
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;       // + one producer warp
  static constexpr int kAtoms = B / kAtom;               // boxes a tile
  static constexpr int kBox = B * 128;                   // bytes of one B-row x 64-column box
  static constexpr int kTile = B * B * 2;                // bytes of one fp16 tile
  static constexpr int kA = 0;                           // A_IK ring
  static constexpr int kB = kStages * kTile;             // A_KJ ring
  static constexpr int kBar = 2 * kStages * kTile;       // full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 16 * kStages + 1024;   // + slack to align to 1024
  static constexpr int kMaxRun = ((1 << 24) - 1) / B;    // keeps every entry below 2^24
};

// D(64 x 128) f32 += A(64 x 16) . B(16 x 128), fp16 from shared memory: A
// K-major, B MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_f16_m64n128k16_tb(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64) f32 += A(64 x 16) . B(16 x 64), fp16 from shared memory: A
// K-major, B MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_f16_m64n64k16_tb(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int B> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db) {
    wgmma_f16_m64n64k16_tb(d, da, db);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db) {
    wgmma_f16_m64n128k16_tb(d, da, db);
  }
};

// runs[0] = the number of runs R; runs[1 + r] = the first triple of run r,
// runs[1 + R] = n.  A run starts at i == 0, where t_ij[i] != t_ij[i - 1],
// and at every multiple of max_run.  One CTA: each thread counts the starts
// in a contiguous range of triples, a block-wide scan places them.
__global__ void __launch_bounds__(kPlanThreads)
tricount_runs(const int* __restrict__ t_ij, int n, int max_run, int* __restrict__ runs) {
  const int tid = threadIdx.x;
  const int per = (n + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int local = 0;
  int prev = lo > 0 ? __ldg(t_ij + lo - 1) : 0;
  for (int i = lo; i < hi; ++i) {
    const int cur = __ldg(t_ij + i);
    local += (i == 0 || i % max_run == 0 || cur != prev) ? 1 : 0;
    prev = cur;
  }
  int total;
  int at = block_exclusive_scan(local, &total);
  prev = lo > 0 ? __ldg(t_ij + lo - 1) : 0;
  for (int i = lo; i < hi; ++i) {
    const int cur = __ldg(t_ij + i);
    if (i == 0 || i % max_run == 0 || cur != prev) runs[1 + at++] = i;
    prev = cur;
  }
  if (tid == kPlanThreads - 1) {
    runs[0] = total;
    runs[1 + total] = n;
  }
}

template <int B>
__global__ void __launch_bounds__(Sm90<B>::kThreads, 1)
tricount_sm90_kernel(const __grid_constant__ CUtensorMap tm, const __half* __restrict__ tiles,
                     const int* __restrict__ t_ij, const int* __restrict__ t_ik,
                     const int* __restrict__ t_kj, const int* __restrict__ runs,
                     unsigned long long* __restrict__ out) {
  using L = Sm90<B>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ long long warp_total[L::kThreads / 32];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_smem = base + L::kA, b_smem = base + L::kB;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages;   // + 8 * stage
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_runs = __ldg(runs);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, L::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  long long total = 0;
  if (tid >= L::kConsumers) {   // the producer warp: one thread issues every load
    if (tid == L::kConsumers) {
      int it = 0;
      for (int r = blockIdx.x; r < n_runs; r += gridDim.x) {
        const int t1 = __ldg(runs + 2 + r);
        for (int t = __ldg(runs + 1 + r); t < t1; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
          const int ik = __ldg(t_ik + t), kj = __ldg(t_kj + t);
          mbar_expect_tx(full + 8 * s, 2 * L::kTile);
          for (int a = 0; a < L::kAtoms; ++a) {
            tma_load_3d(a_smem + s * L::kTile + a * L::kBox, &tm, full + 8 * s, a * kAtom, 0, ik);
            tma_load_3d(b_smem + s * L::kTile + a * L::kBox, &tm, full + 8 * s, a * kAtom, 0, kj);
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the product; this
    // thread holds rows r and r + 8 of them, columns 8 i + c and 8 i + c + 1
    const int wg = tid / 128, t = tid % 128;
    const int r = 64 * wg + 16 * (t / 32) + lane / 4, c = 2 * (lane % 4);
    float acc[B / 2];
    int it = 0;
    for (int run = blockIdx.x; run < n_runs; run += gridDim.x) {
      const int t0 = __ldg(runs + 1 + run), t1 = __ldg(runs + 2 + run);
#pragma unroll
      for (int i = 0; i < B / 2; ++i) acc[i] = 0.f;
      fence_regs<B / 2>(acc);
      int held = -1;   // the stage the previous triple's products still read
      for (int tr = t0; tr < t1; ++tr, ++it) {
        const int s = it % kStages;
        mbar_wait(full + 8 * s, (it / kStages) & 1);
        wgmma_fence();
        const uint32_t a_st = a_smem + s * L::kTile + wg * 64 * 128;
        const uint32_t b_st = b_smem + s * L::kTile;
#pragma unroll
        for (int kk = 0; kk < B / 16; ++kk) {
          // A: 16 columns of k, box kk / 4, 32 bytes into the swizzle span;
          // B: 16 rows of k, 128 bytes each, in every box along n
          const uint64_t da = desc_sw128(a_st + (kk / 4) * L::kBox + (kk % 4) * 32, 16, 1024);
          const uint64_t db = desc_sw128(b_st + kk * 16 * 128, L::kBox, 1024);
          Mma<B>::run(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * held);   // this warp is done with it
        }
        held = s;
      }
      wgmma_wait<0>();
      fence_regs<B / 2>(acc);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * held);
      }
      // the mask A_IJ in the accumulator's layout; every entry is an integer
      // below 2^24, so each product converts exactly
      const __half* m = tiles + static_cast<size_t>(__ldg(t_ij + t0)) * B * B;
      int part = 0;   // at most B/2 entries of at most 2^24 - 1
#pragma unroll
      for (int i = 0; i < B / 8; ++i) {
        const __half2 m0 = *reinterpret_cast<const __half2*>(m + r * B + 8 * i + c);
        const __half2 m1 = *reinterpret_cast<const __half2*>(m + (r + 8) * B + 8 * i + c);
        part += __float2int_rn(acc[4 * i] * __low2float(m0)) +
                __float2int_rn(acc[4 * i + 1] * __high2float(m0)) +
                __float2int_rn(acc[4 * i + 2] * __low2float(m1)) +
                __float2int_rn(acc[4 * i + 3] * __high2float(m1));
      }
      total += part;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  if (lane == 0) warp_total[tid / 32] = total;
  __syncthreads();
  if (tid == 0) {
    long long sum = 0;
    for (int w = 0; w < L::kThreads / 32; ++w) sum += warp_total[w];
    if (sum != 0) atomicAdd(out, static_cast<unsigned long long>(sum));
  }
}

// 3-D map over (B, B, nnzb) of contiguous (nnzb, B, B) fp16 tiles; one box
// is 64 columns x B rows x 1 tile, 128-byte swizzle
cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, int nnzb, int b) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(b), static_cast<cuuint64_t>(b),
                              static_cast<cuuint64_t>(nnzb)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(b) * 2,
                                 static_cast<cuuint64_t>(b) * b * 2};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(b), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int B>
cudaError_t launch_sm90(const void* tiles, const void* t_ij, const void* t_ik, const void* t_kj,
                        void* runs, void* out, int n_triples, int nnzb, cudaStream_t s) {
  using L = Sm90<B>;
  CUtensorMap tm;
  cudaError_t err = make_tile_map(&tm, tiles, nnzb, B);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(tricount_sm90_kernel<B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  tricount_runs<<<1, kPlanThreads, 0, s>>>(static_cast<const int*>(t_ij), n_triples,
                                           L::kMaxRun, static_cast<int*>(runs));
  tricount_sm90_kernel<B><<<sms, L::kThreads, L::kBytes, s>>>(
      tm, static_cast<const __half*>(tiles), static_cast<const int*>(t_ij),
      static_cast<const int*>(t_ik), static_cast<const int*>(t_kj),
      static_cast<const int*>(runs), static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

}  // namespace

// tiles: (nnzb, b, b) f32 holding 0/1, 32-byte aligned; t_*: (n_triples,)
// int32 tile indices; out: one int64, zeroed by the caller, receives
// 6 x triangles.
extern "C" int bsr_tricount_wmma(const void* tiles, const void* t_ij, const void* t_ik,
                                 const void* t_kj, void* out, int n_triples, int b,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 16: return launch_wmma<16>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 32: return launch_wmma<32>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 64: return launch_wmma<64>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    case 128: return launch_wmma<128>(tiles, t_ij, t_ik, t_kj, out, n_triples, s);
    default: return cudaErrorInvalidValue;
  }
}

// tiles: (nnzb, b, b) fp16 holding 0/1, contiguous, 16-byte aligned; t_*:
// (n_triples,) int32 tile indices; runs: (n_triples + 2,) int32 scratch
// that receives the run table; out: one int64, zeroed by the caller,
// receives 6 x triangles.
extern "C" int bsr_tricount_sm90(const void* tiles, const void* t_ij, const void* t_ik,
                                 const void* t_kj, void* runs, void* out, int n_triples,
                                 int nnzb, int b, void* stream) {
  if (n_triples <= 0) return cudaGetLastError();
  if (nnzb <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 64: return launch_sm90<64>(tiles, t_ij, t_ik, t_kj, runs, out, n_triples, nnzb, s);
    case 128: return launch_sm90<128>(tiles, t_ij, t_ik, t_kj, runs, out, n_triples, nnzb, s);
    default: return cudaErrorInvalidValue;
  }
}
