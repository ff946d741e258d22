// Attention forward on Hopper's tensor cores: out = softmax(q.k^T / sqrt(D),
// masked) . v over (B, S, H, D) bf16 tensors with equal head counts (the
// caller repeats GQA heads) and D in {64, 128}: the prefill and
// full-sequence attention of the dense models in bf16.  float32 inputs and
// D in {8, 16, 32} take the CUDA-core kernel of flash_attention.cu; the
// wrapper (kernels/flash_attention.py) chooses by dtype and head dim.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py:84, which walks a (b*h, q block,
// k block) grid with k innermost and keeps the running (acc, m, l) of one
// query block in VMEM across the sequential k steps.
//
// Bound on the H100: operations.  The serving prefill (B=4, S=2048, H=16
// after the GQA repeat, D=128) does 2*D*S*(S+1)*B*H = 68.7 GFLOP of causal
// products (>= 0.069 ms at 989 TFLOP/s bf16) over 134 MB of q, k, v and o
// (>= 0.040 ms at 3.35 TB/s).
//
// Design: one CTA per (128-row query tile, b*h), heaviest causal tiles
// first, with 288 threads: two consumer warpgroups of 64 query rows each
// and one producer warp.
//  * Loads.  One producer thread issues TMA loads: Q once, then K and V
//    tiles of 128 keys x D into a ring of kStages stages, each a full
//    barrier per tensor (transaction bytes) and an "empty" barrier that the
//    eight consumer warps arrive on when a stage has been read.  The tensor
//    maps are 4-D over (D, H, S, B) of the (B, S, H, D) tensor, so no
//    transpose is copied and rows past S are zero-filled by the hardware;
//    each box is 64 columns (128 bytes, the 128-byte swizzle span) x 128
//    rows, so D = 128 takes two boxes per tile.  cuTensorMapEncodeTiled
//    comes through cudaGetDriverEntryPoint: the library needs no -lcuda.
//  * S = Q.K^T: wgmma m64n128k16, bf16 in, f32 out, both operands K-major
//    from swizzled shared memory.
//  * Online softmax in registers on the accumulator fragment, in log2
//    units (ex2.approx.ftz): each thread holds two rows, whose max and sum
//    join across the four threads of a quad by shuffles.  Only the last key tile can hold
//    masked keys (the diagonal, or the ragged end of the keys): the mask is
//    by absolute index, qpos >= kpos, top-left aligned, so Sq != Sk works
//    both ways.  Masked p is exactly 0.
//  * P.V: p is rounded to bf16 in registers and fed as wgmma's register A
//    operand (the S accumulator's layout is A's fragment layout); V is B
//    from shared memory with the transpose bit set (MN-major), so V is
//    never transposed in memory.  The denominator l sums the f32 p, as the
//    reference's model attention does (src/repro/models/attention.py,
//    p.astype(v.dtype) before p.v).
//  * Epilogue: acc / max(l, 1e-30), rounded to bf16 to nearest even,
//    stored straight from registers.
// Keys are summed in one fixed order and no atomics are used, so repeated
// launches give the same bits.  Shared memory at D = 128: Q 32 KB plus
// 2 x (K 32 KB + V 32 KB) = 160 KB, dynamic, after cudaFuncSetAttribute.
// Left for later: ping-pong scheduling of the two consumer warpgroups,
// overlap of one tile's softmax with the next tile's Q.K^T, a TMA store of
// the output, and GQA without the caller's repeat copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;                    // query rows per CTA
constexpr int kBK = 128;                    // keys per tile
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kAtom = 64;                   // bf16 columns in one 128-byte swizzle span
constexpr int kBox = 128 * 128;             // bytes of one 128-row x 64-column box

template <int D>
struct Layout {
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kTile = kAtoms * kBox;            // one 128-row tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBars = 1 + 3 * kStages;          // q_full, k_full, v_full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024; // + slack to align to 1024
};

// 2^x on the special-function unit; subnormal results flush to 0 (p that
// small is below bf16's reach and adds nothing to l in f32 either)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D(64 x 128) f32 (+)= A(64 x 16) . B(16 x 128), A and B bf16 from shared
// memory, both K-major; scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) f32 += A(64 x 16) . B(16 x 128), A bf16 in registers (the
// accumulator layout of a previous product), B bf16 from shared memory,
// MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64) f32 += A(64 x 16) . B(16 x 64), A bf16 in registers (the
// accumulator layout of a previous product), B bf16 from shared memory,
// MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D> struct PV;
template <> struct PV<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_m64n64k16_tb(d, a, db);
  }
};
template <> struct PV<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_m64n128k16_tb(d, a, db);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int sq, int sk, int h,
                      int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int kAtoms = L::kAtoms;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base + L::kQ, k_smem = base + L::kK, v_smem = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;   // + 8 * stage

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int qt = gridDim.y - 1 - blockIdx.y;      // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one thread issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::kTile);
      for (int a = 0; a < kAtoms; ++a)
        tma_load_4d(q_smem + a * kBox, &tm_q, q_full, a * kAtom, hh, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t kd = k_smem + s * L::kTile, vd = v_smem + s * L::kTile;
        mbar_expect_tx(k_full + 8 * s, L::kTile);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(kd + a * kBox, &tm_k, k_full + 8 * s, a * kAtom, hh, kt * kBK, b);
        mbar_expect_tx(v_full + 8 * s, L::kTile);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(vd + a * kBox, &tm_v, v_full + 8 * s, a * kAtom, hh, kt * kBK, b);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows 64 wg .. 64 wg + 63 of the tile; this
  // thread holds rows r and r + 8 of them, columns 8 i + c and 8 i + c + 1
  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, c = 2 * (lane % 4);
  const int qpos0 = q0 + 64 * wg + r, qpos1 = qpos0 + 8;
  float s_acc[64];        // S, 64 x 128 keys
  float o_acc[D / 2];     // O, 64 x D
#pragma unroll
  for (int i = 0; i < 64; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = q_smem + wg * 64 * 128;   // this warpgroup's rows in each box

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const uint32_t kd = k_smem + s * L::kTile, vd = v_smem + s * L::kTile;

    mbar_wait(k_full + 8 * s, parity);
    fence_regs<64>(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns of d: box kk / 4, 32 bytes into the swizzle span
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_m64n128k16(s_acc, desc_sw128(q_wg + off, 16, 1024),
                          desc_sw128(kd + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s_acc);

    // scores in log2 units; only the last tile holds masked keys
    const bool edge = kt == n_kt - 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * i + e] * scale_log2;
        if (edge) {
          const int kpos = kt * kBK + 8 * i + c + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          if (kpos >= sk || (causal && kpos > qpos)) x = -INFINITY;
        }
        s_acc[4 * i + e] = x;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s_acc[4 * i], s_acc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s_acc[4 * i + 2], s_acc[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every row sees key 0 in the first tile, so mx0 and mx1 are finite
    const float alpha0 = exp2_ftz(m0 - mx0), alpha1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
    fence_regs<D / 2>(o_acc);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o_acc[4 * i] *= alpha0;
      o_acc[4 * i + 1] *= alpha0;
      o_acc[4 * i + 2] *= alpha1;
      o_acc[4 * i + 3] *= alpha1;
    }
    // p in f32 for the denominator, rounded to bf16 for P.V; p[4 j .. 4 j + 3]
    // is the A fragment of keys 16 j .. 16 j + 15
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p0 = exp2_ftz(s_acc[4 * i] - mx0), p1 = exp2_ftz(s_acc[4 * i + 1] - mx0);
      const float p2 = exp2_ftz(s_acc[4 * i + 2] - mx1), p3 = exp2_ftz(s_acc[4 * i + 3] - mx1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      p[2 * i] = pack_bf16(p0, p1);
      p[2 * i + 1] = pack_bf16(p2, p3);
    }

    mbar_wait(v_full + 8 * s, parity);
    fence_regs<D / 2>(o_acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)   // 16 keys: 16 rows of 128 bytes in each box
      PV<D>::mma(o_acc, &p[4 * j], desc_sw128(vd + j * 16 * 128, kBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(o_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with the stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const size_t row_stride = static_cast<size_t>(h) * D;
  if (qpos0 < sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        o + (static_cast<size_t>(b) * sq + qpos0) * row_stride + static_cast<size_t>(hh) * D + c);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[4 * i] = pack_bf16(o_acc[4 * i] / den0, o_acc[4 * i + 1] / den0);
  }
  if (qpos1 < sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        o + (static_cast<size_t>(b) * sq + qpos1) * row_stride + static_cast<size_t>(hh) * D + c);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[4 * i] = pack_bf16(o_acc[4 * i + 2] / den1, o_acc[4 * i + 3] / den1);
  }
}

// 4-D map over (D, H, S, B) of a contiguous (B, S, H, D) bf16 tensor; one box
// is 64 columns of d x 1 head x 128 rows of s x 1 batch, 128-byte swizzle
cudaError_t make_map(CUtensorMap* map, const void* ptr, int b, int s, int h, int d) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(h) * d * 2,
                                 static_cast<cuuint64_t>(s) * h * d * 2};
  const cuuint32_t box[4] = {kAtom, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
                   int sk, int h, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, b, sq, h, D)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, b, sk, h, D)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, b, sk, h, D)) != cudaSuccess) return err;
  const int smem = Layout<D>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, h, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, H, D), o: (B, Sq, H, D), bf16,
// contiguous and 16-byte aligned; D in {64, 128}; B * H and ceil(Sq / 128)
// within the grid's x and y limits (checked by the caller).
extern "C" int flash_attention_fwd_bf16_sm90(const void* q, const void* k, const void* v,
                                             void* o, int b, int sq, int sk, int h, int d,
                                             int causal, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaGetLastError();
  if (sk <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, o, b, sq, sk, h, causal, s);
    case 128: return launch<128>(q, k, v, o, b, sq, sk, h, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
