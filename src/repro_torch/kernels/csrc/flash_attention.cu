// Attention forward, out = softmax(q.k^T / sqrt(D), masked) . v, over
// (B, S, H, D) tensors with equal head counts (the caller repeats GQA
// heads): the prefill and full-sequence attention of the dense model.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py:84, which walks a (b*h, q block,
// k block) grid with k innermost and keeps the running (acc, m, l) of one
// query block in VMEM across the sequential k steps.
//
// Semantics kept from that kernel: the causal mask is qpos >= kpos by
// absolute index (top-left aligned); every product, the running max, the
// denominator and p.v accumulate in float32 (p is never rounded to the
// input type); the result is acc / max(l, 1e-30), rounded to the input type
// to nearest even.  Masked scores contribute exactly 0, as exp(-1e30 - m)
// does there: each query row sees key 0 in its first key tile, so its
// running max is finite from then on.
//
// Bound on the H100: operations.  The prefill of the serving path (B=4,
// S=2048, H=16 after the GQA repeat, D=128, bf16) does 2*D*S*(S+1)*B*H =
// 68.7 GFLOP of causal products (>= 0.069 ms at 989 TFLOP/s bf16) over
// 134 MB of q, k, v and o (>= 0.040 ms at 3.35 TB/s).
//
// Design (simple and right first): one CTA per (query tile of kBQ = 64
// rows, b*h), heaviest causal tiles first.  G threads share one query row,
// each holding D/G of its q and of its running acc in registers; a score is
// G partial dot products summed by xor-shuffles, so every thread of the
// group holds the same score, max and denominator.  A loop over key tiles
// of kBK = 32 rows stops at the diagonal when causal (the Pallas `pl.when`
// tile skip, as a shorter loop); each K and V tile is staged once in shared
// memory as float32 (2 * 32 * D * 4 bytes = 32 KB at D = 128, inside the
// 48 KB a CTA gets without opting in, so no cudaFuncSetAttribute), and read
// back as float4 broadcasts.  The online softmax rescales acc once per key
// tile.  Products run on the CUDA cores in float32, as the TPU kernel
// upcasts to f32; expf stays accurate (no --use_fast_math).  Keys are
// summed in one fixed order and no atomics are used, so the result is
// deterministic.  The kernel indexes the (B, S, H, D) layout directly: no
// transpose is copied.  Sequence lengths need not be multiples of a tile;
// ragged rows and keys are masked.
//
// What a later change does about the bound: bf16 tiles through `wgmma`
// from TMA-fed shared memory, in a warp-specialised pipeline (producer warp
// plus consumer warpgroups); p then rounds to bf16 before p.v, which is
// what the JAX model's own attention (models/attention.py) does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 32;              // key rows per shared-memory tile
constexpr float kNegInf = -1e30f;    // the reference's mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// D: head dim; G: threads per query row.  Thread t of a row's group owns
// the float4 columns c * G + t, c < D / (4 G), of q, acc and each k/v row.
template <int D, int G, typename T>
__global__ void __launch_bounds__(kBQ * G)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int h, int causal, float scale) {
  constexpr int kNT = kBQ * G;         // threads per CTA
  constexpr int kC4 = D / 4;           // float4 columns of a row
  constexpr int kV4 = kC4 / G;         // float4 columns a thread owns
  static_assert(kV4 * G == kC4, "G must divide D / 4");
  __shared__ float4 ks[kBK][kC4];
  __shared__ float4 vs[kBK][kC4];

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int t = tid % G;
  const int qi = qt * kBQ + tid / G;
  const bool q_ok = qi < sq;
  const size_t row_stride = static_cast<size_t>(h) * D;   // one s step

  float4 qr[kV4], acc[kV4];
  const T* qrow = q + (static_cast<size_t>(b) * sq + qi) * row_stride +
                  static_cast<size_t>(hh) * D;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
    qr[c] = q_ok ? load4(qrow + 4 * (c * G + t)) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // keys this tile's rows can see: up to its last row when causal
  const int k_end = causal ? min(sk, (qt + 1) * kBQ) : sk;
  const T* kbase = k + static_cast<size_t>(b) * sk * row_stride +
                   static_cast<size_t>(hh) * D;
  const T* vbase = v + static_cast<size_t>(b) * sk * row_stride +
                   static_cast<size_t>(hh) * D;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile has been consumed
    for (int i = tid; i < kBK * kC4; i += kNT) {
      const int r = i / kC4, c = i % kC4;
      const int j = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < sk) {
        kv = load4(kbase + j * row_stride + 4 * c);
        vv = load4(vbase + j * row_stride + 4 * c);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int r = 0; r < kBK; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 kk = ks[r][c * G + t];
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int j = k0 + r;
      const bool ok = j < k_end && (!causal || j <= qi);
      s[r] = ok ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[r]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kV4; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll
    for (int r = 0; r < kBK; ++r) {
      const int j = k0 + r;
      const bool ok = j < k_end && (!causal || j <= qi);
      const float p = ok ? expf(s[r] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 vv = vs[r][c * G + t];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (q_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * sq + qi) * row_stride +
              static_cast<size_t>(hh) * D;
#pragma unroll
    for (int c = 0; c < kV4; ++c) {
      store4(orow + 4 * (c * G + t),
             make_float4(acc[c].x / den, acc[c].y / den, acc[c].z / den,
                         acc[c].w / den));
    }
  }
}

template <int D, int G, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int h, int causal, cudaStream_t stream) {
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd_kernel<D, G, T><<<grid, kBQ * G, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int d, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaGetLastError();
  if (sk <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8, 2, T>(q, k, v, o, b, sq, sk, h, causal, s);
    case 16: return launch<16, 4, T>(q, k, v, o, b, sq, sk, h, causal, s);
    case 32: return launch<32, 4, T>(q, k, v, o, b, sq, sk, h, causal, s);
    case 64: return launch<64, 4, T>(q, k, v, o, b, sq, sk, h, causal, s);
    case 128: return launch<128, 4, T>(q, k, v, o, b, sq, sk, h, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, H, D), o: (B, Sq, H, D), all
// contiguous and 16-byte aligned; D in {8, 16, 32, 64, 128}; B * H and
// ceil(Sq / 64) within the grid's x and y limits (checked by the caller).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, int b, int sq,
                                       int sk, int h, int d, int causal,
                                       void* stream) {
  return dispatch<float>(q, k, v, o, b, sq, sk, h, d, causal, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int b, int sq,
                                        int sk, int h, int d, int causal,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, d, causal, stream);
}
