// Fused one-pass AdamW with 8-bit blockwise moments for Hopper (sm_90a).
//
// Replaces: paddle_tpu/optimizer/quant_state.py::_fused_adamw_kernel
// (pallas_call in _fused_leaf_update), run once per parameter leaf per
// training step (nlp/train.py, adamw_q_fused.apply_fused).
//
// Per 256-value block of a leaf, in place:
//   g  = grad * gscale
//   m  = b1 * (mcode * mscale) + (1 - b1) * g
//   v  = b2 * sv * sv + (1 - b2) * g * g,     sv = vcode * vscale
//   p  = p * (1 - lr * wd) - lr * (m / bc1) / (sqrt(v) / sqrt(bc2) + eps)
//   mcode = m * (448 / amax|m|),     mscale = amax|m| / 448
//   vcode = sqrt(v) * (448 / amax),  vscale = amax / 448
// with each amax floored at 1e-30: the TPU kernel's arithmetic form.
// Codes are float8 e4m3 (__nv_cvt_float_to_fp8, saturating, round to
// nearest even, as ml_dtypes rounds); scales f32; grad and params in the
// leaf's type T, bf16, f16 or f32 (adamw_q_fused_bf16, _f16, _f32: the
// TPU kernel computes in the leaf's dtype), p rounded to T once.
// The four scalars [gscale, lr, bc1, bc2] are read from a device f32[4]
// (the TPU kernel reads them from SMEM), so a step never syncs the host.
// Values past the leaf's length (its last block's padding) read as zero
// and are never written back to p; their codes stay zero.
//
// Bound on the H100: ~25 operations per parameter against 10 bytes moved
// in bf16 and f16, 16 in f32 (g and p read, p written, 2 bytes of codes
// read and written, scales): memory bound. Design: one warp per quant
// block, 8 contiguous values a lane (one 16-byte load of g and of p in
// bf16 and f16, two in f32; 8-byte loads of each code row), the block's
// two amax reductions by warp shuffles. Not done: a multi-block launch
// per step (one per leaf today) and vectorised scale loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;
constexpr int kBlock = 256;
constexpr int kWarps = 8;                 // quant blocks per CUDA block
constexpr float kF8Max = 448.f;

__device__ __forceinline__ float f8_to_float(uint8_t s) {
  const __half_raw hr =
      __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)s, __NV_E4M3);
  return __half2float(__half(hr));
}

// Eight consecutive values of a leaf of type T as f32, and back (round
// to nearest even); `p` 16-byte aligned.
template <class T>
struct Leaf;
template <>
struct Leaf<bf16> {
  static __device__ __forceinline__ void load8(const bf16* p, float f[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(h[i]);
      f[2 * i] = a.x;
      f[2 * i + 1] = a.y;
    }
  }
  static __device__ __forceinline__ void store8(bf16* p, const float f[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
  static __device__ __forceinline__ float get(bf16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ bf16 put(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Leaf<f16> {
  static __device__ __forceinline__ void load8(const f16* p, float f[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __half22float2(h[i]);
      f[2 * i] = a.x;
      f[2 * i + 1] = a.y;
    }
  }
  static __device__ __forceinline__ void store8(f16* p, const float f[8]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
  static __device__ __forceinline__ float get(f16 x) { return __half2float(x); }
  static __device__ __forceinline__ f16 put(float x) {
    return __float2half_rn(x);
  }
};
template <>
struct Leaf<float> {
  static __device__ __forceinline__ void load8(const float* p, float f[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float f[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
};

// f32 leaves keep every f32 rounding of the update, so the f32
// instantiation evaluates it as the plain version does: each operation
// in its order, rounded on its own (no contraction into FMA), and
// 1 / sqrt(bc2) as rsqrt. In bf16 and f16 the final rounding of p to the
// leaf's type absorbs those differences.
template <class T>
constexpr bool kExact = std::is_same<T, float>::value;

__device__ __forceinline__ void exact_step(
    float g, float& p, float mcode, float mscale, float vcode, float vscale,
    float gscale, float lr, float inv_bc1, float rs_bc2, float b1,
    float omb1, float b2, float omb2, float eps, float wd, float& m,
    float& sq) {
  const float gj = __fmul_rn(g, gscale);
  m = __fadd_rn(__fmul_rn(b1, __fmul_rn(mcode, mscale)),
                __fmul_rn(omb1, gj));
  const float sv = __fmul_rn(vcode, vscale);
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(b2, sv), sv),
                            __fmul_rn(__fmul_rn(omb2, gj), gj));
  sq = __fsqrt_rn(v);
  const float upd = __fdiv_rn(__fmul_rn(m, inv_bc1),
                              __fadd_rn(__fmul_rn(sq, rs_bc2), eps));
  p = __fsub_rn(__fmul_rn(p, __fsub_rn(1.f, __fmul_rn(lr, wd))),
                __fmul_rn(lr, upd));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}

template <class T>
__global__ void __launch_bounds__(kWarps * 32)
adamw_q_kernel(const T* __restrict__ g, T* __restrict__ p,
               uint8_t* __restrict__ mc, float* __restrict__ ms,
               uint8_t* __restrict__ vc, float* __restrict__ vs,
               const float* __restrict__ sc, long n, long nb, float b1,
               float omb1, float b2, float omb2, float eps, float wd) {
  const long blk = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const int lane = threadIdx.x & 31;
  const float gscale = sc[0], lr = sc[1], bc1 = sc[2], bc2 = sc[3];
  const float inv_bc1 = 1.f / bc1;
  const float rs_bc2 = kExact<T> ? rsqrtf(bc2) : 1.f / sqrtf(bc2);
  const long base = blk * kBlock + lane * 8;

  float gv[8], pv[8];
  if (base + 8 <= n) {
    Leaf<T>::load8(g + base, gv);
    Leaf<T>::load8(p + base, pv);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = base + j < n;
      gv[j] = in ? Leaf<T>::get(g[base + j]) : 0.f;
      pv[j] = in ? Leaf<T>::get(p[base + j]) : 0.f;
    }
  }
  const uint2 mu = *reinterpret_cast<const uint2*>(mc + base);
  const uint2 vu = *reinterpret_cast<const uint2*>(vc + base);
  const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mu);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vu);
  const float mscale = ms[blk], vscale = vs[blk];

  float m[8], sq[8], amax_m = 0.f, amax_v = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (kExact<T>) {
      exact_step(gv[j], pv[j], f8_to_float(mb[j]), mscale,
                 f8_to_float(vb[j]), vscale, gscale, lr, inv_bc1, rs_bc2,
                 b1, omb1, b2, omb2, eps, wd, m[j], sq[j]);
    } else {
      const float gj = gv[j] * gscale;
      m[j] = b1 * (f8_to_float(mb[j]) * mscale) + omb1 * gj;
      const float sv = f8_to_float(vb[j]) * vscale;
      const float v = b2 * sv * sv + omb2 * gj * gj;
      sq[j] = sqrtf(v);
      const float upd = (m[j] * inv_bc1) / (sq[j] * rs_bc2 + eps);
      pv[j] = pv[j] * (1.f - lr * wd) - lr * upd;
    }
    amax_m = fmaxf(amax_m, fabsf(m[j]));
    amax_v = fmaxf(amax_v, sq[j]);
  }
  amax_m = fmaxf(warp_max(amax_m), 1e-30f);
  amax_v = fmaxf(warp_max(amax_v), 1e-30f);
  // the plain version's 448 / amax is reciprocal(amax) * 448
  const float qm = kExact<T> ? __fmul_rn(__frcp_rn(amax_m), kF8Max)
                             : kF8Max / amax_m;
  const float qv = kExact<T> ? __fmul_rn(__frcp_rn(amax_v), kF8Max)
                             : kF8Max / amax_v;
  uint2 mo, vo;
  uint8_t* mob = reinterpret_cast<uint8_t*>(&mo);
  uint8_t* vob = reinterpret_cast<uint8_t*>(&vo);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mob[j] = __nv_cvt_float_to_fp8(m[j] * qm, __NV_SATFINITE, __NV_E4M3);
    vob[j] = __nv_cvt_float_to_fp8(sq[j] * qv, __NV_SATFINITE, __NV_E4M3);
  }
  *reinterpret_cast<uint2*>(mc + base) = mo;
  *reinterpret_cast<uint2*>(vc + base) = vo;
  if (lane == 0) {
    ms[blk] = amax_m * (1.f / kF8Max);
    vs[blk] = amax_v * (1.f / kF8Max);
  }
  if (base + 8 <= n) {
    Leaf<T>::store8(p + base, pv);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (base + j < n) p[base + j] = Leaf<T>::put(pv[j]);
  }
}

template <class T>
int fused(const void* g, void* p, void* mc, void* ms, void* vc, void* vs,
          const void* scalars, long n, long nb, float b1, float omb1,
          float b2, float omb2, float eps, float wd, void* stream) {
  if (nb != (n + kBlock - 1) / kBlock) return (int)cudaErrorInvalidValue;
  const long grid = (nb + kWarps - 1) / kWarps;
  adamw_q_kernel<T><<<(unsigned)grid, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<T*>(p),
      static_cast<uint8_t*>(mc), static_cast<float*>(ms),
      static_cast<uint8_t*>(vc), static_cast<float*>(vs),
      static_cast<const float*>(scalars), n, nb, b1, omb1, b2, omb2, eps,
      wd);
  return (int)cudaGetLastError();
}

}  // namespace

// n values in g and p (the entry point's type: adamw_q_fused_bf16, _f16,
// _f32); nb = ceil(n / 256) code rows (float8 e4m3, [nb, 256]) and
// scales (f32 [nb]) per moment; scalars f32[4] = [gscale, lr, bc1, bc2]
// on the device. Returns the launch's cudaError_t.
#define PTT_ADAMW_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* g, void* p, void* mc, void* ms, void* vc, \
                      void* vs, const void* scalars, long n, long nb,       \
                      float b1, float omb1, float b2, float omb2, float eps, \
                      float wd, void* stream) {                             \
    return fused<T>(g, p, mc, ms, vc, vs, scalars, n, nb, b1, omb1, b2,     \
                    omb2, eps, wd, stream);                                 \
  }
PTT_ADAMW_ENTRY(adamw_q_fused_bf16, bf16)
PTT_ADAMW_ENTRY(adamw_q_fused_f16, f16)
PTT_ADAMW_ENTRY(adamw_q_fused_f32, float)
#undef PTT_ADAMW_ENTRY
