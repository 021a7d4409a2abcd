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
// nearest even, as ml_dtypes rounds); grad and params bf16, scales f32.
// The four scalars [gscale, lr, bc1, bc2] are read from a device f32[4]
// (the TPU kernel reads them from SMEM), so a step never syncs the host.
// Values past the leaf's length (its last block's padding) read as zero
// and are never written back to p; their codes stay zero.
//
// Bound on the H100: ~25 operations per parameter against 10 bytes moved
// (g and p read, p written, 2 bytes of codes read and written, scales):
// memory bound. Design: one warp per quant block, 8 contiguous values a
// lane (16-byte loads of g and p, 8-byte loads of each code row), the
// block's two amax reductions by warp shuffles. Not done: a multi-block
// launch per step (one per leaf today) and vectorised scale loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kBlock = 256;
constexpr int kWarps = 8;                 // quant blocks per CUDA block
constexpr float kF8Max = 448.f;

__device__ __forceinline__ float f8_to_float(uint8_t s) {
  const __half_raw hr =
      __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)s, __NV_E4M3);
  return __half2float(__half(hr));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
adamw_q_kernel(const bf16* __restrict__ g, bf16* __restrict__ p,
               uint8_t* __restrict__ mc, float* __restrict__ ms,
               uint8_t* __restrict__ vc, float* __restrict__ vs,
               const float* __restrict__ sc, long n, long nb, float b1,
               float omb1, float b2, float omb2, float eps, float wd) {
  const long blk = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const int lane = threadIdx.x & 31;
  const float gscale = sc[0], lr = sc[1], bc1 = sc[2], bc2 = sc[3];
  const float inv_bc1 = 1.f / bc1;
  const float rs_bc2 = 1.f / sqrtf(bc2);
  const long base = blk * kBlock + lane * 8;

  float gv[8], pv[8];
  if (base + 8 <= n) {
    const uint4 gu = *reinterpret_cast<const uint4*>(g + base);
    const uint4 pu = *reinterpret_cast<const uint4*>(p + base);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gu);
    const __nv_bfloat162* ph = reinterpret_cast<const __nv_bfloat162*>(&pu);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(gh[i]);
      const float2 b = __bfloat1622float2(ph[i]);
      gv[2 * i] = a.x;
      gv[2 * i + 1] = a.y;
      pv[2 * i] = b.x;
      pv[2 * i + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = base + j < n;
      gv[j] = in ? __bfloat162float(g[base + j]) : 0.f;
      pv[j] = in ? __bfloat162float(p[base + j]) : 0.f;
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
    const float gj = gv[j] * gscale;
    m[j] = b1 * (f8_to_float(mb[j]) * mscale) + omb1 * gj;
    const float sv = f8_to_float(vb[j]) * vscale;
    const float v = b2 * sv * sv + omb2 * gj * gj;
    sq[j] = sqrtf(v);
    const float upd = (m[j] * inv_bc1) / (sq[j] * rs_bc2 + eps);
    pv[j] = pv[j] * (1.f - lr * wd) - lr * upd;
    amax_m = fmaxf(amax_m, fabsf(m[j]));
    amax_v = fmaxf(amax_v, sq[j]);
  }
  amax_m = fmaxf(warp_max(amax_m), 1e-30f);
  amax_v = fmaxf(warp_max(amax_v), 1e-30f);
  const float qm = kF8Max / amax_m, qv = kF8Max / amax_v;
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
    uint4 pu;
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&pu);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ph[i] = __floats2bfloat162_rn(pv[2 * i], pv[2 * i + 1]);
    *reinterpret_cast<uint4*>(p + base) = pu;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (base + j < n) p[base + j] = __float2bfloat16_rn(pv[j]);
  }
}

}  // namespace

// n values in g and p (bf16); nb = ceil(n / 256) code rows (float8 e4m3,
// [nb, 256]) and scales (f32 [nb]) per moment; scalars f32[4] =
// [gscale, lr, bc1, bc2] on the device. Returns the launch's cudaError_t.
extern "C" int adamw_q_fused_bf16(const void* g, void* p, void* mc, void* ms,
                                  void* vc, void* vs, const void* scalars,
                                  long n, long nb, float b1, float omb1,
                                  float b2, float omb2, float eps, float wd,
                                  void* stream) {
  if (nb != (n + kBlock - 1) / kBlock) return (int)cudaErrorInvalidValue;
  const long grid = (nb + kWarps - 1) / kWarps;
  adamw_q_kernel<<<(unsigned)grid, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<bf16*>(p),
      static_cast<uint8_t*>(mc), static_cast<float*>(ms),
      static_cast<uint8_t*>(vc), static_cast<float*>(vs),
      static_cast<const float*>(scalars), n, nb, b1, omb1, b2, omb2, eps,
      wd);
  return (int)cudaGetLastError();
}
