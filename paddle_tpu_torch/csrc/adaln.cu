// Fused adaLN for Hopper (sm_90a): affine-free LayerNorm + per-sample
// modulation, forward (saving mean and reciprocal std) and backward.
//
// Replaces: paddle_tpu/kernels/adaln.py::_adaln_fwd_kernel (pallas_call in
// _adaln_fwd_pallas) and ::_adaln_bwd_kernel (pallas_call in
// _adaln_bwd_pallas), DiT's adaLN-Zero `_modulate(_ln(x), shift, scale)`.
//
//   forward:  mu = mean(x), r = 1 / sqrt(mean((x - mu)^2) + eps),
//             out = (x - mu) * r * (1 + scale[b]) + shift[b]
//             mu, rstd = r saved (f32, per token row)
//   backward: xhat = (x - mu) * r, dyw = dy * (1 + scale[b]),
//             dx = r * (dyw - mean(dyw) - xhat * mean(dyw * xhat))
//             dshift[b] = sum over the sample's tokens of dy
//             dscale[b] = sum over the sample's tokens of dy * xhat
// x, out, dy, dx [B, N, D] in the input dtype (f32 or bf16); shift and
// scale [B, D] f32 (the wrapper casts them); mu, rstd f32 [B, N];
// dshift, dscale f32 [B, D]. All arithmetic in f32, in the TPU kernels'
// order: the variance is the mean of the centred squares (two passes over
// registers), not E[x^2] - mu^2.
//
// Bound on the H100: ~10 (fwd) and ~14 (bwd) flops per element against
// 4 and 6 bytes per element in bf16, far below the card's ~295 flop/byte
// ridge: memory bound. At DiT-XL/2's [96, 256, 1152] bf16 the forward
// moves ~113 MB (x in, out written; shift/scale and the statistics are
// <1 %) and the backward ~170 MB: ~0.034 and ~0.051 ms at 3.35 TB/s.
// Design: one warp per token row, read once into registers as 4-value
// vectors (8-byte loads in bf16, 16-byte in f32): D = 1152 is 288
// vectors, 9 a lane, with no tail; other widths mask the last round. The
// shift and scale rows of the sample (a few KB, read by all its 256
// tokens) stay in L2. Both passes of the statistics and the output run
// over the registers. The backward's per-sample sums are deterministic,
// without atomics: a block of 4 warps takes a chunk of 32 tokens of one
// sample, each lane accumulates its own columns over its warp's 8 tokens
// in its warp's slice of shared memory, the block sums the 4 slices in
// order and writes its chunk's partial to an f32 scratch [B, chunks, 2,
// D]; a second kernel sums the chunks in order, so two runs give
// identical bits. Not done yet: TMA, wider loads, and fusing
// the modulation's producer (DiT's ada GEMM) or consumer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 4;                  // rows (tokens) in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                 // backward: tokens a block sums
constexpr int kMaxVpt = 12;                // 4-value vectors a lane: D <= 1536

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* p, float f[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float f[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec4<bf16> {
  __device__ __forceinline__ static void load(const bf16* p, float f[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ __forceinline__ static void store(bf16* p, const float f[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp per row of x [rows, D]; row r belongs to sample r / N
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
adaln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ shift,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ mu, float* __restrict__ rstd,
                 long rows, int N, int D, float eps) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = D >> 2;
  const long b = row / N;
  const T* xr = x + row * D;
  float v[VPT][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      Vec4<T>::load(xr + vi * 4, v[i]);
      s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    }
  }
  const float m = warp_sum(s) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][j] -= m;
        ss += v[i][j] * v[i][j];
      }
    }
  }
  const float r = rsqrtf(warp_sum(ss) / D + eps);
  const float* shr = shift + b * D;
  const float* scr = scale + b * D;
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      float sh[4], sc[4], o[4];
      Vec4<float>::load(shr + vi * 4, sh);
      Vec4<float>::load(scr + vi * 4, sc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = (v[i][j] * r) * (1.f + sc[j]) + sh[j];
      Vec4<T>::store(orow + vi * 4, o);
    }
  }
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// grid (chunks, B): block (c, b) takes tokens c * kChunk .. of sample b,
// writes their dx and its partial sums part[b, c, 0 | 1, :] (dshift,
// dscale). Shared memory: each warp's per-column partials, [kWarps, 2, D].
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
adaln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ mu, const float* __restrict__ rstd,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ part, int N, int D) {
  extern __shared__ float acc[];
  const int c = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D >> 2;
  float* psh = acc + (long)warp * 2 * D;     // this warp's dshift partial
  float* psc = psh + D;                      // and dscale partial
  for (int i = lane; i < 2 * D; i += 32) psh[i] = 0.f;
  __syncwarp();
  // from here a lane reads and writes only its own columns of the slice
  const float* scr = scale + (long)b * D;
  const int t_end = min(N, (c + 1) * kChunk);
  for (int t = c * kChunk + warp; t < t_end; t += kWarps) {
    const long row = (long)b * N + t;
    const float m = mu[row], r = rstd[row];
    const T* xr = x + row * D;
    const T* dr = dy + row * D;
    float xh[VPT][4], dyw[VPT][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float g[4], sc[4], hs[4], cs[4];
        Vec4<T>::load(xr + vi * 4, xh[i]);
        Vec4<T>::load(dr + vi * 4, g);
        Vec4<float>::load(scr + vi * 4, sc);
        Vec4<float>::load(psh + vi * 4, hs);
        Vec4<float>::load(psc + vi * 4, cs);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xh[i][j] = (xh[i][j] - m) * r;
          dyw[i][j] = g[j] * (1.f + sc[j]);
          s1 += dyw[i][j];
          s2 += dyw[i][j] * xh[i][j];
          hs[j] += g[j];
          cs[j] += g[j] * xh[i][j];
        }
        Vec4<float>::store(psh + vi * 4, hs);
        Vec4<float>::store(psc + vi * 4, cs);
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = r * (dyw[i][j] - m1 - xh[i][j] * m2);
        Vec4<T>::store(dxr + vi * 4, o);
      }
    }
  }
  __syncthreads();
  // the warps' partials summed in the order 0, 1, 2, 3
  float* dst = part + ((long)b * gridDim.x + c) * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += kThreads) {
    float v = acc[i];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += acc[(long)k * 2 * D + i];
    dst[i] = v;
  }
}

// dshift[b, d] and dscale[b, d]: the chunks' partials summed in order
__global__ void __launch_bounds__(256)
adaln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dsh,
                     float* __restrict__ dsc, int B, int chunks, int D) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long)B * D) return;
  const long b = i / D;
  const int d = (int)(i % D);
  const float* p = part + b * chunks * 2 * D + d;
  float s = 0.f, t = 0.f;
  for (int c = 0; c < chunks; ++c) {
    s += p[(long)c * 2 * D];
    t += p[(long)c * 2 * D + D];
  }
  dsh[i] = s;
  dsc[i] = t;
}

int vectors_per_lane(int D) { return (D / 4 + 31) / 32; }

}  // namespace

// x/out [B, N, D] (f32 when is_bf16 == 0, else bf16), shift/scale f32
// [B, D], mu/rstd f32 [B, N]. D % 4 == 0, D <= 1536. Returns the launch's
// cudaError_t (0 on success).
extern "C" int adaln_fwd(const void* x, const void* shift, const void* scale,
                         void* out, void* mu, void* rstd, int B, int N,
                         int D, float eps, int is_bf16, void* stream) {
  const int vpt = vectors_per_lane(D);
  if (D % 4 || vpt > kMaxVpt || N < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * N;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(shift);
  const float* sc = static_cast<const float*>(scale);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
#define PTT_FWD(T, V)                                                      \
  adaln_fwd_kernel<T, V><<<blocks, kThreads, 0, s>>>(                      \
      static_cast<const T*>(x), sh, sc, static_cast<T*>(out), m, r, rows,  \
      N, D, eps)
#define PTT_VPT(T)                                                         \
  switch (vpt) {                                                           \
    case 1: PTT_FWD(T, 1); break;  case 2: PTT_FWD(T, 2); break;           \
    case 3: PTT_FWD(T, 3); break;  case 4: PTT_FWD(T, 4); break;           \
    case 5: PTT_FWD(T, 5); break;  case 6: PTT_FWD(T, 6); break;           \
    case 7: PTT_FWD(T, 7); break;  case 8: PTT_FWD(T, 8); break;           \
    case 9: PTT_FWD(T, 9); break;  case 10: PTT_FWD(T, 10); break;         \
    case 11: PTT_FWD(T, 11); break; default: PTT_FWD(T, 12); break;        \
  }
  if (is_bf16) {
    PTT_VPT(bf16)
  } else {
    PTT_VPT(float)
  }
#undef PTT_VPT
#undef PTT_FWD
  return (int)cudaGetLastError();
}

// x/dy/dx [B, N, D] (f32 when is_bf16 == 0, else bf16), scale f32
// [B, D], mu/rstd f32 [B, N], dshift/dscale f32 [B, D], part an f32
// scratch [B, ceil(N / 32), 2, D]. Returns the launches' cudaError_t.
extern "C" int adaln_bwd(const void* x, const void* scale, const void* mu,
                         const void* rstd, const void* dy, void* dx,
                         void* dshift, void* dscale, void* part, int B,
                         int N, int D, int is_bf16, void* stream) {
  const int vpt = vectors_per_lane(D);
  if (D % 4 || vpt > kMaxVpt || N < 1) return (int)cudaErrorInvalidValue;
  if ((long)B * N == 0) return (int)cudaSuccess;
  const int chunks = (N + kChunk - 1) / kChunk;
  const dim3 grid(chunks, B);
  const int smem = kWarps * 2 * D * (int)sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  cudaError_t err = cudaSuccess;
#define PTT_BWD(T, V)                                                      \
  err = cudaFuncSetAttribute(adaln_bwd_kernel<T, V>,                       \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             smem);                                        \
  if (err != cudaSuccess) return (int)err;                                 \
  adaln_bwd_kernel<T, V><<<grid, kThreads, smem, s>>>(                     \
      static_cast<const T*>(x), sc, m, r, static_cast<const T*>(dy),       \
      static_cast<T*>(dx), p, N, D)
#define PTT_VPT(T)                                                         \
  switch (vpt) {                                                           \
    case 1: PTT_BWD(T, 1); break;  case 2: PTT_BWD(T, 2); break;           \
    case 3: PTT_BWD(T, 3); break;  case 4: PTT_BWD(T, 4); break;           \
    case 5: PTT_BWD(T, 5); break;  case 6: PTT_BWD(T, 6); break;           \
    case 7: PTT_BWD(T, 7); break;  case 8: PTT_BWD(T, 8); break;           \
    case 9: PTT_BWD(T, 9); break;  case 10: PTT_BWD(T, 10); break;         \
    case 11: PTT_BWD(T, 11); break; default: PTT_BWD(T, 12); break;        \
  }
  if (is_bf16) {
    PTT_VPT(bf16)
  } else {
    PTT_VPT(float)
  }
#undef PTT_VPT
#undef PTT_BWD
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * D;
  adaln_bwd_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      p, static_cast<float*>(dshift), static_cast<float*>(dscale), B,
      chunks, D);
  return (int)cudaGetLastError();
}
