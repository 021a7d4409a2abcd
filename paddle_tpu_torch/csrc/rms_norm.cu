// RMSNorm kernels for Hopper (sm_90a): the training stack's forward
// (saving the reciprocal RMS) and backward, and the eager API's fused
// forward (row 6, at the end of this file).
//
// Replaces: paddle_tpu/kernels/rms_norm.py::_rms_fwd_kernel (pallas_call
// in _rms_fwd_pallas) and ::_rms_bwd_kernel (pallas_call in
// _rms_bwd_pallas), both run twice per decoder layer
// (nlp/llama.py::_decoder_layer).
//
//   forward:  r = 1 / sqrt(mean(x^2) + eps), out = x * r * w (bf16),
//             rstd = r (f32, one per row)
//   backward: dx = r * (w o dy) - x * (r^3 / D) * sum_j dy_j w_j x_j
//             dw = sum over rows of dy o x o r
// x, out, dy, dx bf16 [rows, D]; the forward reads w in its own dtype
// (bf16 or f32), the backward f32 [D] (the wrapper casts it); all
// arithmetic in f32, in the order of the TPU kernels.
//
// Bound on the H100: a handful of operations per element against 4 (fwd:
// x read, out written) or 6 (bwd) bytes per element, far below the card's
// ~295 flop/byte ridge: memory bound. The training steps' [40960, 2048]
// and [16384, 4096] forwards move 336 and 268 MB, 0.100 and 0.080 ms at
// 3.35 TB/s.
//
// Forward design. A row is held in registers by one warp (D <= 2048, as
// 8 bf16 16-byte vectors a lane at D 2048), two (D <= 4096) or four
// (D <= 8192), and its sum of squares reduced by warp shuffles alone; a
// row of two or four warps adds their sums through shared memory under a
// named barrier of just those warps, double-buffered by row parity, so
// no block-wide barrier is taken per row. The grid is persistent: as many
// 128-thread blocks as fit on the card at once, whose warp teams walk
// the rows with a stride, and each lane loads its weight vectors once
// (16-byte loads, bf16 or f32 as given) and keeps them in registers.
// The next row's loads are issued before the current row's reduction,
// so a row's latency hides behind the one before it.
//
// Backward design: one block of 256 threads per row, 16-byte loads and
// stores (8 bf16 a thread per vector, 1, 2 or 4 vectors a thread as D
// needs, so D <= 8192), the row's sum(dy w x) reduced over the block in
// f32. dw is reduced deterministically, without float atomics: each
// backward block walks a contiguous chunk of rows and writes its
// per-column partial sums once to an f32 [chunks, D] scratch, and a
// second kernel sums the chunks in a fixed order, so two runs give
// identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kMaxVec = 4;      // 16-byte vectors per thread: D <= 8192
// (the kernels are instantiated for VPT = 1, 2 and 4 vectors a thread)

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Sum of `v` over the block (256 threads); every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();              // red[] is free from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

// A lane's 8 weights of one 16-byte vector (bf16) or two (f32), kept in
// registers for the block's life.
template <typename WT>
struct WVec;

template <>
struct WVec<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float f[8]) const { unpack8(v, f); }
};

template <>
struct WVec<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Rows of WPR warps each (a team), VPT 16-byte vectors a lane; the grid's
// teams walk the rows with a stride. Blocks of 128 threads: at ~150
// registers a thread (the current and the next row and the weights, held
// in registers) three fit on an SM where one block of 256 would leave
// room for just one.
constexpr int kFwdThreads = 128;

template <typename WT, int WPR, int VPT>
__global__ void __launch_bounds__(kFwdThreads)
rms_fwd_kernel(const bf16* __restrict__ x, const WT* __restrict__ w,
               bf16* __restrict__ out, float* __restrict__ rstd, int rows,
               int D, float eps) {
  constexpr int kTPR = 32 * WPR;              // threads a row
  constexpr int kTeams = kFwdThreads / kTPR;     // rows a block holds
  __shared__ float red[2][kFwdThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / WPR, t = threadIdx.x % kTPR;
  const int nvec = D / 8;
  WVec<WT> wv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) wv[i].load(w + vi * 8);
  }
  const int stride = gridDim.x * kTeams;
  int row = blockIdx.x * kTeams + team;
  uint4 cur[VPT], nxt[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (row < rows && vi < nvec)
      cur[i] = reinterpret_cast<const uint4*>(x + (size_t)row * D)[vi];
  }
  for (int parity = 0; row < rows; row += stride, parity ^= 1) {
    const int next = row + stride;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = t + i * kTPR;
      if (next < rows && vi < nvec)
        nxt[i] = reinterpret_cast<const uint4*>(x + (size_t)next * D)[vi];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (t + i * kTPR < nvec) {
        float f[8];
        unpack8(cur[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (WPR > 1) {
      // the team's warps only: named barrier 1 + team over kTPR threads
      if (lane == 0) red[parity][warp] = ss;
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + team), "r"(kTPR)
                   : "memory");
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) ss += red[parity][team * WPR + i];
    }
    const float r = 1.f / sqrtf(ss / D + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = t + i * kTPR;
      if (vi < nvec) {
        float f[8], g[8], o[8];
        unpack8(cur[i], f);
        wv[i].get(g);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = f[j] * r * g[j];
        orow[vi] = pack8(o);
      }
    }
    if (t == 0) rstd[row] = r;
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

template <int VPT>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ rstd, const bf16* __restrict__ dy,
               bf16* __restrict__ dx, float* __restrict__ partials,
               int rows, int D, int rows_per_chunk) {
  __shared__ float red[kThreads / 32];
  const int nvec = D / 8;
  const int first = blockIdx.x * rows_per_chunk;
  const int last = min(rows, first + rows_per_chunk);
  float wv[VPT][8], acc[VPT][8];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = threadIdx.x + i * kThreads;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wv[i][j] = vi < nvec ? w[vi * 8 + j] : 0.f;
      acc[i][j] = 0.f;
    }
  }
  const float inv_d = 1.f / D;
  for (int row = first; row < last; ++row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + (size_t)row * D);
    float xv[VPT][8], dyv[VPT][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = threadIdx.x + i * kThreads;
      if (vi < nvec) {
        unpack8(xr[vi], xv[i]);
        unpack8(dr[vi], dyv[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += dyv[i][j] * wv[i][j] * xv[i][j];
      }
    }
    s = block_sum(s, red);
    const float r = rstd[row];
    const float c3 = r * r * r * inv_d;
    uint4* xo = reinterpret_cast<uint4*>(dx + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = threadIdx.x + i * kThreads;
      if (vi < nvec) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = r * (dyv[i][j] * wv[i][j]) - xv[i][j] * c3 * s;
          acc[i][j] += dyv[i][j] * xv[i][j] * r;
        }
        xo[vi] = pack8(o);
      }
    }
  }
  float* part = partials + (size_t)blockIdx.x * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = threadIdx.x + i * kThreads;
    if (vi < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) part[vi * 8 + j] = acc[i][j];
    }
  }
}

// dw[c] = sum over chunks of partials[chunk][c], chunks in order.
__global__ void __launch_bounds__(kThreads)
rms_dw_kernel(const float* __restrict__ partials, float* __restrict__ dw,
              int D, int chunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partials[(size_t)k * D + c];
  dw[c] = s;
}

// The persistent grid: as many blocks as fit on the card at once, asked
// of the runtime once per kernel and device.
template <typename WT, int WPR, int VPT>
cudaError_t launch_fwd(const void* x, const void* w, void* out, void* rstd,
                       int rows, int D, float eps, cudaStream_t s) {
  constexpr int kTeams = kFwdThreads / (32 * WPR);
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < 64 ? resident[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_fwd_kernel<WT, WPR, VPT>, kFwdThreads, 0);
    if (err != cudaSuccess) return err;
    full = sms * std::max(per_sm, 1);
    if (dev < 64) resident[dev] = full;
  }
  const int grid = std::max(1, std::min((rows + kTeams - 1) / kTeams, full));
  rms_fwd_kernel<WT, WPR, VPT><<<grid, kFwdThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const WT*>(w),
      static_cast<bf16*>(out), static_cast<float*>(rstd), rows, D, eps);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch_fwd(const void* x, const void* w, void* out, void* rstd,
                         int rows, int D, float eps, cudaStream_t s) {
  const int nvec = D / 8;
  if (nvec <= 32) return launch_fwd<WT, 1, 1>(x, w, out, rstd, rows, D, eps, s);
  if (nvec <= 64) return launch_fwd<WT, 1, 2>(x, w, out, rstd, rows, D, eps, s);
  if (nvec <= 128)
    return launch_fwd<WT, 1, 4>(x, w, out, rstd, rows, D, eps, s);
  if (nvec <= 256)
    return launch_fwd<WT, 1, 8>(x, w, out, rstd, rows, D, eps, s);
  if (nvec <= 512)
    return launch_fwd<WT, 2, 8>(x, w, out, rstd, rows, D, eps, s);
  return launch_fwd<WT, 4, 8>(x, w, out, rstd, rows, D, eps, s);
}

}  // namespace

// w is bf16 (w_bf16 != 0) or f32 [D], 16-byte aligned. Returns the
// launch's cudaError_t (0 on success).
extern "C" int rms_fwd_bf16(const void* x, const void* w, void* out,
                            void* rstd, int rows, int D, float eps,
                            int w_bf16, void* stream) {
  if (D % 8 || D > kThreads * kMaxVec * 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w_bf16 ? dispatch_fwd<bf16>(x, w, out, rstd, rows, D, eps, s)
                      : dispatch_fwd<float>(x, w, out, rstd, rows, D, eps, s));
}

// `partials` is an f32 [chunks, D] scratch; dw is f32 [D]. Returns the
// launches' cudaError_t (0 on success).
extern "C" int rms_bwd_bf16(const void* x, const void* w, const void* rstd,
                            const void* dy, void* dx, void* dw,
                            void* partials, int rows, int D, int chunks,
                            void* stream) {
  if (D % 8 || D > kThreads * kMaxVec * 8 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (rows + chunks - 1) / chunks;
  const int used = (rows + per - 1) / per;
  const int vpt = (D / 8 + kThreads - 1) / kThreads;
#define PTT_BWD(V)                                                         \
  rms_bwd_kernel<V><<<used, kThreads, 0, s>>>(                             \
      static_cast<const bf16*>(x), static_cast<const float*>(w),          \
      static_cast<const float*>(rstd), static_cast<const bf16*>(dy),      \
      static_cast<bf16*>(dx), static_cast<float*>(partials), rows, D, per)
  if (vpt == 1) PTT_BWD(1);
  else if (vpt == 2) PTT_BWD(2);
  else PTT_BWD(4);
#undef PTT_BWD
  rms_dw_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw), D, used);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ row 6
// The eager API's fused norm (incubate.nn.functional.fused_rms_norm, the
// FusedRMSNorm layer of a Llama built from layers).
//
// Replaces: paddle_tpu/kernels/rms_norm.py::_rms_norm_kernel (pallas_call
// in rms_norm_pallas), reached through the dispatch rms_norm().
//
//   out = x * rsqrt(mean(x^2) + eps) * w       (no statistics saved)
// x, out [rows, D] in f32 or bf16 (out in x's dtype); w f32 [D] (the
// wrapper casts it) or null (no weight); all arithmetic in f32, in the
// TPU kernel's order: (x * r) * w. Its backward is not a kernel: the
// wrapper differentiates the plain version, as the JAX package's eager
// tape differentiates rms_norm.
//
// Bound on the H100: ~4 flops per element against 8 (f32) or 4 (bf16)
// bytes: memory bound. The eager Llama's f32 [4096, 4096] reads and writes
// 64 MB each, ~0.040 ms at 3.35 TB/s. Design, the LayerNorm forward's
// (layer_norm.cu): a row of D <= 1024 is one warp's (8 rows a block of 256
// threads, the sum of squares by warp shuffles only), a wider row (up to
// 8192) one block's (8 warps, shuffles then shared memory); each row is
// read once into registers with 16-byte loads (4 f32 or 8 bf16 a vector),
// at most 32 values a thread, and written once, scaled.
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 32;       // values of a row a thread holds

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float f[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float f[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const bf16* p, float f[8]) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ __forceinline__ static void store(bf16* p, const float f[8]) {
    *reinterpret_cast<uint4*>(p) = pack8(f);
  }
};

// Sum of `v` over the 32 * WPR threads of one row; every one of them gets
// the total. WPR == 1: a warp's shuffles; WPR == kWarps: the whole block.
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  if (WPR != 1) return block_sum(v, red);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// WPR warps a row, VPT 16-byte vectors a thread.
template <typename T, int WPR, int VPT>
__global__ void __launch_bounds__(kThreads)
rms_fused_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ out, int rows, int D, float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kTPR = 32 * WPR;
  __shared__ float red[kWarps];
  const int t = threadIdx.x % kTPR;
  const size_t row = (size_t)blockIdx.x * (kThreads / kTPR)
                     + threadIdx.x / kTPR;
  if (row >= (size_t)rows) return;   // only when WPR == 1: no block barrier
  const int nvec = D / kN;
  const T* xr = x + row * D;
  float v[VPT][kN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) {
      Vec<T>::load(xr + vi * kN, v[i]);
#pragma unroll
      for (int j = 0; j < kN; ++j) ss += v[i][j] * v[i][j];
    }
  }
  const float r = rsqrtf(row_sum<WPR>(ss, red) / D + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) {
      float o[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j] = v[i][j] * r;
        if (w != nullptr) o[j] = o[j] * w[vi * kN + j];
      }
      Vec<T>::store(orow + vi * kN, o);
    }
  }
}

template <typename T>
int launch_fused(const void* x, const void* w, void* out, int rows, int D,
                 float eps, cudaStream_t s) {
  constexpr int kN = Vec<T>::kN;
  if (D % 8 || D > kThreads * kMaxPerThread || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int nvec = D / kN;
  const bool warp_row = nvec <= 32 * (kMaxPerThread / kN);   // D <= 1024
  const int tpr = warp_row ? 32 : kThreads;
  const int need = (nvec + tpr - 1) / tpr;   // at most 32 / kN
  const int vpt = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int rpb = kThreads / tpr;
  const int grid = (rows + rpb - 1) / rpb;
#define PTT_FUSED(WPR, V)                                                  \
  rms_fused_kernel<T, WPR, V><<<grid, kThreads, 0, s>>>(                   \
      static_cast<const T*>(x), static_cast<const float*>(w),             \
      static_cast<T*>(out), rows, D, eps)
#define PTT_FUSED_VPT(WPR)                                                 \
  switch (vpt) { case 1: PTT_FUSED(WPR, 1); break;                         \
                 case 2: PTT_FUSED(WPR, 2); break;                         \
                 case 4: PTT_FUSED(WPR, 4); break;                         \
                 default: PTT_FUSED(WPR, 32 / kN); }
  if (warp_row) { PTT_FUSED_VPT(1) } else { PTT_FUSED_VPT(kWarps) }
#undef PTT_FUSED_VPT
#undef PTT_FUSED
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). w is f32 [D] or
// null (no weight).
extern "C" int rms_fused_f32(const void* x, const void* w, void* out,
                             int rows, int D, float eps, void* stream) {
  return launch_fused<float>(x, w, out, rows, D, eps,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int rms_fused_bf16(const void* x, const void* w, void* out,
                              int rows, int D, float eps, void* stream) {
  return launch_fused<bf16>(x, w, out, rows, D, eps,
                            static_cast<cudaStream_t>(stream));
}
