// LayerNorm forward (saving mean and reciprocal std) and backward for
// Hopper (sm_90a): the fused-backward norm of the eager API's fused layers
// (incubate.nn.functional.fused_layer_norm).
//
// Replaces: paddle_tpu/kernels/layer_norm.py::_ln_fwd_kernel (pallas_call
// in _ln_fwd_pallas) and ::_ln_bwd_kernel (pallas_call in _ln_bwd_pallas).
//
//   forward:  mu = mean(x), r = 1 / sqrt(mean((x - mu)^2) + eps),
//             out = (x - mu) * r * w + b; mu, rstd = r saved (f32, per row)
//   backward: xhat = (x - mu) * r, dyw = dy * w,
//             dx = r * (dyw - mean(dyw) - xhat * mean(dyw * xhat))
//             dw = sum over rows of dy * xhat, db = sum over rows of dy
// x, out, dy, dx in the input dtype (f32, bf16 or f16: ln_*_f32, _bf16
// and _f16, one template each, as the TPU kernels compute in their input's
// dtype) [rows, D]; w, b f32 [D] (the wrapper casts them; with f16 x an
// f16 pair is read as it is, the O2 form, so no cast runs around the
// call), or null for the affine-free form (w = 1, b = 0);
// all arithmetic in f32, in the order of the TPU kernels: the variance is
// the two-pass mean of the centred squares, as the TPU kernel's
// mean(xc * xc), not Welford and not E[x^2] - mu^2.
//
// Bound on the H100: ~8 (fwd) and ~13 (bwd) flops per element against 8
// and 12 bytes per element in f32 (4 and 6 in bf16), far below the card's
// ~295 flop/byte ridge: memory bound. At the eager ERNIE step's f32
// [32768, 768] the forward moves ~201 MB and the backward ~302 MB, 0.060
// and 0.090 ms at 3.35 TB/s.
//
// Forward design: each row is read once into registers with 16-byte
// vector loads (4 f32 or 8 bf16 a vector) and both passes (the mean, then
// the centred variance) run over the registers. A row of D <= 1024 is one
// warp's (8 rows a block of 256 threads, reductions by warp shuffles
// only); a wider row (D <= 8192) is one block's (8 warps, shuffles then
// shared memory). Each thread holds at most 32 values of a row.
//
// Backward design: the walk of norm_bwd_core.cuh (a persistent grid of
// warp teams, 1 warp a row up to D 1024, 2, 4 or 8 up to 8192, each lane
// holding at most 32 values of a row; x, dy, mu and rstd two rows ahead in
// a cp.async ring; the row's sum(dyw) and sum(dyw xhat) by shuffles and
// the team's named barrier), the weight loaded once per lane; each block
// writes one f32 partial row of dw and one of db (its teams added in
// order), and ln_dwdb_kernel folds them in a fixed order. What held the
// previous design back (warp rows walking 32-row chunks; H100 SXM at 700
// W, one CUDA graph: 0.213 ms at f32 [32768, 768], 42 % of the bound): each
// row's x and dy loaded synchronously with no prefetch, the weight re-read
// from device memory per element and row, 8 barrier rounds to add a
// block's row groups, and a 6-block fold at D 768 whose threads each
// summed 1024 chunks in one chain: 0.057 ms alone, a quarter of the call.
// This design: 0.116 ms, 78 % of the bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "norm_bwd_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 32;        // values of a row a thread holds

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
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __bfloat1622float2(h[i]);
      f[2 * i] = q.x;
      f[2 * i + 1] = q.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float f[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<__half> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __half* p, float f[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 q = __half22float2(h[i]);
      f[2 * i] = q.x;
      f[2 * i + 1] = q.y;
    }
  }
  __device__ __forceinline__ static void store(__half* p, const float f[8]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// one weight or bias value as f32, read in its own dtype
__device__ __forceinline__ float wval(float w) { return w; }
__device__ __forceinline__ float wval(__half w) { return __half2float(w); }

// Sum of `v` over the 32 * WPR threads of one row; every one of them gets
// the total. WPR == 1: a warp's shuffles. WPR == kWarps: the whole block
// (one row a block), through shared memory `red`.
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (WPR == 1) return v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();              // red[] is free from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// WPR warps a row, VPT 16-byte vectors a thread; w and b of WT (f32, or
// f16 with f16 x).
template <typename T, typename WT, int WPR, int VPT>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
              const WT* __restrict__ b, T* __restrict__ out,
              float* __restrict__ mu, float* __restrict__ rstd, int rows,
              int D, float eps) {
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
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) {
      Vec<T>::load(xr + vi * kN, v[i]);
#pragma unroll
      for (int j = 0; j < kN; ++j) s += v[i][j];
    }
  }
  const float m = row_sum<WPR>(s, red) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        v[i][j] -= m;
        ss += v[i][j] * v[i][j];
      }
    }
  }
  const float r = 1.f / sqrtf(row_sum<WPR>(ss, red) / D + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * kTPR;
    if (vi < nvec) {
      float o[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j] = v[i][j] * r;
        if (w != nullptr)
          o[j] = o[j] * wval(w[vi * kN + j]) + wval(b[vi * kN + j]);
      }
      Vec<T>::store(orow + vi * kN, o);
    }
  }
  if (t == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// The backward's walk: WPR warps a row, VPT vectors a lane, the weight's
// values of the lane's vectors held in registers (1 when affine-free: dy
// times 1 is dy, bit for bit); the weight of WT (f32, or f16 with f16 x).
template <typename T, typename WT, int WPR, int VPT>
__global__ void __launch_bounds__(nbw::kThreads)
ln_bwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ partials, int rows, int D, int n_teams) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kTPR = 32 * WPR;
  const int t = threadIdx.x % kTPR, nvec = D / kN;
  float wv[VPT][kN], acc[2][VPT][kN];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = t + i * kTPR;
    if (w != nullptr && v < nvec) {
      if constexpr (std::is_same<WT, float>::value) {
        Vec<float>::load(w + v * kN, wv[i]);
        if constexpr (kN == 8) Vec<float>::load(w + v * kN + 4, wv[i] + 4);
      } else {
        Vec<WT>::load(w + v * kN, wv[i]);   // 8 f16 weights, kN == 8
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) wv[i][j] = 1.f;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[0][i][j] = acc[1][i][j] = 0.f;
  }
  const float* const stat[2] = {mu, rstd};
  nbw::walk<T, WPR, VPT, 2, 2, 2>(
      x, dy, dx, stat, partials, rows, D, n_teams, acc,
      [&](int i, const float (&st)[2], const float (&xv)[kN],
          const float (&dv)[kN], float (&s)[2]) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float xh = (xv[j] - st[0]) * st[1];
          const float dyw = dv[j] * wv[i][j];
          s[0] += dyw;
          s[1] += dyw * xh;
          acc[0][i][j] += dv[j] * xh;
          acc[1][i][j] += dv[j];
        }
      },
      [&](int i, const float (&st)[2], const float (&s)[2],
          const float (&xv)[kN], const float (&dv)[kN], float (&o)[kN]) {
        const float m1 = s[0] / D, m2 = s[1] / D;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float xh = (xv[j] - st[0]) * st[1];
          o[j] = st[1] * (dv[j] * wv[i][j] - m1 - xh * m2);
        }
      });
}

// dw[c] and db[c]: the partial rows' columns c and D + c, folded in the
// plan's fixed order.
__global__ void __launch_bounds__(nbw::kFoldThreads)
ln_dwdb_kernel(const float* __restrict__ partials, float* __restrict__ dw,
               float* __restrict__ db, int n_parts, int D, int cols) {
  nbw::fold(partials, n_parts, 2 * D, cols, [&](int c, float v) {
    if (c < D) dw[c] = v;
    else db[c - D] = v;
  });
}

// Vectors a thread holds: the smallest instantiated count that covers
// `need`, among 1, 2, 4, 6 and 8 (bf16: 1, 2, 3 and 4), so that a thread
// holds at most kMaxPerThread values; 0 when none does.
template <typename T>
int pick_vpt(int need) {
  const int opts_f32[] = {1, 2, 4, 6, 8};
  const int opts_bf16[] = {1, 2, 3, 4};
  const bool f32 = Vec<T>::kN == 4;
  const int* opts = f32 ? opts_f32 : opts_bf16;
  const int n = f32 ? 5 : 4;
  for (int i = 0; i < n; ++i)
    if (opts[i] >= need) return opts[i];
  return 0;
}

#define PTT_VPT_F32(M, WPR) \
  switch (vpt) { case 1: M(WPR, 1); break; case 2: M(WPR, 2); break;     \
                 case 4: M(WPR, 4); break; case 6: M(WPR, 6); break;     \
                 default: M(WPR, 8); }
#define PTT_VPT_BF16(M, WPR) \
  switch (vpt) { case 1: M(WPR, 1); break; case 2: M(WPR, 2); break;     \
                 case 3: M(WPR, 3); break; default: M(WPR, 4); }

template <typename T, typename WT = float>
int launch_fwd(const void* x, const void* w, const void* b, void* out,
               void* mu, void* rstd, int rows, int D, float eps,
               cudaStream_t s) {
  constexpr int kN = Vec<T>::kN;
  if (D % 8 || D > kThreads * kMaxPerThread || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int nvec = D / kN;
  const bool warp_row = nvec <= 32 * (kMaxPerThread / kN);
  const int tpr = warp_row ? 32 : kThreads;
  const int vpt = pick_vpt<T>((nvec + tpr - 1) / tpr);
  if (vpt == 0) return (int)cudaErrorInvalidValue;
  const int rpb = kThreads / tpr;
  const int grid = (rows + rpb - 1) / rpb;
#define PTT_FWD(WPR, V)                                                    \
  ln_fwd_kernel<T, WT, WPR, V><<<grid, kThreads, 0, s>>>(                  \
      static_cast<const T*>(x), static_cast<const WT*>(w),                \
      static_cast<const WT*>(b), static_cast<T*>(out),                    \
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, D, eps)
  if constexpr (kN == 4) {
    if (warp_row) { PTT_VPT_F32(PTT_FWD, 1) } else { PTT_VPT_F32(PTT_FWD, kWarps) }
  } else {
    if (warp_row) { PTT_VPT_BF16(PTT_FWD, 1) } else { PTT_VPT_BF16(PTT_FWD, kWarps) }
  }
#undef PTT_FWD
  return (int)cudaGetLastError();
}

template <typename T, typename WT = float>
cudaError_t bwd_resident(int warps, int vpt, int* per_sm) {
  return nbw::dispatch<32 / Vec<T>::kN>(warps, vpt, [&](auto wpr, auto v) {
    constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
    static int granted[64] = {};
    return nbw::resident(ln_bwd_kernel<T, WT, WPR, VPT>,
                         nbw::Layout<T, WPR, VPT, 2>::kBytes, granted,
                         per_sm);
  });
}

template <typename T, typename WT = float>
int launch_bwd(const void* x, const void* w, const void* mu,
               const void* rstd, const void* dy, void* dx, void* dw,
               void* db, void* partials, int rows, int D, int warps,
               int vpt, int blocks, int cols, cudaStream_t s) {
  if (D % 8 || D > kThreads * kMaxPerThread || rows < 1 || blocks < 1 ||
      (cols != 8 && cols != 16 && cols != 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = nbw::dispatch<32 / Vec<T>::kN>(
      warps, vpt, [&](auto wpr, auto v) {
        constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
        using L = nbw::Layout<T, WPR, VPT, 2>;
        if (D / Vec<T>::kN > VPT * L::kTPR) return cudaErrorInvalidValue;
        static int granted[64] = {};
        cudaError_t e = nbw::allow_smem(ln_bwd_kernel<T, WT, WPR, VPT>,
                                        L::kBytes, granted);
        if (e != cudaSuccess) return e;
        ln_bwd_kernel<T, WT, WPR, VPT>
            <<<blocks, nbw::kThreads, L::kBytes, s>>>(
            static_cast<const T*>(x), static_cast<const WT*>(w),
            static_cast<const float*>(mu), static_cast<const float*>(rstd),
            static_cast<const T*>(dy), static_cast<T*>(dx),
            static_cast<float*>(partials), rows, D, blocks * L::kTeams);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  return (int)nbw::launch_fold(ln_dwdb_kernel, 2 * D, cols, s,
                               static_cast<const float*>(partials),
                               static_cast<float*>(dw),
                               static_cast<float*>(db), blocks, D, cols);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). w and b are f32
// [D] or both null (affine-free); mu and rstd f32 [rows].
extern "C" int ln_fwd_f32(const void* x, const void* w, const void* b,
                          void* out, void* mu, void* rstd, int rows, int D,
                          float eps, void* stream) {
  return launch_fwd<float>(x, w, b, out, mu, rstd, rows, D, eps,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int ln_fwd_bf16(const void* x, const void* w, const void* b,
                           void* out, void* mu, void* rstd, int rows, int D,
                           float eps, void* stream) {
  return launch_fwd<bf16>(x, w, b, out, mu, rstd, rows, D, eps,
                          static_cast<cudaStream_t>(stream));
}

// f16 x and out; w and b f16 (w_f16 != 0) or f32 [D], or both null.
extern "C" int ln_fwd_f16(const void* x, const void* w, const void* b,
                          void* out, void* mu, void* rstd, int rows, int D,
                          float eps, int w_f16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_f16 ? launch_fwd<__half, __half>(x, w, b, out, mu, rstd, rows, D,
                                            eps, s)
               : launch_fwd<__half>(x, w, b, out, mu, rstd, rows, D, eps, s);
}

// The backward with the plan of kernels/norm_bwd.py::bwd_plan: teams of
// `warps` warps holding `vpt` vectors a lane, `blocks` walk blocks (one
// f32 [2, D] partial row each in `partials`: dw's, then db's), a fold of
// `cols` columns a block. w f32 [D], 16-byte aligned, or null
// (affine-free); dw and db f32 [D].
extern "C" int ln_bwd_f32(const void* x, const void* w, const void* mu,
                          const void* rstd, const void* dy, void* dx,
                          void* dw, void* db, void* partials, int rows, int D,
                          int warps, int vpt, int blocks, int cols,
                          void* stream) {
  return launch_bwd<float>(x, w, mu, rstd, dy, dx, dw, db, partials, rows,
                           D, warps, vpt, blocks, cols,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int ln_bwd_bf16(const void* x, const void* w, const void* mu,
                           const void* rstd, const void* dy, void* dx,
                           void* dw, void* db, void* partials, int rows,
                           int D, int warps, int vpt, int blocks, int cols,
                           void* stream) {
  return launch_bwd<bf16>(x, w, mu, rstd, dy, dx, dw, db, partials, rows,
                          D, warps, vpt, blocks, cols,
                          static_cast<cudaStream_t>(stream));
}

// f16 x, dy, dx; w f16 (w_f16 != 0) or f32 [D], or null; dw, db f32.
extern "C" int ln_bwd_f16(const void* x, const void* w, const void* mu,
                          const void* rstd, const void* dy, void* dx,
                          void* dw, void* db, void* partials, int rows,
                          int D, int warps, int vpt, int blocks, int cols,
                          int w_f16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_f16 ? launch_bwd<__half, __half>(x, w, mu, rstd, dy, dx, dw, db,
                                            partials, rows, D, warps, vpt,
                                            blocks, cols, s)
               : launch_bwd<__half>(x, w, mu, rstd, dy, dx, dw, db, partials,
                                    rows, D, warps, vpt, blocks, cols, s);
}

// Walk blocks of the (x_kind: 0 f32, 1 bf16, 2 f16 with an f32 weight,
// 3 f16 with an f16 weight; warps, vpt) backward that fit on one
// multiprocessor, into *per_sm. Returns a cudaError_t.
extern "C" int ln_bwd_resident(int x_kind, int warps, int vpt,
                               int* per_sm) {
  switch (x_kind) {
    case 3: return (int)bwd_resident<__half, __half>(warps, vpt, per_sm);
    case 2: return (int)bwd_resident<__half>(warps, vpt, per_sm);
    case 1: return (int)bwd_resident<bf16>(warps, vpt, per_sm);
    default: return (int)bwd_resident<float>(warps, vpt, per_sm);
  }
}
