// RMSNorm kernels for Hopper (sm_90a): the training stack's forward
// (saving the reciprocal RMS) and backward, and the eager API's fused
// forward (row 6), which runs the training forward's walk without its
// statistics.
//
// Replaces: paddle_tpu/kernels/rms_norm.py::_rms_fwd_kernel (pallas_call
// in _rms_fwd_pallas) and ::_rms_bwd_kernel (pallas_call in
// _rms_bwd_pallas), both run twice per decoder layer
// (nlp/llama.py::_decoder_layer); and ::_rms_norm_kernel (pallas_call in
// rms_norm_pallas, reached through the dispatch rms_norm(): the eager
// API's incubate.nn.functional.fused_rms_norm and the FusedRMSNorm layer
// of a Llama built from layers).
//
//   forward:  r = 1 / sqrt(mean(x^2) + eps), out = x * r * w (x's
//             dtype), rstd = r (f32, one per row)
//   backward: dx = r * (w o dy) - x * (r^3 / D) * sum_j dy_j w_j x_j
//             dw = sum over rows of dy o x o r
//   row 6:    out = x * r * w, or x * r with no weight; no rstd. Its
//             backward is not a kernel: the wrapper differentiates the
//             plain version, as the JAX package's eager tape
//             differentiates rms_norm.
// x, out, dy, dx [rows, D] in one dtype T: bf16 (rms_fwd_bf16,
// rms_bwd_bf16, rms_fused_bf16), f16 or f32 (_f16, _f32), one kernel
// template each, as the TPU kernels write out and dx in x's dtype. All
// read w in its own dtype where it is x's or f32 (WT; the wrapper casts
// any other to f32) and the backward writes dw in it (the f32 sum rounded
// once); all arithmetic in f32, in the order of the TPU kernels: (x * r)
// * w, rounded once to x's dtype. r is 1 / sqrtf (correctly rounded) in
// both forwards, where row 6's first design took rsqrtf (~2 ulps): within
// row 6's bounds either way, and one walk computes both.
//
// Bound on the H100: a handful of operations per element against 2 * e
// (fwd: x read, out written) or 3 * e (bwd: x, dy read, dx written)
// bytes per element of e bytes, far below the card's ~295 flop/byte
// ridge: memory bound. The bf16 training steps' [40960, 2048] and
// [16384, 4096] forwards move 336 and 268 MB, 0.100 and 0.080 ms at 3.35
// TB/s; their backwards 503 and 403 MB, 0.150 and 0.120 ms; an f32 x
// doubles each. Row 6 at the eager Llama's [4096, 4096]: 67 MB in bf16
// (0.020 ms), 134 MB in f32 (0.040 ms).
//
// Forward design (both forwards). A row is held in registers by one warp
// (D <= 2048 in 16 bits, as 8 16-byte vectors a lane; 1024 in f32), two,
// four or (f32, D > 4096) eight warps, and its sum of squares reduced by
// warp shuffles alone; a row of several warps adds their sums through
// shared memory under a named barrier of just those warps,
// double-buffered by row parity, so no block-wide barrier is taken per
// row. The grid is persistent: as many blocks (128 threads, or one row of
// eight warps) as fit on the card at once, whose warp teams walk the rows
// with a stride, and each lane loads its weights once (16-byte loads, in
// the weight's dtype) and keeps them in registers. The next row's loads
// are issued before the current row's reduction, so a row's latency hides
// behind the one before it. Row 6 instantiates the same walk with the
// rstd store compiled out and, affine-free, no weight at all. What held
// row 6's first design back (H100 SXM at 700 W, [4096, 4096] bf16 with a
// bf16 weight: 0.0403 ms host-timed against F.rms_norm's 0.0332, 49.6 %
// of the bound): one 256-thread block a row at D 4096 with a block-wide
// barrier a row and 4096 blocks, so no row's loads were in flight behind
// another's reduction; the weight re-read per element through scalar
// loads; and a wrapper that cast every weight but an f16 one to f32 on
// each call, one more launch a call. This design, in one CUDA graph:
// bf16 0.0350 -> 0.0260 ms (77 % of the bound), f16 0.0270 -> 0.0256,
// f32 0.0485 -> 0.0505 (80 %), each below F.rms_norm's.
//
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "norm_bwd_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kMaxD = 8192;      // widest row: 32 values a lane of 256

// A lane's weights of one 16-byte vector of x (kN values of T) in the
// weight's dtype WT, kept packed in registers for the block's life: one
// 16-byte vector of weights, or two (an f32 weight beside 16-bit x).
template <typename T, typename WT>
struct WVec {
  static constexpr int kN = nbw::Vec<T>::kN;
  static constexpr int kWN = nbw::Vec<WT>::kN;    // weights a vector
  static constexpr int kV = kN / kWN;
  static_assert(kV * kWN == kN, "whole weight vectors an x vector");
  uint4 v[kV];
  __device__ __forceinline__ void load(const WT* p) {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void get(float (&f)[kN]) const {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      nbw::Vec<WT>::unpack(v[i],
                           *reinterpret_cast<float(*)[kWN]>(f + i * kWN));
  }
};

// Rows of WPR warps each (a team), VPT 16-byte vectors a lane; the grid's
// teams walk the rows with a stride. Blocks of 128 threads (a team of
// eight warps: 256): at ~150 registers a thread (the current and the next
// row and the weights, held in registers) three fit on an SM where one
// block of 256 would leave room for just one.
constexpr int kFwdThreads = 128;

template <int WPR>
__host__ __device__ constexpr int fwd_block() {
  return 32 * WPR > kFwdThreads ? 32 * WPR : kFwdThreads;
}

// The forward walk of both forwards: kStats stores rstd (row 7), and
// without kAffine the weight is neither read nor applied (row 6's
// affine-free form; w is then null).
template <typename T, typename WT, int WPR, int VPT, bool kStats,
          bool kAffine>
__device__ __forceinline__ void fwd_walk(const T* __restrict__ x,
                                         const WT* __restrict__ w,
                                         T* __restrict__ out,
                                         float* __restrict__ rstd, int rows,
                                         int D, float eps) {
  constexpr int kBlock = fwd_block<WPR>();
  constexpr int kN = nbw::Vec<T>::kN;
  constexpr int kTPR = 32 * WPR;              // threads a row
  constexpr int kTeams = kBlock / kTPR;       // rows a block holds
  __shared__ float red[2][kBlock / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / WPR, t = threadIdx.x % kTPR;
  const int nvec = D / kN;
  WVec<T, WT> wv[VPT];
  if constexpr (kAffine) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = t + i * kTPR;
      if (vi < nvec) wv[i].load(w + vi * kN);
    }
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
        float f[kN];
        nbw::Vec<T>::unpack(cur[i], f);
#pragma unroll
        for (int j = 0; j < kN; ++j) ss += f[j] * f[j];
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
        float f[kN], o[kN];
        nbw::Vec<T>::unpack(cur[i], f);
        if constexpr (kAffine) {
          float g[kN];
          wv[i].get(g);
#pragma unroll
          for (int j = 0; j < kN; ++j) o[j] = f[j] * r * g[j];
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) o[j] = f[j] * r;
        }
        orow[vi] = nbw::Vec<T>::pack(o);
      }
    }
    if constexpr (kStats) {
      if (t == 0) rstd[row] = r;
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

// Row 7: the training forward, saving rstd.
template <typename T, typename WT, int WPR, int VPT>
__global__ void __launch_bounds__(fwd_block<WPR>())
rms_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
               T* __restrict__ out, float* __restrict__ rstd, int rows,
               int D, float eps) {
  fwd_walk<T, WT, WPR, VPT, true, true>(x, w, out, rstd, rows, D, eps);
}

// Row 6: the eager fused norm, no statistics; affine-free without kAffine.
template <typename T, typename WT, int WPR, int VPT, bool kAffine>
__global__ void __launch_bounds__(fwd_block<WPR>())
rms_fused_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                 T* __restrict__ out, int rows, int D, float eps) {
  fwd_walk<T, WT, WPR, VPT, false, kAffine>(x, w, out, nullptr, rows, D,
                                            eps);
}

// The backward's walk: WPR warps a row, VPT vectors of x a lane, the
// weight's values of those vectors held in registers in its own dtype.
template <typename T, typename WT, int WPR, int VPT>
__global__ void __launch_bounds__(nbw::kThreads)
rms_bwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ rstd, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ partials,
               int rows, int D, int n_teams) {
  constexpr int kN = nbw::Vec<T>::kN;
  constexpr int kTPR = 32 * WPR;
  const int t = threadIdx.x % kTPR, nvec = D / kN;
  WVec<T, WT> wv[VPT];
  float acc[1][VPT][kN];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (t + i * kTPR < nvec) wv[i].load(w + (t + i * kTPR) * kN);
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[0][i][j] = 0.f;
  }
  const float inv_d = 1.f / D;
  const float* const stat[1] = {rstd};
  nbw::walk<T, WPR, VPT, 1, 1, 1>(
      x, dy, dx, stat, partials, rows, D, n_teams, acc,
      [&](int i, const float (&st)[1], const float (&xv)[kN],
          const float (&dv)[kN], float (&s)[1]) {
        float g[kN];
        wv[i].get(g);
#pragma unroll
        for (int j = 0; j < kN; ++j) s[0] += dv[j] * g[j] * xv[j];
      },
      [&](int i, const float (&st)[1], const float (&s)[1],
          const float (&xv)[kN], const float (&dv)[kN], float (&o)[kN]) {
        const float r = st[0];
        const float c3 = r * r * r * inv_d;
        float g[kN];
        wv[i].get(g);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          o[j] = r * (dv[j] * g[j]) - xv[j] * c3 * s[0];
          acc[0][i][j] += dv[j] * xv[j] * r;
        }
      });
}

// dw[c] = the partial rows' column c, folded in the plan's fixed order,
// rounded once to the weight's dtype.
template <typename WT>
__global__ void __launch_bounds__(nbw::kFoldThreads)
rms_dw_kernel(const float* __restrict__ partials, WT* __restrict__ dw,
              int n_parts, int D, int cols) {
  nbw::fold(partials, n_parts, D, cols,
            [&](int c, float v) { dw[c] = nbw::from_f32<WT>(v); });
}

// 16-byte vectors of x a lane may hold: 4 of 16 bits, 8 of f32 (32
// values either way)
template <typename T>
__host__ __device__ constexpr int vmax() { return 32 / nbw::Vec<T>::kN; }

template <typename T, typename WT>
cudaError_t bwd_resident(int warps, int vpt, int* per_sm) {
  return nbw::dispatch<vmax<T>()>(warps, vpt, [&](auto wpr, auto v) {
    constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
    static int granted[64] = {};
    return nbw::resident(rms_bwd_kernel<T, WT, WPR, VPT>,
                         nbw::Layout<T, WPR, VPT, 1>::kBytes, granted,
                         per_sm);
  });
}

template <typename T, typename WT>
cudaError_t launch_bwd(const void* x, const void* w, const void* rstd,
                       const void* dy, void* dx, void* dw, void* partials,
                       int rows, int D, int warps, int vpt, int blocks,
                       int cols, cudaStream_t s) {
  cudaError_t err = nbw::dispatch<vmax<T>()>(warps, vpt, [&](auto wpr,
                                                             auto v) {
    constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
    using L = nbw::Layout<T, WPR, VPT, 1>;
    if (D / nbw::Vec<T>::kN > VPT * L::kTPR) return cudaErrorInvalidValue;
    static int granted[64] = {};
    cudaError_t e = nbw::allow_smem(rms_bwd_kernel<T, WT, WPR, VPT>,
                                    L::kBytes, granted);
    if (e != cudaSuccess) return e;
    rms_bwd_kernel<T, WT, WPR, VPT><<<blocks, nbw::kThreads, L::kBytes, s>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w),
        static_cast<const float*>(rstd), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<float*>(partials), rows, D,
        blocks * L::kTeams);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return nbw::launch_fold(rms_dw_kernel<WT>, D, cols, s,
                          static_cast<const float*>(partials),
                          static_cast<WT*>(dw), blocks, D, cols);
}

// The persistent grid: as many blocks as fit on the card at once, asked
// of the runtime once per kernel and device. kKind: 0 row 7 (rstd
// stored), 1 row 6, 2 row 6 affine-free (w and rstd unused).
template <typename T, typename WT, int WPR, int VPT, int kKind>
cudaError_t launch_fwd(const void* x, const void* w, void* out, void* rstd,
                       int rows, int D, float eps, cudaStream_t s) {
  constexpr int kBlock = fwd_block<WPR>();
  constexpr int kTeams = kBlock / (32 * WPR);
  auto kernel = [] {
    if constexpr (kKind == 0) return rms_fwd_kernel<T, WT, WPR, VPT>;
    else return rms_fused_kernel<T, WT, WPR, VPT, kKind == 1>;
  }();
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < 64 ? resident[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kBlock, 0);
    if (err != cudaSuccess) return err;
    full = sms * std::max(per_sm, 1);
    if (dev < 64) resident[dev] = full;
  }
  const int grid = std::max(1, std::min((rows + kTeams - 1) / kTeams, full));
  if constexpr (kKind == 0)
    kernel<<<grid, kBlock, 0, s>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w),
        static_cast<T*>(out), static_cast<float*>(rstd), rows, D, eps);
  else
    kernel<<<grid, kBlock, 0, s>>>(static_cast<const T*>(x),
                                   static_cast<const WT*>(w),
                                   static_cast<T*>(out), rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename WT, int kKind>
cudaError_t dispatch_fwd(const void* x, const void* w, void* out, void* rstd,
                         int rows, int D, float eps, cudaStream_t s) {
  const int nvec = D / nbw::Vec<T>::kN;
#define PTT_FWD(WPR, VPT) \
  return launch_fwd<T, WT, WPR, VPT, kKind>(x, w, out, rstd, rows, D, eps, s)
  if (nvec <= 32) PTT_FWD(1, 1);
  if (nvec <= 64) PTT_FWD(1, 2);
  if (nvec <= 128) PTT_FWD(1, 4);
  if (nvec <= 256) PTT_FWD(1, 8);
  if (nvec <= 512) PTT_FWD(2, 8);
  if constexpr (nbw::Vec<T>::kN == 4) {       // f32 rows above D 4096
    if (nvec > 1024) PTT_FWD(8, 8);
  }
  PTT_FWD(4, 8);
#undef PTT_FWD
}

// The x and weight types of the entry points: x T, the weight T (w_x !=
// 0) or f32
template <typename T, class F>
cudaError_t by_weight(int w_x, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    return f(float{});
  } else {
    return w_x ? f(T{}) : f(float{});
  }
}

// kKind as launch_fwd's; row 6 (rstd null) is affine-free when w is null
template <typename T>
int fwd_entry(const void* x, const void* w, void* out, void* rstd, int rows,
              int D, float eps, int w_x, void* stream) {
  if (D % 8 || D > kMaxD || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rstd == nullptr && w == nullptr)
    return (int)dispatch_fwd<T, T, 2>(x, w, out, rstd, rows, D, eps, s);
  return (int)by_weight<T>(w_x, [&](auto wt) {
    using WT = decltype(wt);
    return rstd != nullptr
               ? dispatch_fwd<T, WT, 0>(x, w, out, rstd, rows, D, eps, s)
               : dispatch_fwd<T, WT, 1>(x, w, out, rstd, rows, D, eps, s);
  });
}

template <typename T>
int bwd_entry(const void* x, const void* w, const void* rstd, const void* dy,
              void* dx, void* dw, void* partials, int rows, int D, int w_x,
              int warps, int vpt, int blocks, int cols, void* stream) {
  if (D % 8 || D > kMaxD || rows < 1 || blocks < 1 ||
      (cols != 8 && cols != 16 && cols != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_weight<T>(w_x, [&](auto wt) {
    using WT = decltype(wt);
    return launch_bwd<T, WT>(x, w, rstd, dy, dx, dw, partials, rows, D,
                             warps, vpt, blocks, cols, s);
  });
}

}  // namespace

// x and out bf16, f16 or f32 [rows, D] (rms_fwd_bf16, _f16, _f32), rstd
// f32 [rows]; w [D], 16-byte aligned, in x's dtype (w_x != 0; f32 x: f32,
// whatever w_x says) or f32. Returns the launch's cudaError_t (0 on
// success).
#define PTT_RMS_FWD(NAME, T)                                               \
  extern "C" int NAME(const void* x, const void* w, void* out, void* rstd, \
                      int rows, int D, float eps, int w_x, void* stream) { \
    return fwd_entry<T>(x, w, out, rstd, rows, D, eps, w_x, stream);       \
  }
PTT_RMS_FWD(rms_fwd_bf16, bf16)
PTT_RMS_FWD(rms_fwd_f16, __half)
PTT_RMS_FWD(rms_fwd_f32, float)
#undef PTT_RMS_FWD

// Row 6: the forward without rstd; x and out bf16, f16 or f32 [rows, D]
// (rms_fused_bf16, _f16, _f32); w as rms_fwd's, or null (affine-free).
// Returns the launch's cudaError_t (0 on success).
#define PTT_RMS_FUSED(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* w, void* out, int rows,  \
                      int D, float eps, int w_x, void* stream) {          \
    return fwd_entry<T>(x, w, out, nullptr, rows, D, eps, w_x, stream);   \
  }
PTT_RMS_FUSED(rms_fused_bf16, bf16)
PTT_RMS_FUSED(rms_fused_f16, __half)
PTT_RMS_FUSED(rms_fused_f32, float)
#undef PTT_RMS_FUSED

// The backward with the plan of kernels/norm_bwd.py::bwd_plan: teams of
// `warps` warps holding `vpt` vectors a lane, `blocks` walk blocks (one
// f32 [D] partial row each in `partials`), a fold of `cols` columns a
// block. x, dy and dx in one dtype (rms_bwd_bf16, _f16, _f32); w and dw
// in x's dtype (w_x != 0) or f32 [D], 16-byte aligned. Returns the
// launches' cudaError_t (0 on success).
#define PTT_RMS_BWD(NAME, T)                                                \
  extern "C" int NAME(const void* x, const void* w, const void* rstd,       \
                      const void* dy, void* dx, void* dw, void* partials,   \
                      int rows, int D, int w_x, int warps, int vpt,         \
                      int blocks, int cols, void* stream) {                 \
    return bwd_entry<T>(x, w, rstd, dy, dx, dw, partials, rows, D, w_x,     \
                        warps, vpt, blocks, cols, stream);                  \
  }
PTT_RMS_BWD(rms_bwd_bf16, bf16)
PTT_RMS_BWD(rms_bwd_f16, __half)
PTT_RMS_BWD(rms_bwd_f32, float)
#undef PTT_RMS_BWD

// Walk blocks of the (kind, warps, vpt) backward that fit on one
// multiprocessor, into *per_sm; kind (kernels/rms_norm.py::_BWD_KINDS):
// 0 f32 x, 1 bf16 x with an f32 weight, 2 bf16 x and weight, 3 f16 x
// with an f32 weight, 4 f16 x and weight. Returns a cudaError_t.
extern "C" int rms_bwd_resident(int kind, int warps, int vpt, int* per_sm) {
  switch (kind) {
    case 0: return (int)bwd_resident<float, float>(warps, vpt, per_sm);
    case 1: return (int)bwd_resident<bf16, float>(warps, vpt, per_sm);
    case 2: return (int)bwd_resident<bf16, bf16>(warps, vpt, per_sm);
    case 3: return (int)bwd_resident<__half, float>(warps, vpt, per_sm);
    case 4: return (int)bwd_resident<__half, __half>(warps, vpt, per_sm);
  }
  return (int)cudaErrorInvalidValue;
}
