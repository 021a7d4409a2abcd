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
// scale [B, D] f32 (the forward's wrapper casts them; the backward reads
// scale in f32 or bf16); mu, rstd f32 [B, N];
// dshift, dscale f32 [B, D]. All arithmetic in f32, in the TPU kernels'
// order: the variance is the mean of the centred squares (two passes over
// registers), not E[x^2] - mu^2.
//
// Bound on the H100: ~10 (fwd) and ~14 (bwd) flops per element against
// 4 and 6 bytes per element in bf16, far below the card's ~295 flop/byte
// ridge: memory bound. At DiT-XL/2's [96, 256, 1152] bf16 the forward
// moves ~113 MB (x in, out written; shift/scale and the statistics are
// <1 %) and the backward ~170 MB: ~0.034 and ~0.051 ms at 3.35 TB/s.
//
// Forward design: one warp per token row, read once into registers as
// 4-value vectors (8-byte loads in bf16, 16-byte in f32): D = 1152 is 288
// vectors, 9 a lane, with no tail; other widths mask the last round. The
// shift and scale rows of the sample (a few KB, read by all its 256
// tokens) stay in L2. Both passes of the statistics and the output run
// over the registers.
//
// Backward design. The backward is LayerNorm's with a per-sample weight
// 1 + scale[b], and its dscale and dshift are LayerNorm's dw and db summed
// per sample, so it runs on the walk of norm_bwd_core.cuh that rows 8 and
// 10 share: persistent warp teams (D 1152 bf16: 2 warps a row, 4 16-byte
// vectors a lane), x, dy, mu and rstd two rows ahead in a cp.async ring,
// the column sums in registers, each block's teams combined in order into
// one f32 partial row, and a fixed-order fold launched as a programmatic
// dependent. What is new for adaLN: the persistent grid's block ranges
// (kernels/norm_bwd.py::adaln_plan) are cut at sample boundaries into
// pieces, so no piece crosses a sample: a block reloads its lanes' 1 +
// scale[b] at the start of each piece and writes one partial row per
// piece, at k + b (block k, sample b: distinct, and each sample's rows
// contiguous), and the fold sums each sample's partial rows in block
// order, its part count read from the plan's arithmetic. No float
// atomics; two calls give identical bits; the plan comes from the shapes
// alone, so a call can be captured in a CUDA graph. bf16 rows of D % 8 ==
// 4 values are not whole 16-byte vectors and walk in 8-byte ones. scale
// is read in its own dtype (f32 or bf16), so the wrapper launches no
// cast. What held the
// previous design back (H100 SXM at 700 W, one CUDA graph: 0.1151 ms at
// [96, 256, 1152] bf16, 44 % of the bound): each warp's dshift/dscale
// sums lived in shared memory (a read-modify-write of two float4s per
// 4-value vector on every row), 8-byte loads in bf16, nothing in flight
// ahead of the row being computed, a second plain launch to sum the
// 32-token chunks and a cast of scale before the call. This design:
// 0.0753-0.0768 ms in one CUDA graph (67 % of the bound; PERF.md), the
// walk 0.070 and the fold 0.004 past it; what is left: blocks whose rows
// cross a sample boundary walk two pieces, each priming the ring and
// writing its own partial row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "norm_bwd_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 4;                  // rows (tokens) in flight a block
constexpr int kThreads = kWarps * 32;
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

// The backward: the walk of norm_bwd_core.cuh over x [B N, D]. Block k of
// `blocks` takes rows [k R / blocks, (k + 1) R / blocks), R = B N, cut at
// sample boundaries into pieces: the piece of sample b is walked by the
// block's teams with the lanes' weight values 1 + scale[b] (f32, in that
// order) reloaded for it, and its column sums go to partial row k + b
// (f32 [2, D]: dscale's, then dshift's). Blocks walk their rows in order,
// so k + b is distinct for every piece, and sample b's pieces are partial
// rows k0 + b .. k1 + b, k0 and k1 the blocks holding its first and last
// row. scale is f32 or bf16 [B, D] (scale_bf16).
template <typename T, int VB, int WPR, int VPT>
__global__ void __launch_bounds__(nbw::kThreads)
adaln_bwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                 int scale_bf16, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ partials, int B,
                 int N, int D) {
  using L = nbw::Layout<T, WPR, VPT, 2, VB>;
  constexpr int kN = L::kN;
  const int t = threadIdx.x % L::kTPR, nvec = D / kN;
  const float* const stat[2] = {mu, rstd};
  const long long R = (long long)B * N;
  const int lo = (int)(blockIdx.x * R / gridDim.x);
  const int hi = (int)((blockIdx.x + 1) * R / gridDim.x);
  for (int b = lo / N; b * N < hi; ++b) {
    const int plo = max(lo, b * N), phi = min(hi, (b + 1) * N);
    float wv[VPT][kN], acc[2][VPT][kN];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * L::kTPR;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const size_t k = (size_t)b * D + v * kN + e;
        float sc = 0.f;
        if (v < nvec)
          sc = scale_bf16 ? __bfloat162float(static_cast<const bf16*>(scale)[k])
                          : static_cast<const float*>(scale)[k];
        wv[i][e] = 1.f + sc;
        acc[0][i][e] = acc[1][i][e] = 0.f;
      }
    }
    nbw::walk_range<T, WPR, VPT, 2, 2, 2, VB>(
        x, dy, dx, stat,
        [&]() { return partials + ((size_t)blockIdx.x + b) * 2 * D; }, plo,
        phi - plo, 0, L::kTeams, D, acc,
        [&](int i, const float (&st)[2], const float (&xv)[kN],
            const float (&dv)[kN], float (&s)[2]) {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float xh = (xv[e] - st[0]) * st[1];
            const float dyw = dv[e] * wv[i][e];
            s[0] += dyw;
            s[1] += dyw * xh;
            acc[0][i][e] += dv[e] * xh;
            acc[1][i][e] += dv[e];
          }
        },
        [&](int i, const float (&st)[2], const float (&s)[2],
            const float (&xv)[kN], const float (&dv)[kN], float (&o)[kN]) {
          const float m1 = s[0] / D, m2 = s[1] / D;
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float xh = (xv[e] - st[0]) * st[1];
            o[e] = st[1] * (dv[e] * wv[i][e] - m1 - xh * m2);
          }
        });
    __syncthreads();   // the partial row is read before the ring refills
  }
}

// dscale[b, d] and dshift[b, d]: columns b * 2D + d and b * 2D + D + d,
// each the sum of sample b's partial rows k0 + b .. k1 + b in order. The
// fold block's samples (at most kFoldThreads / 2D + 2) get their first
// partial row and count once, before the wait for the walk.
__global__ void __launch_bounds__(nbw::kFoldThreads)
adaln_bwd_sum_kernel(const float* __restrict__ partials,
                     float* __restrict__ dshift, float* __restrict__ dscale,
                     int B, int N, int D, int blocks, int cols) {
  __shared__ int first[nbw::kFoldThreads], count[nbw::kFoldThreads];
  const long long R = (long long)B * N;
  const int C = B * 2 * D;
  const int b0 = blockIdx.x * cols / (2 * D);
  {
    // the block holding row r: the last k with k R / blocks <= r
    auto block_of = [&](long long r) {
      return (int)(((r + 1) * blocks - 1) / R);
    };
    const int b = b0 + threadIdx.x;
    if (b < B && (long long)b * 2 * D < (long long)(blockIdx.x + 1) * cols) {
      const int k0 = block_of((long long)b * N);
      first[threadIdx.x] = k0 + b;
      count[threadIdx.x] = block_of((long long)(b + 1) * N - 1) - k0 + 1;
    }
  }
  __syncthreads();
  nbw::fold_parts(
      partials, C, cols,
      [&](int c, int& n, size_t& base, size_t& stride) {
        const int b = c / (2 * D), col = c - b * 2 * D;
        n = count[b - b0];
        base = (size_t)first[b - b0] * 2 * D + col;
        stride = 2 * (size_t)D;
      },
      [&](int c, float v) {
        const int b = c / (2 * D), r = c - b * 2 * D;
        if (r < D) dscale[(size_t)b * D + r] = v;
        else dshift[(size_t)b * D + r - D] = v;
      });
}

// x_kind: 0 f32 rows; 1 bf16 rows of whole 16-byte vectors; 2 bf16 rows of
// D % 8 == 4 values, walked in 8-byte vectors.
template <typename T, int VB>
cudaError_t bwd_resident(int warps, int vpt, int* per_sm) {
  return nbw::dispatch<32 / nbw::Vec<T, VB>::kN>(
      warps, vpt, [&](auto wpr, auto v) {
        constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
        static int granted[64] = {};
        return nbw::resident(adaln_bwd_kernel<T, VB, WPR, VPT>,
                             nbw::Layout<T, WPR, VPT, 2, VB>::kBytes, granted,
                             per_sm);
      });
}

template <typename T, int VB>
cudaError_t launch_bwd(const void* x, const void* scale, int scale_bf16,
                       const void* mu, const void* rstd, const void* dy,
                       void* dx, void* dshift, void* dscale, void* partials,
                       int B, int N, int D, int warps, int vpt, int blocks,
                       int cols, cudaStream_t s) {
  cudaError_t err = nbw::dispatch<32 / nbw::Vec<T, VB>::kN>(
      warps, vpt, [&](auto wpr, auto v) {
        constexpr int WPR = decltype(wpr)::value, VPT = decltype(v)::value;
        using L = nbw::Layout<T, WPR, VPT, 2, VB>;
        if (D / L::kN > VPT * L::kTPR) return cudaErrorInvalidValue;
        static int granted[64] = {};
        cudaError_t e = nbw::allow_smem(adaln_bwd_kernel<T, VB, WPR, VPT>,
                                        L::kBytes, granted);
        if (e != cudaSuccess) return e;
        adaln_bwd_kernel<T, VB, WPR, VPT>
            <<<blocks, nbw::kThreads, L::kBytes, s>>>(
                static_cast<const T*>(x), scale, scale_bf16,
                static_cast<const float*>(mu),
                static_cast<const float*>(rstd), static_cast<const T*>(dy),
                static_cast<T*>(dx), static_cast<float*>(partials), B, N,
                D);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return err;
  return nbw::launch_fold(adaln_bwd_sum_kernel, B * 2 * D, cols, s,
                          static_cast<const float*>(partials),
                          static_cast<float*>(dshift),
                          static_cast<float*>(dscale), B, N, D, blocks, cols);
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

// The backward with the plan of kernels/norm_bwd.py::adaln_plan: teams of
// `warps` warps holding `vpt` vectors a lane, `blocks` walk blocks, a fold
// of `cols` columns a block (a power of two, 8 to 256). x/dy/dx [B, N, D]
// of x_kind (0 f32; 1 bf16, D % 8 == 0; 2 bf16, D % 8 == 4), scale f32 or
// bf16 (scale_bf16) [B, D], mu/rstd f32 [B, N], dshift/dscale f32 [B, D],
// partials an f32 scratch [blocks + B, 2, D]. Returns the launches'
// cudaError_t (0 on success).
extern "C" int adaln_bwd(const void* x, const void* scale, const void* mu,
                         const void* rstd, const void* dy, void* dx,
                         void* dshift, void* dscale, void* partials, int B,
                         int N, int D, int x_kind, int scale_bf16, int warps,
                         int vpt, int blocks, int cols, void* stream) {
  if (D % 4 || D > kMaxVpt * 128 || N < 1 || B < 1 || blocks < 1 ||
      (long long)B * N < blocks || cols < 8 || cols > nbw::kFoldThreads ||
      (cols & (cols - 1)) || (x_kind == 1 && D % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ADALN_BWD(T, VB)                                               \
  launch_bwd<T, VB>(x, scale, scale_bf16, mu, rstd, dy, dx, dshift, dscale,\
                    partials, B, N, D, warps, vpt, blocks, cols, s)
  if (x_kind == 0) return (int)PTT_ADALN_BWD(float, 16);
  if (x_kind == 1) return (int)PTT_ADALN_BWD(bf16, 16);
  if (x_kind == 2) return (int)PTT_ADALN_BWD(bf16, 8);
#undef PTT_ADALN_BWD
  return (int)cudaErrorInvalidValue;
}

// Walk blocks of the (x_kind, warps, vpt) backward that fit on one
// multiprocessor, into *per_sm. Returns a cudaError_t.
extern "C" int adaln_bwd_resident(int x_kind, int warps, int vpt,
                                  int* per_sm) {
  if (x_kind == 0) return (int)bwd_resident<float, 16>(warps, vpt, per_sm);
  if (x_kind == 1) return (int)bwd_resident<bf16, 16>(warps, vpt, per_sm);
  if (x_kind == 2) return (int)bwd_resident<bf16, 8>(warps, vpt, per_sm);
  return (int)cudaErrorInvalidValue;
}
