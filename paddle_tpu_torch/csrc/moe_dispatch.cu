// MoE dispatch and combine row gathers for Hopper (sm_90a), and the
// dispatch gather fused into the expert gate/up products.
//
// Replaces: paddle_tpu/kernels/moe_dispatch.py::_gather_wsum_kernel
// (pallas_call in gather_wsum_pallas) and ::_gather_scale_dot_kernel
// (pallas_call in gather_scale_dot_pallas). On one device the MoE block
// (nlp/moe.py::moe_block) runs the first in its dispatch forward (k = 1),
// its combine forward and its dispatch backward (k = 2), the second in
// its combine backward. Also ::_gather_rows_kernel (pallas_call in
// gather_rows_pallas, the masked row gather) and ::_gather_mlp_kernel
// (pallas_call in gather_mlp_pallas), which no path of the JAX package
// launches (see gather_rows_bf16 and gather_mlp_bf16 below).
//
//   gather_wsum:      out[r] = sum_j w[r, j] * src[b, idx[r, j]]
//                     (f32 products and sum in the order j = 0..k-1,
//                      rounded once to bf16)
//   gather_scale_dot: out[r] = scale[r] * src[b, idx[r]]       (bf16)
//                     dot[r] = sum_d src[b, idx[r]][d] * other[r][d] (f32)
// src, other, out bf16 row-major; idx int32, pre-clipped to [0, N) by
// the caller (clamped again here, so a bad index cannot read outside
// src); w, scale, dot f32; b = r / M is the batch row of output row r.
//
// Bound on the H100: memory, by random 4 KiB row reads (D = 2048 bf16)
// with a few operations per byte. Design: one warp per output row, so a
// row's reads are 16-byte vectors of one contiguous 4 KiB span, 32 lanes
// side by side; each lane issues the 16-byte loads of several vectors of
// every source row before it uses any (kUnroll vectors of each of the k
// rows), so a warp keeps k * kUnroll * 512 bytes in flight; 8 warps a
// block and thousands of blocks keep every SM's load slots busy. A choice
// whose weight is 0 (an empty slot or a dropped choice: the caller clips
// its index to row 0) skips its read. The products and the sum use
// __fmul_rn / __fadd_rn so they are never contracted into FMAs: the
// result is bit for bit the plain version's f32 expression.
//
//   gather_rows:      out[r] = src[b, idx[r]], or zeros where idx[r] < 0
//                     (the masked gather of combine_gather; bit for bit)
//   gather_mlp:       g = xin . wg[e], u = xin . wu[e] with xin[e, m] =
//                     src[idx[e, m]] (zeros where < 0), and xin itself
// gather_rows is bound as gather_wsum is (memory, random rows), with a
// copy kernel of its own. gather_mlp at the MoE step's shape (T 40960,
// E 16, M 6400, D 2048, F 1024) is bound by the tensor cores: 4 D F
// flops a filled slot (an empty slot's g and u are zero rows), 0.86
// TFLOP or 0.87 ms at 989 TFLOP/s were every slot filled; this first
// version runs mma.sync from
// shared-memory tiles with no copy pipeline, wgmma or TMA (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 8;                 // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 8;

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

__device__ __forceinline__ long clamp_row(int i, int N) {
  return (long)min(max(i, 0), N - 1);
}

// Vectors of each source row a lane loads before it uses them: more
// rows in flight for small k, fewer registers for large k.
template <int K>
struct Unroll {
  static constexpr int value = K <= 2 ? 4 : (K <= 4 ? 2 : 1);
};

template <int K>
__global__ void __launch_bounds__(kThreads)
gather_wsum_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ w, bf16* __restrict__ out,
                   long rows, int M, int N, int D) {
  constexpr int U = Unroll<K>::value;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long b = row / M;
  const int nvec = D >> 3;
  const uint4* base[K];
  float wj[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    wj[j] = __ldg(w + row * K + j);
    base[j] = reinterpret_cast<const uint4*>(
        src + (b * N + clamp_row(__ldg(idx + row * K + j), N)) * D);
  }
  uint4* orow = reinterpret_cast<uint4*>(out + row * D);
  for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
    uint4 r[K][U];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * 32;
        r[j][u] = (v < nvec && wj[j] != 0.f) ? __ldg(base[j] + v)
                                             : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * 32;
      if (v >= nvec) break;
      float acc[8], x[8];
      unpack8(r[0][u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(x[e], wj[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) {
        unpack8(r[j][u], x);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wj[j]));
      }
      orow[v] = pack8(acc);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_scale_dot_kernel(const bf16* __restrict__ src,
                        const int* __restrict__ idx,
                        const float* __restrict__ scale,
                        const bf16* __restrict__ other,
                        bf16* __restrict__ out, float* __restrict__ dot,
                        long rows, int M, int N, int D) {
  constexpr int U = 4;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long b = row / M;
  const int nvec = D >> 3;
  const float s = __ldg(scale + row);
  const uint4* srow = reinterpret_cast<const uint4*>(
      src + (b * N + clamp_row(__ldg(idx + row), N)) * D);
  const uint4* orow = reinterpret_cast<const uint4*>(other + row * D);
  uint4* dst = reinterpret_cast<uint4*>(out + row * D);
  float d = 0.f;
  for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
    uint4 xs[U], ys[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * 32;
      xs[u] = v < nvec ? __ldg(srow + v) : make_uint4(0, 0, 0, 0);
      ys[u] = v < nvec ? __ldg(orow + v) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * 32;
      if (v >= nvec) break;
      float x[8], y[8], o[8];
      unpack8(xs[u], x);
      unpack8(ys[u], y);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = __fmul_rn(x[e], s);
        d += x[e] * y[e];
      }
      dst[v] = pack8(o);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) d += __shfl_xor_sync(0xffffffffu, d, m);
  if (lane == 0) dot[row] = d;
}

// --------------------------------------------------------- gather_rows
// out[r] = src[b, idx[r]] for idx[r] >= 0, else a row of zeros (not
// read). A separate copy kernel, not gather_wsum with k = 1: a copy is
// bit for bit by construction (no f32 round trip), -1 needs no clipping
// by the caller, and a zero row is +0.0 whatever the source holds. One
// warp per output row, 16-byte loads, kUnroll vectors in flight a lane.
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
                   bf16* __restrict__ out, long rows, int M, int N, int D) {
  constexpr int U = 4;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = D >> 3;
  const int i = __ldg(idx + row);
  uint4* dst = reinterpret_cast<uint4*>(out + row * D);
  if (i < 0 || i >= N) {
    for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* srow = reinterpret_cast<const uint4*>(
      src + ((row / M) * N + i) * D);
  for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
    uint4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * 32;
      r[u] = v < nvec ? __ldg(srow + v) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * 32;
      if (v < nvec) dst[v] = r[u];
    }
  }
}

// ---------------------------------------------------------- gather_mlp
// g[e, m] = xin[e, m] . wg[e], u[e, m] = xin[e, m] . wu[e], with
// xin[e, m] = src[idx[e, m]] (a zero row for -1), bf16 in and out, f32
// accumulation. Block (F tile, slot tile, expert): 8 warps, 4 along the
// 64 slots (16 rows each) by 2 along the 128 columns of the F tile (64
// each, for g and for u). The K = D loop stages, per 32-wide step, the
// gathered A tile [64 x 32] once in shared memory (zeros for empty
// slots and past M) and the wg and wu tiles [32 x 128]; that one A tile
// feeds both products (the fusion point: the gathered rows never make a
// device-memory round trip before the GEMMs). The blocks of the first F
// tile also write the A tiles to xin, the backward's residual, so xin is
// written once. mma.sync m16n8k16 (attention_core.cuh's fragments);
// B fragments are packed from the row-major [K, F] weight tiles.
constexpr int kMlpM = 64;       // slots a block
constexpr int kMlpN = 128;      // columns of F a block, for g and for u
constexpr int kMlpK = 32;       // the K step
constexpr int kMlpThreads = 256;

struct MlpSmem {
  bf16 a[kMlpM][kMlpK + 8];
  bf16 bg[kMlpK][kMlpN + 8];
  bf16 bu[kMlpK][kMlpN + 8];
  int rows[kMlpM];
};

__global__ void __launch_bounds__(kMlpThreads)
gather_mlp_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
                  const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                  bf16* __restrict__ g, bf16* __restrict__ u,
                  bf16* __restrict__ xin, int T, int M, int D, int F) {
  __shared__ __align__(16) MlpSmem sm;
  const int f0 = blockIdx.x * kMlpN, m0 = blockIdx.y * kMlpM;
  const int e = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // 16-row x 64-column part
  const bool write_xin = blockIdx.x == 0;
  if (threadIdx.x < kMlpM) {
    const int m = m0 + threadIdx.x;
    const int i = m < M ? __ldg(idx + (long)e * M + m) : -1;
    sm.rows[threadIdx.x] = (i >= 0 && i < T) ? i : -1;
  }
  const bf16* wge = wg + (long)e * D * F;
  const bf16* wue = wu + (long)e * D * F;
  float accg[8][4], accu[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) accg[nt][q] = accu[nt][q] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += kMlpK) {
    {   // A: 64 rows x 32 columns = 256 vectors of 8, one a thread
      const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 8;
      const int i = sm.rows[r];
      uint4 val = make_uint4(0, 0, 0, 0);
      if (i >= 0 && k0 + c < D)
        val = __ldg(reinterpret_cast<const uint4*>(src + (long)i * D + k0 +
                                                   c));
      *reinterpret_cast<uint4*>(&sm.a[r][c]) = val;
      if (write_xin && m0 + r < M && k0 + c < D)
        *reinterpret_cast<uint4*>(xin + ((long)e * M + m0 + r) * D + k0 +
                                  c) = val;
    }
    // B: 32 rows x 128 columns of wg and of wu = 512 vectors each
    for (int v = threadIdx.x; v < kMlpK * kMlpN / 8; v += kMlpThreads) {
      const int r = v / (kMlpN / 8), c = (v % (kMlpN / 8)) * 8;
      uint4 vg = make_uint4(0, 0, 0, 0), vu = vg;
      if (k0 + r < D && f0 + c < F) {
        const long off = (long)(k0 + r) * F + f0 + c;
        vg = __ldg(reinterpret_cast<const uint4*>(wge + off));
        vu = __ldg(reinterpret_cast<const uint4*>(wue + off));
      }
      *reinterpret_cast<uint4*>(&sm.bg[r][c]) = vg;
      *reinterpret_cast<uint4*>(&sm.bu[r][c]) = vu;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMlpK / 16; ++ks) {
      uint32_t a[4];
      const bf16* ar0 = &sm.a[wm * 16 + gq][ks * 16 + 2 * tq];
      const bf16* ar1 = ar0 + 8 * (kMlpK + 8);
      a[0] = *reinterpret_cast<const uint32_t*>(ar0);
      a[1] = *reinterpret_cast<const uint32_t*>(ar1);
      a[2] = *reinterpret_cast<const uint32_t*>(ar0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ar1 + 8);
      const int kr = ks * 16 + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = wn * 64 + nt * 8 + gq;
        ptt::mma_bf16(accg[nt], a,
                      ptt::pack_raw(sm.bg[kr][n], sm.bg[kr + 1][n]),
                      ptt::pack_raw(sm.bg[kr + 8][n], sm.bg[kr + 9][n]));
        ptt::mma_bf16(accu[nt], a,
                      ptt::pack_raw(sm.bu[kr][n], sm.bu[kr + 1][n]),
                      ptt::pack_raw(sm.bu[kr + 8][n], sm.bu[kr + 9][n]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wm * 16 + gq + h * 8;
    if (m >= M) continue;
    const long base = ((long)e * M + m) * F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = f0 + wn * 64 + nt * 8 + 2 * tq;
      if (col >= F) continue;
      *reinterpret_cast<uint32_t*>(g + base + col) =
          ptt::pack_bf16(accg[nt][2 * h], accg[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(u + base + col) =
          ptt::pack_bf16(accu[nt][2 * h], accu[nt][2 * h + 1]);
    }
  }
}

}  // namespace

// src [B, N, D] bf16; idx, w [B, M, k]; out [B, M, D] bf16. Returns the
// launch's cudaError_t (0 on success).
extern "C" int gather_wsum_bf16(const void* src, const void* idx,
                                const void* w, void* out, int B, int N,
                                int M, int k, int D, void* stream) {
  if (D % 8 || k < 1 || k > kMaxK || N < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * M;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_WSUM(K)                                                         \
  gather_wsum_kernel<K><<<blocks, kThreads, 0, s>>>(                        \
      static_cast<const bf16*>(src), static_cast<const int*>(idx),          \
      static_cast<const float*>(w), static_cast<bf16*>(out), rows, M, N, D)
  switch (k) {
    case 1: PTT_WSUM(1); break;
    case 2: PTT_WSUM(2); break;
    case 3: PTT_WSUM(3); break;
    case 4: PTT_WSUM(4); break;
    case 5: PTT_WSUM(5); break;
    case 6: PTT_WSUM(6); break;
    case 7: PTT_WSUM(7); break;
    default: PTT_WSUM(8); break;
  }
#undef PTT_WSUM
  return (int)cudaGetLastError();
}

// src [B, N, D] bf16; idx, scale [B, M]; other, out [B, M, D] bf16; dot
// [B, M] f32. Returns the launch's cudaError_t (0 on success).
extern "C" int gather_scale_dot_bf16(const void* src, const void* idx,
                                     const void* scale, const void* other,
                                     void* out, void* dot, int B, int N,
                                     int M, int D, void* stream) {
  if (D % 8 || N < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * M;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  gather_scale_dot_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const int*>(idx),
      static_cast<const float*>(scale), static_cast<const bf16*>(other),
      static_cast<bf16*>(out), static_cast<float*>(dot), rows, M, N, D);
  return (int)cudaGetLastError();
}

// src [B, N, D] bf16; idx [B, M] int32 (-1 = a zero row); out [B, M, D]
// bf16. Returns the launch's cudaError_t (0 on success).
extern "C" int gather_rows_bf16(const void* src, const void* idx, void* out,
                                int B, int N, int M, int D, void* stream) {
  if (D % 8 || N < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * M;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  gather_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const int*>(idx),
      static_cast<bf16*>(out), rows, M, N, D);
  return (int)cudaGetLastError();
}

// src [T, D] bf16; idx [E, M] int32 (-1 = empty slot); wg, wu [E, D, F]
// bf16; g, u [E, M, F] and xin [E, M, D] bf16. D and F multiples of 8.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gather_mlp_bf16(const void* src, const void* idx,
                               const void* wg, const void* wu, void* g,
                               void* u, void* xin, int T, int E, int M,
                               int D, int F, void* stream) {
  if (D % 8 || F % 8 || T < 1) return (int)cudaErrorInvalidValue;
  if ((long)E * M == 0) return (int)cudaSuccess;
  const dim3 grid((F + kMlpN - 1) / kMlpN, (M + kMlpM - 1) / kMlpM, E);
  gather_mlp_kernel<<<grid, kMlpThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const int*>(idx),
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<bf16*>(g), static_cast<bf16*>(u), static_cast<bf16*>(xin),
      T, M, D, F);
  return (int)cudaGetLastError();
}
