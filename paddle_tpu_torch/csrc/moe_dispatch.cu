// MoE dispatch and combine row gathers for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/moe_dispatch.py::_gather_wsum_kernel
// (pallas_call in gather_wsum_pallas) and ::_gather_scale_dot_kernel
// (pallas_call in gather_scale_dot_pallas). On one device the MoE block
// (nlp/moe.py::moe_block) runs the first in its dispatch forward (k = 1),
// its combine forward and its dispatch backward (k = 2), the second in
// its combine backward. Also ::_gather_rows_kernel (pallas_call in
// gather_rows_pallas, the masked row gather), which no path of the JAX
// package launches (see gather_rows_bf16 below). The dispatch gather
// fused into the expert products (::_gather_mlp_kernel) is gather_mlp.cu.
//
//   gather_wsum:      out[r] = sum_j w[r, j] * src[b, idx[r, j]]
//                     (f32 products and sum in the order j = 0..k-1,
//                      rounded once to src's type)
//   gather_scale_dot: out[r] = scale[r] * src[b, idx[r]]   (src's type)
//                     dot[r] = sum_d src[b, idx[r]][d] * other[r][d] (f32)
// src, other, out row-major in one element type T: bf16, f16 or f32 for
// these two (the TPU kernels compute in the rows' dtype), bf16 for
// gather_rows; idx int32, pre-clipped to [0, N) by the caller (clamped
// again here, so a bad index cannot read outside src); w, scale, dot
// f32; b = r / M is the batch row of output row r. A row is a whole
// number of 16-byte vectors: 8 bf16 or f16 values, 4 f32.
//
// Bound on the H100: memory, by random 4 KiB row reads (D = 2048 bf16;
// 8 KiB in f32) with a few operations per byte. Design: one warp per
// output row, so a row's reads are 16-byte vectors of one contiguous span, 32 lanes
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
// gather_rows is bound as gather_wsum is (memory, random rows), with a
// copy kernel of its own.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;
constexpr int kWarps = 8;                 // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 8;

// A 16-byte vector of T as N = 2^kShift f32 values, and back (round to
// nearest even, as torch's .to() rounds): 8 bf16 or f16, 4 f32.
template <class T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int N = 8, kShift = 3;
  static __device__ __forceinline__ void unpack(const uint4& u, float f[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float f[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec<f16> {
  static constexpr int N = 8, kShift = 3;
  static __device__ __forceinline__ void unpack(const uint4& u, float f[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __half22float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float f[8]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4, kShift = 2;
  static __device__ __forceinline__ void unpack(const uint4& u, float f[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float f[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ long clamp_row(int i, int N) {
  return (long)min(max(i, 0), N - 1);
}

// Vectors of each source row a lane loads before it uses them: more
// rows in flight for small k, fewer registers for large k.
template <int K>
struct Unroll {
  static constexpr int value = K <= 2 ? 4 : (K <= 4 ? 2 : 1);
};

template <class T, int K>
__global__ void __launch_bounds__(kThreads)
gather_wsum_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ w, T* __restrict__ out,
                   long rows, int M, int N, int D) {
  constexpr int U = Unroll<K>::value;
  constexpr int E = Vec<T>::N;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long b = row / M;
  const int nvec = D >> Vec<T>::kShift;
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
      float acc[E], x[E];
      Vec<T>::unpack(r[0][u], x);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(x[e], wj[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) {
        Vec<T>::unpack(r[j][u], x);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wj[j]));
      }
      orow[v] = Vec<T>::pack(acc);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
gather_scale_dot_kernel(const T* __restrict__ src,
                        const int* __restrict__ idx,
                        const float* __restrict__ scale,
                        const T* __restrict__ other,
                        T* __restrict__ out, float* __restrict__ dot,
                        long rows, int M, int N, int D) {
  constexpr int U = 4;
  constexpr int E = Vec<T>::N;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long b = row / M;
  const int nvec = D >> Vec<T>::kShift;
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
      float x[E], y[E], o[E];
      Vec<T>::unpack(xs[u], x);
      Vec<T>::unpack(ys[u], y);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = __fmul_rn(x[e], s);
        d += x[e] * y[e];
      }
      dst[v] = Vec<T>::pack(o);
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

template <class T>
int wsum(const void* src, const void* idx, const void* w, void* out, int B,
         int N, int M, int k, int D, void* stream) {
  if ((D * (int)sizeof(T)) % 16 || k < 1 || k > kMaxK || N < 1)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)B * M;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_WSUM(K)                                                         \
  gather_wsum_kernel<T, K><<<blocks, kThreads, 0, s>>>(                     \
      static_cast<const T*>(src), static_cast<const int*>(idx),             \
      static_cast<const float*>(w), static_cast<T*>(out), rows, M, N, D)
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

template <class T>
int scale_dot(const void* src, const void* idx, const void* scale,
              const void* other, void* out, void* dot, int B, int N, int M,
              int D, void* stream) {
  if ((D * (int)sizeof(T)) % 16 || N < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * M;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  gather_scale_dot_kernel<T><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx),
      static_cast<const float*>(scale), static_cast<const T*>(other),
      static_cast<T*>(out), static_cast<float*>(dot), rows, M, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

// src [B, N, D]; idx, w [B, M, k]; out [B, M, D]; src and out in the
// entry point's type (gather_wsum_bf16, _f16, _f32), D * its size a
// multiple of 16 bytes. Returns the launch's cudaError_t (0 on success).
#define PTT_WSUM_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* src, const void* idx, const void* w,      \
                      void* out, int B, int N, int M, int k, int D,         \
                      void* stream) {                                       \
    return wsum<T>(src, idx, w, out, B, N, M, k, D, stream);                \
  }
PTT_WSUM_ENTRY(gather_wsum_bf16, bf16)
PTT_WSUM_ENTRY(gather_wsum_f16, f16)
PTT_WSUM_ENTRY(gather_wsum_f32, float)
#undef PTT_WSUM_ENTRY

// src [B, N, D]; idx, scale [B, M]; other, out [B, M, D], in the entry
// point's type (gather_scale_dot_bf16, _f16, _f32); dot [B, M] f32.
// Returns the launch's cudaError_t (0 on success).
#define PTT_SDOT_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* src, const void* idx, const void* scale,  \
                      const void* other, void* out, void* dot, int B,       \
                      int N, int M, int D, void* stream) {                  \
    return scale_dot<T>(src, idx, scale, other, out, dot, B, N, M, D,       \
                        stream);                                            \
  }
PTT_SDOT_ENTRY(gather_scale_dot_bf16, bf16)
PTT_SDOT_ENTRY(gather_scale_dot_f16, f16)
PTT_SDOT_ENTRY(gather_scale_dot_f32, float)
#undef PTT_SDOT_ENTRY

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
