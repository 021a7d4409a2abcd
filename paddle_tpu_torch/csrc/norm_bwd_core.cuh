// Shared core of the three norm backward kernels (rms_norm.cu's
// rms_bwd_kernel, layer_norm.cu's ln_bwd_kernel, adaln.cu's
// adaln_bwd_kernel): the row walk of a persistent grid of warp teams fed
// by a cp.async ring, the block's fixed-order combine of its teams'
// column sums into one partial row, and the fold of the partial rows into
// dw (and db; adaLN's per-sample dscale and dshift). The RMSNorm and
// LayerNorm grids split all rows among their teams (walk); the adaLN grid
// walks (sample, segment) ranges, one partial row each (walk_range), so
// no range spans two samples' weights or sums.
//
// The walk. A block is 256 threads; a row is owned by a team of WPR warps
// (1, 2, 4 or 8), whose lanes hold VPT 16-byte vectors of it (lane t
// vectors t, t + 32 WPR, ...; 8-byte vectors where a row is not a whole
// number of 16-byte ones), so a lane keeps at most 32 values of a row
// and its dw/db column sums for the block's life in f32 registers. Team g
// of the grid walks the rows [g * rows / teams, (g + 1) * rows / teams).
// Each row's x and dy vectors, and its statistics (rstd; mu and rstd),
// land in a three-stage shared-memory ring by cp.async, issued two rows
// ahead, so a team has two rows in flight while it computes a third. Each
// lane reads back only the vectors it copied itself: cp.async.wait_group
// makes a thread's own copies visible to it, so the ring needs no barrier
// between lanes, and a stage is refilled only after the lane's last read
// of it fed a store. (A 1-D bulk copy would fill a row with one
// instruction, but every lane of the team would then track the mbarrier's
// phase, and a stage could be refilled only after a barrier of the whole
// team had released it.) A row is read twice from the ring: the first
// pass forms the lane's part of the row sums, which warp shuffles and, for
// a team of several warps, a named barrier over just that team's threads
// (double-buffered by row parity) turn into the row's totals; the second
// pass writes dx. No block-wide barrier is taken per row.
//
// The column sums. When its rows are done, each lane stores its sums into
// its own slots of its team's ring; after one block barrier the block adds
// its teams' sums in team order and writes one f32 partial row, so there
// are as many partial rows as blocks. The fold kernel, a programmatic
// dependent launch, sums them: a block of 256 threads takes `cols`
// columns, each column cut into 256 / cols fixed segments of the partial
// rows, each segment summed in row order, then the segments in order. No
// float atomics: the order depends on the plan alone, so two runs give
// identical bits. The plan (team shape, grid, fold widths) is computed on
// the host from the shapes (kernels/norm_bwd.py::bwd_plan), so every
// launch can be captured in a CUDA graph.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nbw {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;       // a walk block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // ring depth: two rows ahead
constexpr int kFoldThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, bypassing L1 (each vector is read once)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
// 8 bytes (an 8-byte slot: rows that are whole 8-byte, not 16-byte,
// multiples)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The VB-byte slot a lane copies and reads back: a 16-byte vector, or an
// 8-byte one where rows are not whole 16-byte multiples (bf16 rows of D %
// 8 == 4 values).
template <int VB>
struct Slot;
template <>
struct Slot<16> {
  typedef uint4 type;
  __device__ __forceinline__ static void copy(void* dst, const void* src) {
    cp_async16(dst, src);
  }
};
template <>
struct Slot<8> {
  typedef uint2 type;
  __device__ __forceinline__ static void copy(void* dst, const void* src) {
    cp_async8(dst, src);
  }
};

// The kN values of one VB-byte vector, as f32.
template <typename T, int VB = 16>
struct Vec;

template <>
struct Vec<float, 16> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<bf16, 16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Vec<bf16, 8> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint2& u,
                                                float (&f)[4]) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ __forceinline__ static uint2 pack(const float (&f)[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<uint32_t*>(&a),
                      *reinterpret_cast<uint32_t*>(&b));
  }
};

// f16 rows (layer_norm.cu's ln_bwd_f16): 16-byte vectors only, since
// the LayerNorm takes D a multiple of 8
template <>
struct Vec<__half, 16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __half22float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Shared memory of one walk block: per team, the ring's data, VB-byte
// slots [kStages][2][kSlots] (x, then dy; a lane's vector v of a row sits
// in slot v), then its statistics, f32 [kStages][NST][kTPR] (a lane's own
// copy in column t).
template <typename T, int WPR, int VPT, int NST, int VB = 16>
struct Layout {
  static constexpr int kN = Vec<T, VB>::kN;
  static constexpr int kTPR = 32 * WPR;            // threads a team
  static constexpr int kTeams = kThreads / kTPR;
  static constexpr int kSlots = VPT * kTPR;        // vectors of a row
  static constexpr int kDataBytes = kStages * 2 * kSlots * VB;
  static constexpr int kTeamBytes = kDataBytes + kStages * NST * kTPR * 4;
  static constexpr int kBytes = kTeams * kTeamBytes;
};

// The NSUM row sums of a team: warp shuffles, then, for a team of several
// warps, the warps' totals through shared memory under the team's own
// named barrier (1 + team; 0 is __syncthreads'). `red` is this row's
// half of a buffer double-buffered by row parity: a warp can write the
// next row's half while a slower one still reads this one, and cannot
// reach the row after before that one has passed the next barrier.
template <int WPR, int NSUM>
__device__ __forceinline__ void team_sum(float (&s)[NSUM],
                                         float (*red)[NSUM], int warp,
                                         int lane, int team) {
#pragma unroll
  for (int k = 0; k < NSUM; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  if constexpr (WPR > 1) {
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < NSUM; ++k) red[warp][k] = s[k];
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + team), "r"(32 * WPR)
                 : "memory");
#pragma unroll
    for (int k = 0; k < NSUM; ++k) {
      s[k] = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) s[k] += red[team * WPR + i][k];
    }
  }
}

// One walk block's work over rows [row0, row0 + rows), which n_teams teams
// share, this block's teams being team0, team0 + 1, ...: the teams walk
// their rows, then the block writes its partial row prow() (f32 [NACC *
// D]: accumulator a's column c at a * D + c; asked for only then, so its
// address holds no register through the walk). For each row, with st its NST
// statistics:
//   first(i, st, x, dy, s)      adds the lane's vector i to its NSUM sums
//   second(i, st, s, x, dy, o)  with s the row's totals: o = dx's vector i
// acc[a][i][j] are the lane's column sums (the lambdas add to them). A
// block that walks several ranges (one per call) takes a __syncthreads()
// between calls: the partial row reads the ring that the next call's
// copies refill.
template <typename T, int WPR, int VPT, int NSUM, int NST, int NACC,
          int VB = 16, class Prow, class First, class Second>
__device__ __forceinline__ void walk_range(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    const float* const (&stat)[NST], Prow prow, int row0, int rows,
    int team0, int n_teams, int D,
    float (&acc)[NACC][VPT][Vec<T, VB>::kN], First first, Second second) {
  using L = Layout<T, WPR, VPT, NST, VB>;
  using S = typename Slot<VB>::type;
  constexpr int kN = L::kN;
  constexpr int kFS = VB / 4;                  // f32 sums a slot holds
  static_assert(NACC * kN / kFS <= 2 * kStages,
                "a lane's column sums fit in its own ring slots");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kWarps][NSUM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / WPR, t = threadIdx.x % L::kTPR;
  S* data = reinterpret_cast<S*>(smem + team * L::kTeamBytes);
  float* stats = reinterpret_cast<float*>(smem + team * L::kTeamBytes +
                                          L::kDataBytes);
  const int nvec = D / kN;
  const int g = team0 + team;
  const int lo = row0 + (int)((long long)g * rows / n_teams);
  const int hi = row0 + (int)((long long)(g + 1) * rows / n_teams);

  // row `row`'s vectors and statistics into ring stage `stage`; one
  // commit group per call, empty past the team's rows
  auto issue = [&](int row, int stage) {
    if (row < hi) {
      const S* xs = reinterpret_cast<const S*>(x + (size_t)row * D);
      const S* ds = reinterpret_cast<const S*>(dy + (size_t)row * D);
      S* sx = data + stage * 2 * L::kSlots;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = t + i * L::kTPR;
        if (v < nvec) {
          Slot<VB>::copy(sx + v, xs + v);
          Slot<VB>::copy(sx + L::kSlots + v, ds + v);
        }
      }
#pragma unroll
      for (int k = 0; k < NST; ++k)
        cp_async4(stats + (stage * NST + k) * L::kTPR + t, stat[k] + row);
    }
    cp_async_commit();
  };

  issue(lo, 0);
  issue(lo + 1, 1);
  int stage = 0, parity = 0;
  for (int row = lo; row < hi; ++row) {
    issue(row + 2, stage == 0 ? kStages - 1 : stage - 1);
    cp_async_wait<kStages - 1>();             // this row's group landed
    const S* sx = data + stage * 2 * L::kSlots;
    float st[NST];
#pragma unroll
    for (int k = 0; k < NST; ++k)
      st[k] = stats[(stage * NST + k) * L::kTPR + t];
    float s[NSUM];
#pragma unroll
    for (int k = 0; k < NSUM; ++k) s[k] = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * L::kTPR;
      if (v < nvec) {
        float xv[kN], dv[kN];
        Vec<T, VB>::unpack(sx[v], xv);
        Vec<T, VB>::unpack(sx[L::kSlots + v], dv);
        first(i, st, xv, dv, s);
      }
    }
    team_sum<WPR, NSUM>(s, red[parity], warp, lane, team);
    S* orow = reinterpret_cast<S*>(dx + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * L::kTPR;
      if (v < nvec) {
        float xv[kN], dv[kN], o[kN];
        Vec<T, VB>::unpack(sx[v], xv);
        Vec<T, VB>::unpack(sx[L::kSlots + v], dv);
        second(i, st, s, xv, dv, o);
        orow[v] = Vec<T, VB>::pack(o);
      }
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
    parity ^= 1;
  }
  cp_async_wait<0>();
  // the fold may launch now; it waits for this grid's partial rows
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the lane's sums of vector v into its own slots v of the team's ring
  // (kFS columns a slot: accumulator a's part q in slot plane a*kN/kFS + q)
  float* planes = reinterpret_cast<float*>(data);
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * L::kTPR;
      if (v < nvec)
#pragma unroll
        for (int q = 0; q < kN / kFS; ++q) {
          float* slot = planes + ((a * (kN / kFS) + q) * L::kSlots + v) * kFS;
          if constexpr (kFS == 4)
            *reinterpret_cast<float4*>(slot) = make_float4(
                acc[a][i][4 * q], acc[a][i][4 * q + 1], acc[a][i][4 * q + 2],
                acc[a][i][4 * q + 3]);
          else
            *reinterpret_cast<float2*>(slot) =
                make_float2(acc[a][i][2 * q], acc[a][i][2 * q + 1]);
        }
    }
  __syncthreads();
  // the block's partial row: its teams' sums added in team order
  const int C = NACC * D;
  float* out = prow();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int a = c / D, col = c - a * D;
    const int off = ((a * (kN / kFS) + (col % kN) / kFS) * L::kSlots
                     + col / kN) * kFS + col % kFS;
    float sum = 0.f;
#pragma unroll
    for (int tm = 0; tm < L::kTeams; ++tm)
      sum += reinterpret_cast<const float*>(smem + tm * L::kTeamBytes)[off];
    out[c] = sum;
  }
}

// The walk of a persistent grid over all `rows` rows: team g of the grid
// (block g / kTeams) walks [g * rows / n_teams, (g + 1) * rows / n_teams),
// and block b writes partial row b of partials (f32 [gridDim.x, NACC * D]).
template <typename T, int WPR, int VPT, int NSUM, int NST, int NACC,
          class First, class Second>
__device__ __forceinline__ void walk(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    const float* const (&stat)[NST], float* __restrict__ partials, int rows,
    int D, int n_teams, float (&acc)[NACC][VPT][Vec<T>::kN], First first,
    Second second) {
  walk_range<T, WPR, VPT, NSUM, NST, NACC>(
      x, dy, dx, stat,
      [&]() { return partials + (size_t)blockIdx.x * NACC * D; }, 0, rows,
      blockIdx.x * Layout<T, WPR, VPT, NST>::kTeams, n_teams, D, acc, first,
      second);
}

// The fold of C columns, column c holding n partial values at
// partials[base + p * stride], p = 0..n-1, where parts(c, n, base,
// stride) says which: column c's sum goes to put(c, value). A block of
// kFoldThreads takes `cols` columns, each cut into kFoldThreads / cols
// fixed segments of its parts, a segment summed in part order, then the
// segments in order. A programmatic dependent of the walk: it waits for
// the walk's grid before reading (a no-op when launched plainly).
template <class Parts, class Put>
__device__ __forceinline__ void fold_parts(const float* __restrict__ partials,
                                           int C, int cols, Parts parts,
                                           Put put) {
  __shared__ float seg_sum[kFoldThreads];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int segs = kFoldThreads / cols;
  const int col = threadIdx.x % cols, seg = threadIdx.x / cols;
  const int c = blockIdx.x * cols + col;
  float s = 0.f;
  if (c < C) {
    int n;
    size_t base, stride;
    parts(c, n, base, stride);
    const int p0 = (int)((long long)seg * n / segs);
    const int p1 = (int)((long long)(seg + 1) * n / segs);
#pragma unroll 4
    for (int p = p0; p < p1; ++p) s += partials[base + (size_t)p * stride];
  }
  seg_sum[threadIdx.x] = s;
  __syncthreads();
  if (seg == 0 && c < C) {
    float total = 0.f;
    for (int k = 0; k < segs; ++k) total += seg_sum[k * cols + col];
    put(c, total);
  }
}

// The fold of n_parts partial rows of C columns (every column's parts).
template <class Put>
__device__ __forceinline__ void fold(const float* __restrict__ partials,
                                     int n_parts, int C, int cols,
                                     Put put) {
  fold_parts(partials, C, cols,
             [&](int c, int& n, size_t& base, size_t& stride) {
               n = n_parts;
               base = c;
               stride = C;
             },
             put);
}

// ---------------------------------------------------------------- host
// Calls f(WPR, VPT) (std::integral_constant arguments) for an
// instantiated team shape: one warp with a VPT of kOneWarp, or 2, 4 or 8
// warps with VMAX vectors a lane; cudaErrorInvalidValue for any other.
template <int VMAX, class F>
cudaError_t dispatch(int warps, int vpt, F&& f) {
  using std::integral_constant;
  if (warps == 1) {
    switch (vpt) {
      case 1: return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
      case 2: return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
      case 4: return f(integral_constant<int, 1>{}, integral_constant<int, 4>{});
      case 6:
        if constexpr (VMAX == 8)
          return f(integral_constant<int, 1>{}, integral_constant<int, 6>{});
        break;
      case 8:
        if constexpr (VMAX == 8)
          return f(integral_constant<int, 1>{}, integral_constant<int, 8>{});
        break;
    }
    return cudaErrorInvalidValue;
  }
  if (vpt != VMAX) return cudaErrorInvalidValue;
  switch (warps) {
    case 2: return f(integral_constant<int, 2>{}, integral_constant<int, VMAX>{});
    case 4: return f(integral_constant<int, 4>{}, integral_constant<int, VMAX>{});
    case 8: return f(integral_constant<int, 8>{}, integral_constant<int, VMAX>{});
  }
  return cudaErrorInvalidValue;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device (asked once per device: `granted` is the kernel's own table).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&granted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) granted[dev] = bytes;
  return err;
}

// Blocks of `kernel` (kThreads threads, `bytes` of dynamic shared memory)
// that fit on one multiprocessor at once.
template <class Kernel>
inline cudaError_t resident(Kernel kernel, int bytes, int (&granted)[64],
                            int* per_sm) {
  cudaError_t err = allow_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, bytes);
}

// The fold as a programmatic dependent launch of the walk just enqueued
// on `s`: its blocks are scheduled as the walk's finish, and wait for it.
template <class Kernel, class... Args>
inline cudaError_t launch_fold(Kernel kernel, int C, int cols,
                               cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + cols - 1) / cols);
  cfg.blockDim = dim3(kFoldThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace nbw
