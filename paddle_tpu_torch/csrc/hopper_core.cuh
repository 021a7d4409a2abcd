// Shared core of the port's Hopper tensor-core kernels (flash_fwd.cu,
// flash_bwd.cu, gather_mlp.cu): TMA tensor-map loads and stores of
// 128-byte-swizzled shared tiles, mbarrier rings between producer and
// consumer warpgroups (fed by TMA, or by cp.async with an mbarrier
// arrival), setmaxnreg, and wgmma with its shared-memory matrix
// descriptors; ragged_paged_attention.cu also takes its smem_u32 and
// allow_smem. attention_core.cuh holds the mma.sync fragments.
//
// Element types. The operands are bf16 or f16 (flash_fwd.cu and
// flash_bwd.cu instantiate both; T names the type): the two share the
// tiles, the swizzle and the descriptors below, and differ only in the
// wgmma instruction's input type, the TMA map's element type (tma_type)
// and the rounding of P and dS into A fragments (pack2). flash_f32.cu
// takes f32 operands on the same TMA maps and swizzle: a 128-byte row
// holds row_elems<T>() values (64 of 16 bits, 32 floats), so a head_dim
// row takes chunks_of<T>(hd) chunks and the box is that many columns.
//
// Tiles. Every 16-bit operand tile holds R rows of head_dim in chunks of 64
// columns: chunk c is an [R][64] array of 128-byte rows, 1024-byte
// aligned, laid out as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it (the
// 16-byte groups of row r XOR-ed with r % 8). One TMA box is 64 columns x
// 64 rows (8 KB); a tile of R rows per chunk takes R / 64 boxes. A
// head_dim of 72 takes two chunks: the second box starts at column 64
// and TMA zero-fills its columns 72..127, which lie past the tensor's
// innermost extent, so no copy pads q/k/v (a 144-byte row fits no
// swizzle mode whole; the zero columns cost shared memory, not device
// bytes).
//
// wgmma operands (PTX ISA, matrix descriptors; CUTLASS's GmmaDescriptor
// has the same fields):
//   K-major (the contraction runs along the 64-column rows): a k16 step
//     is 32 bytes of a row, so step ks starts at chunk ks / 4, byte
//     (ks % 4) * 32; 8-row groups are 1024 bytes apart (SBO).
//   MN-major (the contraction runs down the rows, the transpose bit):
//     a k16 step is 16 rows, 2048 bytes; 8-row groups 1024 bytes apart
//     (SBO), the 64-column chunks of N `chunk_bytes` apart (LBO).
// Accumulator of m64nN (f32, per thread of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j + e] is row 16 * warp + g + 8 * (e / 2), column
// 8j + 2t + (e % 2). The A fragment of m64k16 from registers is the
// mma.m16n8k16 one: a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..), so the accumulators of n-tiles 2k, 2k+1 re-pack
// into the A fragment of k-step k.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled
                    // comes from cudaGetDriverEntryPoint: no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr int kBox = 64;                      // box: 64 columns x 64 rows
constexpr int kBoxBytes = kBox * kBox * 2;    // 8 KB
constexpr int kRowBytes = kBox * 2;           // one swizzled row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 64-column chunks of a head_dim row; k16 steps of a contraction over it
__host__ __device__ constexpr int chunks(int hd) { return (hd + kBox - 1) / kBox; }
__host__ __device__ constexpr int k_steps(int hd) { return (hd + 15) / 16; }

// Values of T in one 128-byte swizzled row (a box's and a chunk's
// columns), and the chunks of a head_dim row of T
template <class T>
__host__ __device__ constexpr int row_elems() {
  return kRowBytes / (int)sizeof(T);
}
template <class T>
__host__ __device__ constexpr int chunks_of(int hd) {
  return (hd + row_elems<T>() - 1) / row_elems<T>();
}
static_assert(row_elems<bf16>() == kBox && chunks_of<f16>(72) == chunks(72),
              "16-bit chunks are the 64-column ones");
static_assert(row_elems<float>() == 32 && chunks_of<float>(72) == 3,
              "an f32 chunk is 32 columns: hd 72 takes three");

// Element strides of a [batch, seq, head, head_dim] tensor (either
// layout; head_dim stride 1), for the epilogues' stores.
struct Strides {
  long long b, s, h;
  __device__ __forceinline__ size_t at(int bi, int si, int hi) const {
    return (size_t)(bi * b + si * s + hi * h);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 2^x on the special-function unit (~2 ulp; 0 for x below -126 - 24)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values rounded to T (bf16 or f16, round to nearest even) and
// packed low, high into 32 bits
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  return pack_f16(lo, hi);
}

// Two consecutive 16-bit values of type T (bf16 or f16) as f32
template <class T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<f16>(const f16* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// The tensor-map element type of T
template <class T>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<bf16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<f16>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// wait until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// A ring position: stage and the parity of its current round.
template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ----------------------------------------------------------------- TMA
// One box of a 4-d tensor map (head_dim, seq, head, batch) at
// coordinates (c0..c3) into dst, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint64_t* bar, void* dst, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the `threads` threads (whole warps) that name barrier `id` (1..15)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of a 4-d tensor map from shared memory at src to coordinates
// (c0..c3), in a bulk group of the issuing thread; TMA writes only the
// part inside the tensor's extents. The source must be visible to the
// async proxy first (fence_proxy_async after generic-proxy writes).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until all of the thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders the thread's view of shared memory written in the generic proxy
// (st.shared, cp.async) before its later async-proxy reads (wgmma
// operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------- cp.async into rings
// 16 bytes from src to dst, of which the first src_bytes are read and the
// rest zero-filled (src_bytes 0: no read, 16 zeros); L1 bypassed.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
// one arrival on `bar` once every cp.async the thread issued before it
// has landed; the arrival is one of the count the barrier was set up for
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned ends) from global to shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
      "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ----------------------------------------------- registers and wgmma
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// until at most N committed groups of the warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching wgmma's registers across the
// asynchronous span: each is "rewritten" here, after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// shared-memory matrix descriptors, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr,
                                            uint32_t chunk_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((chunk_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// k16 step ks of a K-major tile of `rows` rows per chunk
__device__ __forceinline__ uint32_t k_step_addr(uint32_t base, int rows,
                                                int ks) {
  return base + (ks / 4) * rows * kRowBytes + (ks % 4) * 32;
}

// wgmma.mma_async m64nNk16, bf16 or f16 in (T), f32 accumulate: the
// specializations are wgmma_ops.cuh's, once per input type
template <int N, class T = bf16>
struct Wgmma;

#define HOP_WG_T bf16
#define HOP_WG_TY "bf16"
#include "wgmma_ops.cuh"
#undef HOP_WG_T
#undef HOP_WG_TY
#define HOP_WG_T f16
#define HOP_WG_TY "f16"
#include "wgmma_ops.cuh"
#undef HOP_WG_T
#undef HOP_WG_TY

// P (or dS) from an m64nN accumulator, rounded to T (bf16 or f16), as
// the A fragments of the N / 16 k16 steps of the next product
template <int N, class T = bf16>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[k][0] = pack2<T>(s[8 * k + 0], s[8 * k + 1]);
    a[k][1] = pack2<T>(s[8 * k + 2], s[8 * k + 3]);
    a[k][2] = pack2<T>(s[8 * k + 4], s[8 * k + 5]);
    a[k][3] = pack2<T>(s[8 * k + 6], s[8 * k + 7]);
  }
}

// Which of a row's first n_tiles key tiles of BN keys a block walks:
// state[t] = 0 (no key visible: not walked), 1 (some key masked or past
// Sk: the per-element test) or 2 (every key present and visible: no
// test). mrow: the batch row's uint8 key mask. All warps of the block.
template <int BN>
__device__ __forceinline__ void scan_key_tiles(const unsigned char* mrow,
                                               int Sk, int n_tiles,
                                               unsigned char* state) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x / 32;
  for (int t = warp; t < n_tiles; t += n_warps) {
    bool any = false, all = true;
    for (int j = lane; j < BN; j += 32) {
      const int key = t * BN + j;
      const bool v = key < Sk && mrow[key] != 0;
      any = any || v;
      all = all && v;
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) state[t] = any ? (all ? 2 : 1) : 0;
  }
}

// Key tiles 0..n-1 of BN keys that rows m0..m0+BM-1 may see: all of Sk,
// or, causal (bottom-right: key j <= i + Sk - Sq), up to the last row's
// diagonal. kernels/flash_attention.py::key_tiles is the same rule.
__host__ __device__ __forceinline__ int key_tiles(int m0, int BM, int BN,
                                                  int Sq, int Sk,
                                                  int causal) {
  int last = Sk - 1;
  const int diag = m0 + BM - 1 + Sk - Sq;
  if (causal && diag < last) last = diag;
  return last < 0 ? 0 : last / BN + 1;
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The tensor map of a tensor of `type` (bf16 unless it says f16 or f32)
// from `d`, seven int64 the wrapper computes
// (kernels/flash_attention.py::tma_dims): extents (head_dim, seq, heads,
// batch) and the byte strides of seq, head and batch; box box_cols x
// box_rows x 1 x 1 (64 x 64 for 16-bit types; box_cols * the element
// size must be the 128-byte swizzle row), 128-byte swizzle, zero fill out
// of bounds. Returns false when cuTensorMapEncodeTiled refuses it.
inline bool encode_map(CUtensorMap* map, const void* base,
                       const long long* d,
                       CUtensorMapDataType type =
                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       int box_cols = kBox, int box_rows = kBox) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d[0], (cuuint64_t)d[1],
                        (cuuint64_t)d[2], (cuuint64_t)d[3]};
  cuuint64_t strides[3] = {(cuuint64_t)d[4], (cuuint64_t)d[5],
                           (cuuint64_t)d[6]};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute is raised once per kernel and device to the
// largest size asked so far (`granted`: the kernel's own table), so a
// launch makes no cudaFuncSetAttribute call after the first.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&granted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) granted[dev] = bytes;
  return err;
}

// dynamic shared memory, rounded up to 1024 bytes (the swizzle's period)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace hop
