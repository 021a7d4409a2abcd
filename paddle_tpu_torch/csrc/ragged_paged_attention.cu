// Ragged paged attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/nlp/ragged_attention.py::_rpa_kernel (pallas_call
// in ragged_paged_attention) with both of its compiled options: every
// decode row, every fused prefill+decode batch and every chunked-prefill
// continuation of the serving path, over an fp pool or an int8 one
// (`quantized=True`: int8 K/V codes with one f32 scale per pool block),
// and the speculative draft and verify's suffix slab (`suffix=True`: K/V
// rows that exist only in the caller's slab, folded into the same
// softmax as one more chunk).
//
// Computes, for each row r and query p: query head h of q[r, p] attends to
// the chain keys j <= positions[r, p] of KV head h / (H / KV), where chain
// key j lives at pool block table[r, j / bs], slot j % bs, and, with a
// slab, to the slab rows s of suffix_k/v[r] with suffix_vis[r, p, s] set;
// one softmax runs over both. Invalid queries (valid[r, p] == 0) write
// zeros. q [R, P, H, hd], pools [N, bs, KV, hd] (one layer) in q's type T
// or int8 with k_scale/v_scale [N] f32 (code x scale is the value), slab
// [R, S, KV, hd] in T (S <= 64), suffix_vis [R, P, S] one byte each, out
// [R, P, H, hd] in T; table, positions int32; valid one byte per query.
// T is bf16, f16 or f32 (ragged_paged_attention_bf16, _f16, _f32): the
// TPU kernel computes in the pools' dtype.
// The pool write of the same call happens before this kernel
// (nlp/paged.py::_attention_paged), so a cold row sees its own keys.
//
// Bound on the H100: memory. Each (row, KV head) reads its live K and V
// once, bs * hd * sizeof(T) bytes per block each (bs * hd int8 codes and
// a 4-byte scale from an int8 pool), for ~4 * rep flops a 16-bit byte
// (8 * rep int8, 2 * rep f32), far below the ~295 flop/byte ridge of the
// tensor cores (f32: ~49 at the TF32 rate over its three parts, ~20 on
// FFMA); a decode step of 8 rows of 1024
// keys at Llama-3-8B widths moves 33.5 MB (16-bit), 67.1 MB (f32) or 16.8
// MB (int8), 0.010, 0.020 or 0.005 ms at 3.35 TB/s. The slab adds
// S * hd * sizeof(T) bytes of K and V a (row, KV head), at most 64 rows. The TPU kernel reads only the LIVE
// chain instead of gathering the table's full width, and so does this
// one. What the card needs beyond that is enough bytes in flight: a
// decode step has only R * KV (row, KV head) pairs.
//
// Design.
//  * The chain is split across blocks. The grid is (row, KV head, query
//    tile x key split); a split is `split_keys` chain keys, a multiple of
//    the 64-key stage, fixed per call from the shapes alone by the host's
//    plan (nlp/ragged_attention.py::split_plan) so that the grid fills the
//    card and the call stays capturable in a CUDA graph. A block reads
//    the keys [s * split_keys, min((s + 1) * split_keys, live)), live being
//    one past the largest valid position of its tile; a split past live
//    exits at once, and a tile with no valid query reads no K/V.
//  * The slab is the last split of each (row, KV head, tile): one stage of
//    up to 64 slab rows, folded by the same code with the visibility bits
//    of each query (a 64-bit mask a row) in place of the causal limit, as
//    the TPU kernel folds it at its extra chunk c == nchunks.
//  * The query tile is sized to the work. A narrow tile (P * rep <= 16:
//    decode, a draft step) is one GQA group of 16 / rep positions, 16 rows
//    (the mma M); its 4 warps take a quarter of the keys of every stage
//    each and are merged through shared memory at the end. A wide tile
//    (chunked and fused prefill, the verify's k + 1 or tree rows) is 64
//    rows, 16 a warp, each warp taking all the keys of a stage.
//  * The copies are pipelined: a ring of 3 (hd 128) or 4 (hd 64) stages
//    of 64 keys of K and V (4 or 6 of int8 codes; f32: stages of 32 keys,
//    3 in a narrow tile and 2 in a wide one at hd 128, 4 at hd 64: Ring),
//    filled with cp.async (16-byte LDGSTS, which
//    suits the pool's 256- or 128-byte 16-bit rows, 512- or 256-byte f32
//    ones and 128- or 64-byte int8 rows; zero-filled past the split), so
//    all but one stage are in flight while that one's products run. A split's table entries, and an
//    int8 pool's two scales a block, are read into shared memory once,
//    before the ring starts.
//  * int8 pools. A landed stage's codes are widened to T into one
//    staging stage (|code| <= 127 is exact in bf16, f16 and f32), and the
//    fragment
//    path runs unchanged on them; in a narrow tile each warp widens only
//    the 16 keys it folds (no block barrier), in a wide one the block
//    widens the stage together; each key's K scale multiplies its f32
//    score column after the product and its V scale the probability
//    column before P.V (the row sum takes the unscaled probabilities), so
//    no dequantized value is rounded to T. A block of scale 0 gives
//    exact zeros, as its dequantized codes do.
//  * Outputs. Without a slab, a query whose visible keys all lie in split
//    0 gets its final output (in T) from split 0, as does an invalid query
//    (zeros). Any other query gets, from each split holding some of its
//    keys, an f32 partial: O unnormalised, the running max in log2 units
//    and the sum. With a slab every valid query has keys in the slab, so
//    every valid query gets partials, the slab's last, and the merge
//    writes every output row (zeros for invalid queries). Then
//    ragged_merge_kernel folds each query's partials in split order, the
//    slab's last. No atomics: two runs give identical bits.
//  * Products: bf16 and f16 on mma.sync m16n8k16 (attention_core.cuh),
//    V's B fragments by ldmatrix.trans (b16 serves both); online softmax
//    in f32. The work is memory bound, and wgmma's M of 64 would be
//    mostly padding in decode (the f32 option's reason too).
//  * f32 on mma.sync m16n8k8 TF32 in three parts (hi hi + hi lo + lo hi,
//    hi = x with its low 13 bits dropped, lo = x - hi): the plain version
//    computes in full f32,
//    and the bound (RAGGED_F32_TOL 2e-5 of each output vector's scale,
//    chip_smoke.py) leaves no room for one TF32 part (2^-11 relative a
//    term). Both products take three parts; each k8 step's parts go into
//    a fresh tile that is added to the f32 sum on the CUDA cores, because
//    the tensor core rounds its sum toward zero into the accumulator and a
//    1024-key chain of 128 such steps would drift by ~1.5e-5 of the scale.
//    The tiles and lanes are the 16-bit options' (C-fragment elements row
//    g or g + 8, key or column 2t, 2t + 1 of each n8 tile), so the softmax
//    and the outputs are shared. Q K^T reads the tile's Q rows (staged in
//    shared memory once) and K's rows, and P V takes P's A fragment from
//    its score accumulators as they are (the contraction over an n8
//    tile's keys permuted: k = t <-> key 2t, k = t + 4 <-> key 2t + 1)
//    against V's rows; every value is split in registers as a lane loads
//    it, in both tile kinds: in a narrow tile each value is loaded by one
//    lane of one warp, and in a wide one the four warps' loads and splits
//    cost less shared-memory traffic than writing split planes once and
//    reading two parts back. All fragment loads are 32-bit and
//    conflict-free with rows of HD + 4 floats. Widened int8 codes are
//    exact in TF32 (|c| <= 127), so their products take two parts (q's or
//    P's hi and lo against the codes). What holds it (H100 SXM at 700 W,
//    PERF.md §6): mma.sync's TF32 rate, about one m16n8k8 per 28 cycles
//    a sub-partition whatever their order, three a product; a wide
//    tile's 64 rows would fit wgmma's M, at several times that rate, but
//    its B operands must be K-major swizzled tiles (V transposed), which
//    this ring's padded rows are not.
#include "attention_core.cuh"
#include "hopper_core.cuh"

namespace {

using ptt::bf16;
using ptt::f16;
using ptt::kNegInf;

constexpr int kThreads = 128;     // 4 warps
constexpr int kStageKeys = 64;    // keys of K and of V per ring stage
constexpr int kMaxSlab = 64;      // slab rows: one stage

// Values of element type T in one 16-byte copy; a staged K or V row is
// HD + kVec of them, so the 8 rows of a fragment load or of an ldmatrix
// start 4 banks apart.
template <class T>
struct Elem {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr bool kF32 = sizeof(T) == 4;
};

// The ring of staged K and V, in T. An int8 pool's ring holds the codes
// (rows of HD bytes), plus one T staging stage they are widened into,
// plus each ring stage's per-key K and V scales; its stages are half the
// bytes of a 16-bit one, so it runs one (hd 128) or two (hd 64) more of
// them in about the shared memory of the 16-bit ring (two blocks still
// fit a multiprocessor). An f32 stage holds 32 keys (kKeys), half a
// 16-bit one's, so that its bytes are a 16-bit stage's and two blocks
// still fit a multiprocessor at hd 128 beside the tile's staged Q rows
// (kQNarrow or kQWide bytes: f32 only, HD + 4 floats a row): 3 stages in
// a narrow tile, 2 in a wide one (with 64-key stages one block fit, and
// its four warps alone could not keep the pool's bytes in flight: full
// chains of 32 decode rows ran at 42 % of their byte bound, bf16 at 78
// %). A narrow tile over an int8 pool keeps 64-key stages (one block a
// multiprocessor): its short decode walks paid more for twice the
// stages' fixed costs than they gained (0.023 -> 0.032 ms at the decode
// batch). The slab's split takes one 64-row stage of T: the ring's first
// stage, the int8 ring's staging stage, or, f32, the ring from its start
// (kRingBytes leaves it room).
template <int HD, bool Q8, class T, bool NARROW>
struct Ring {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  static constexpr bool kF32 = Elem<T>::kF32;
  static constexpr int kRow = HD + Elem<T>::kVec;
  static constexpr int kKeys =                            // keys a stage
      kF32 && !(Q8 && NARROW) ? 32 : kStageKeys;
  static constexpr int kStages =
      kF32 ? (HD == 128 ? (Q8 ? 4 : (NARROW ? 3 : 2)) : (Q8 ? 6 : 4))
           : (HD == 128 ? (Q8 ? 4 : 3) : (Q8 ? 6 : 4));
  static constexpr int kStage = 2 * kKeys * kRow;   // K, then V
  static constexpr int kStageBytes = kStage * (int)sizeof(T);
  static constexpr int kCodeStage = 2 * kKeys * HD;  // int8 bytes
  static constexpr int kWalkBytes =
      Q8 ? kStages * kCodeStage + kStageBytes : kStages * kStageBytes;
  static constexpr int kSlabBytes = 2 * kMaxSlab * kRow * (int)sizeof(T);
  static constexpr int kRingBytes =
      kF32 && kSlabBytes > kWalkBytes ? kSlabBytes : kWalkBytes;
  static constexpr int kScaleBytes =
      Q8 ? kStages * 2 * kKeys * (int)sizeof(float) : 0;
  static constexpr int kBytes = kRingBytes + kScaleBytes;
  static constexpr int kQRow = HD + 4;
  static constexpr int kQNarrow = kF32 ? 16 * kQRow * (int)sizeof(float) : 0;
  static constexpr int kQWide = kF32 ? 64 * kQRow * (int)sizeof(float) : 0;
};

// 16 bytes from device to shared memory, asynchronously; zeros if !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hop::smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 16-bit matrices, transposed; lane l gives the address of row
// l % 8 of matrix l / 8, and r[i] holds matrix i's B fragment half.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hop::smem_u32(p))
      : "memory");
}

// Four int8 codes widened exactly (|code| <= 127), without the
// quarter-rate int-to-float converts: code c's byte with its sign bit
// flipped is c + 128, placed as the low byte of the f32 2^23 (exponent
// byte 0x4B) it reads 2^23 + 128 + c, and one subtraction leaves c. As
// two packed pairs of a 16-bit T, or as four floats.
template <class T>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;       // 2^23 + 128
  const float c0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float c1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float c2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float c3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  return make_uint2(ptt::Mma<T>::pack(c0 - kMagic, c1 - kMagic),
                    ptt::Mma<T>::pack(c2 - kMagic, c3 - kMagic));
}

__device__ __forceinline__ float4 widen4_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;       // 2^23 + 128
  return make_float4(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - kMagic,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - kMagic,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - kMagic,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - kMagic);
}

// The hi TF32 part of an f32 value: x with its low 13 bits dropped, as
// the tensor core reads an f32 operand (one mask; rounding to nearest
// would take an add more, and the hi and lo parts sum to x either way)
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xFFFFE000u;
}

// Four f32 values as TF32 parts: hi = tf32_hi(x), lo = x - hi (exact in
// f32, < 2^-10 of x; the tensor core drops lo's low 13 bits as it reads
// it, ~2^-20 of x)
__device__ __forceinline__ void split4(float x0, float x1, float x2,
                                       float x3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_hi(x[e]);
    lo[e] = __float_as_uint(x[e] - __uint_as_float(hi[e]));
  }
}

// c += A B over one k8 step on mma.sync m16n8k8, f32 += tf32 x tf32. A
// (m16k8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t +
// 4); B (k8n8, col): b0 (t, g), b1 (t + 4, g); C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment values (b0, b1) of one n8 tile as TF32 parts: bh =
// tf32_hi(b), bl = b - bh; EXACT (widened int8 codes, |c| <= 127, exact
// in TF32): bh = b, no bl.
template <bool EXACT>
struct BParts {
  uint32_t h[2], l[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    const float b[2] = {b0, b1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      h[e] = EXACT ? __float_as_uint(b[e]) : tf32_hi(b[e]);
      if constexpr (!EXACT)
        l[e] = __float_as_uint(b[e] - __uint_as_float(h[e]));
    }
  }
};

// step[i] = A_i B_i, N independent products of one k8 step each, in
// three TF32 parts (hi hi + hi lo + lo hi; two over EXACT B) summed into
// fresh tiles (the caller adds each to its f32 sum on the CUDA cores).
// The parts are issued part by part over the N tiles, so that no
// mma.sync waits on the one before it (a tile's three parts depend on
// each other through its accumulator); on the card this order ran no
// faster than tile by tile: mma.sync's TF32 rate bounds the products.
template <int N, bool EXACT>
__device__ __forceinline__ void parts3(float (&step)[N][4],
                                       const uint32_t (&ah)[N][4],
                                       const uint32_t (&al)[N][4],
                                       const BParts<EXACT> (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    step[i][0] = step[i][1] = step[i][2] = step[i][3] = 0.f;
    mma_tf32(step[i], ah[i], b[i].h[0], b[i].h[1]);
  }
  if constexpr (!EXACT) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      mma_tf32(step[i], ah[i], b[i].l[0], b[i].l[1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(step[i], al[i], b[i].h[0], b[i].h[1]);
}

// One warp's 16 query rows: Q's A fragments (16-bit types) or its rows
// staged in shared memory (f32, `qs`), the O accumulator, and for rows g
// and g + 8 of this lane the running max (log2 units), the sum, the last
// chain key the row sees (-1: none) and, in the slab split, the slab rows
// it sees (bit s: row s).
template <int HD>
struct Rows {
  uint32_t q[HD / 16][4];
  const float* qs;
  float o[HD / 8][4];
  float m[2], l[2];
  int lim[2];
  unsigned long long vm[2];
};

// Fold NK staged keys into a warp's rows: K rows ks, V rows vs (row
// stride HD + Elem<T>::kVec), key0 the first key's chain key (slab row
// for SLAB). Scores are scaled by scale * log2(e) so exp2 gives the
// weights. Q8: the staged rows are widened codes; kss / vss hold each
// staged key's K and V scale. Every lane ends holding the C-fragment
// elements of the mma layout (rows g, g + 8; columns 2t, 2t + 1 of each
// n8 tile), on mma.sync at k16 (16-bit) or in TF32 parts at k8 (f32).
template <class T, int HD, int NK, bool Q8, bool SLAB>
__device__ __forceinline__ void fold(Rows<HD>& st, const T* ks, const T* vs,
                                     int key0, float scale_log2,
                                     const float* kss, const float* vss) {
  constexpr int kRow = HD + Elem<T>::kVec;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[NK / 8][4];
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (Elem<T>::kF32) {
    // S = Q K^T on mma.sync m16n8k8, three TF32 parts a k8 step (two over
    // widened int8 codes): Q's rows g, g + 8 and K's rows (keys) 8 nt + g
    // at columns 8 kk + t, + 4, each value split as it is loaded. kKG k8
    // steps at a time, so that kKG * NK / 8 (8) products are in flight
    // (each k8 step's fresh tile is added to the score in k order), in a
    // loop that is not unrolled: fully unrolled, the fold's code outgrew
    // the instruction cache (the verify batches ran 10 % slower)
    constexpr int kQRow = HD + 4;
    constexpr int kNT = NK / 8;
    constexpr int kKG = kNT >= 8 ? 1 : 8 / kNT;
    const float* qa_row = st.qs + g * kQRow;
    const float* qb_row = qa_row + 8 * kQRow;
#pragma unroll 1
    for (int k0 = 0; k0 < HD / 8; k0 += kKG) {
      uint32_t ah[kKG * kNT][4], al[kKG * kNT][4];
      BParts<Q8> b[kKG * kNT];
      float step[kKG * kNT][4];
#pragma unroll
      for (int j = 0; j < kKG; ++j) {
        const int c = 8 * (k0 + j) + t;
        uint32_t h[4], l[4];
        split4(qa_row[c], qb_row[c], qa_row[c + 4], qb_row[c + 4], h, l);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int i = j * kNT + nt;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[i][e] = h[e];
            al[i][e] = l[e];
          }
          const float* kr = ks + (nt * 8 + g) * kRow + c;
          b[i].set(kr[0], kr[4]);
        }
      }
      parts3<kKG * kNT, Q8>(step, ah, al, b);
#pragma unroll
      for (int j = 0; j < kKG; ++j)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += step[j * kNT + nt][e];
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NK / 8; ++nt) {
        const T* kr = ks + (nt * 8 + g) * kRow + kk * 16 + 2 * t;
        ptt::Mma<T>::run(s[nt], st.q[kk],
                         *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
  }
  // mask (key j visible to a row iff j <= its lim, or its slab bit), then
  // each row's max over these keys: a row's scores sit in the 4 lanes of
  // its quad
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, lk = nt * 8 + 2 * t + (e & 1), j = key0 + lk;
      const bool seen = SLAB ? ((st.vm[h] >> j) & 1ull) != 0
                             : j <= st.lim[h];
      const float sc = Q8 ? scale_log2 * kss[lk] : scale_log2;
      s[nt][e] = seen ? s[nt][e] * sc : kNegInf;
      mx[h] = fmaxf(mx[h], s[nt][e]);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    alpha[h] = exp2f(st.m[h] - m_new);
    st.m[h] = m_new;
  }
  // a masked score is exactly kNegInf and gets weight 0 (exp2(kNegInf -
  // m) would be 1 on a row that has seen nothing yet)
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = s[nt][e] > 0.5f * kNegInf ? exp2f(s[nt][e] - st.m[h])
                                                : 0.f;
      s[nt][e] = p;
      sum[h] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    st.l[h] = st.l[h] * alpha[h] + sum[h];
  }
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    st.o[nt][0] *= alpha[0];
    st.o[nt][1] *= alpha[0];
    st.o[nt][2] *= alpha[1];
    st.o[nt][3] *= alpha[1];
  }
  // an int8 pool's V scale per key column of P (the sum above took P
  // unscaled)
  if constexpr (Q8) {
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt) {
      const float v0 = vss[nt * 8 + 2 * t], v1 = vss[nt * 8 + 2 * t + 1];
      s[nt][0] *= v0;
      s[nt][1] *= v1;
      s[nt][2] *= v0;
      s[nt][3] *= v1;
    }
  }
  if constexpr (Elem<T>::kF32) {
    // O += P V on mma.sync m16n8k8, three TF32 parts a k8 step (two over
    // widened int8 codes), eight head_dim n8 tiles at a time. The
    // contraction over n-tile nt's 8 keys runs in a permuted order, k = t
    // <-> key 8 nt + 2t, k = t + 4 <-> key 8 nt + 2t + 1, so P's A
    // fragment is its accumulator's registers as they are (split), and
    // V's B fragment reads rows 8 nt + 2t, + 1 at column 8 dn + g (banks
    // 8t + g: conflict-free with rows of HD + 4 floats)
    constexpr int kDG = 8;
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt) {
      uint32_t h[4], l[4];
      split4(s[nt][0], s[nt][2], s[nt][1], s[nt][3], h, l);
      const float* vr = vs + (nt * 8 + 2 * t) * kRow + g;
#pragma unroll
      for (int d0 = 0; d0 < HD / 8; d0 += kDG) {
        uint32_t ph[kDG][4], pl[kDG][4];
        BParts<Q8> b[kDG];
        float step[kDG][4];
#pragma unroll
        for (int i = 0; i < kDG; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ph[i][e] = h[e];
            pl[i][e] = l[e];
          }
          b[i].set(vr[(d0 + i) * 8], vr[kRow + (d0 + i) * 8]);
        }
        parts3<kDG, Q8>(step, ph, pl, b);
#pragma unroll
        for (int i = 0; i < kDG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st.o[d0 + i][e] += step[i][e];
      }
    }
  } else {
    // O += P V: the accumulators of key n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; V's B fragments of head_dim n-tiles 2dp,
    // 2dp+1 come from one transposed ldmatrix (keys 0-7 / 8-15 x columns
    // 0-7 / 8-15 of the pair)
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a[4];
      a[0] = ptt::Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = ptt::Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = ptt::Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = ptt::Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kk * 16 + vr) * kRow + dp * 16 + vc);
        ptt::Mma<T>::run(st.o[2 * dp], a, b[0], b[1]);
        ptt::Mma<T>::run(st.o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

struct Args {
  const void* q;                   // T
  const void* k_pool;              // T, or int8 codes with k_scale
  const void* v_pool;
  const float* k_scale;            // [N] f32; null for an fp pool
  const float* v_scale;
  const int* table;
  const int* positions;
  const unsigned char* valid;
  const void* suffix_k;            // [R, S, KV, hd] T; null without a slab
  const void* suffix_v;
  const unsigned char* suffix_vis; // [R, P, S]
  void* out;                       // T
  float* part_o;                   // [n_splits (+ 1), R * P * H, hd] f32
  float* part_ml;                  // [n_splits (+ 1), R * P * H, 2]
  int P, H, KV, N, bs, M, S, split_keys, n_splits;
  float scale_log2;
};

// NC outputs o / sum (0 where sum is 0) written to dst in T
template <class T, int NC>
__device__ __forceinline__ void store_out(T* dst, const float (&o)[NC],
                                          float inv) {
  if constexpr (Elem<T>::kF32) {
    if constexpr (NC == 4)
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(o[0] * inv, o[1] * inv);
  } else {
    uint32_t w[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i)
      w[i] = ptt::Mma<T>::pack(o[2 * i] * inv, o[2 * i + 1] * inv);
    if constexpr (NC == 4)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// Where a block's results go.
struct Sink {
  void* out;
  float* part_o;
  float* part_ml;
  const int* positions;
  const unsigned char* valid;
  size_t rows;             // R * P * H
  int max_keys, split_keys, split;
  bool slab;               // the call has a slab (its split is the last)
  bool is_slab;            // this block folds the slab

  // Pool splits holding query qi's visible chain keys (0: an invalid
  // query, or one that sees no chain key).
  __device__ __forceinline__ int splits_of(int qi) const {
    if (!valid[qi]) return 0;
    const int n = min(positions[qi] + 1, max_keys);
    return n > 0 ? (n + split_keys - 1) / split_keys : 0;
  }

  // What this block writes for query qi: 0 nothing, 1 its final output,
  // 2 an f32 partial.
  __device__ __forceinline__ int action(int qi) const {
    const int ns = splits_of(qi);
    if (slab) {
      if (!valid[qi]) return 0;
      return is_slab || split < ns ? 2 : 0;
    }
    if (ns <= 1) return split == 0 ? 1 : 0;
    return split < ns ? 2 : 0;
  }

  // Columns c.. c + NC - 1 of output row `row` ((r * P + p) * H + head):
  // O unnormalised, with its max and sum.
  template <class T, int HD, int NC>
  __device__ __forceinline__ void put(const float (&o)[NC], float mx,
                                      float sum, int act, size_t row,
                                      int c) const {
    if (act == 1) {
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      store_out<T, NC>(static_cast<T*>(out) + row * HD + c, o, inv);
    } else if (act == 2) {
      const size_t at = (size_t)split * rows + row;
      float* dst = part_o + at * HD + c;
      if constexpr (NC == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      if (c == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * at) = make_float2(mx, sum);
    }
  }
};

// SLAB: the call has a slab (suffix_k non-null), whose split is the last
// of each tile; a call without one compiles none of the slab's code.
template <class T, int HD, bool NARROW, bool Q8, bool SLAB>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(const Args a) {
  using RG = Ring<HD, Q8, T, NARROW>;
  constexpr int kTileRows = NARROW ? 16 : 64;
  constexpr int kRow = RG::kRow;
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kQRow = RG::kQRow;
  extern __shared__ __align__(16) unsigned char smem[];
  // fp: the T ring. int8: the code ring, then the T staging stage, then
  // the per-key scales of each ring stage. Then (f32) the tile's Q rows,
  // then the split's table entries (and an int8 pool's scales)
  T* ring = reinterpret_cast<T*>(smem);
  signed char* codes = reinterpret_cast<signed char*>(smem);
  T* staged = reinterpret_cast<T*>(smem + RG::kStages * RG::kCodeStage);
  float* key_sc = reinterpret_cast<float*>(smem + RG::kRingBytes);
  float* s_q = reinterpret_cast<float*>(smem + RG::kBytes);
  int* s_tab = reinterpret_cast<int*>(
      smem + RG::kBytes + (NARROW ? RG::kQNarrow : RG::kQWide));
  __shared__ int s_live;
  const int P = a.P, H = a.H, KV = a.KV, bs = a.bs, M = a.M;
  const int n_all = a.n_splits + (SLAB ? 1 : 0);
  const int rep = H / KV, tile_pos = kTileRows / rep;
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int split = blockIdx.z % n_all;
  const bool slab = SLAB && split == a.n_splits;
  const int p0 = blockIdx.z / n_all * tile_pos;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int max_keys = M * bs;
  const T* qg = static_cast<const T*>(a.q);

  // f32: a wide tile whose valid queries all lie in its first 16 rows
  // (the fused step's decode rows, padded to the prefill's width) is
  // walked lean, as a narrow tile: each warp folds a quarter of every
  // stage's keys into those 16 rows, and the four are merged at the end
  // (its other rows are written as the invalid queries they are). Its one
  // warp of valid rows would otherwise take every key on the mma.sync
  // rate alone.
  bool lean = false;
  if constexpr (Elem<T>::kF32 && !NARROW) {
    bool v = false;
    for (int rr = 16 + threadIdx.x; rr < kTileRows; rr += kThreads) {
      const int p = p0 + rr / rep;
      v = v || (p < P && a.valid[r * P + p] != 0);
    }
    lean = !__syncthreads_or(v);
  }
  // this warp's rows: tile row rr is position p0 + rr / rep, head
  // kvh * rep + rr % rep
  const int row0 = NARROW || lean ? 0 : warp * 16;
  Rows<HD> st;
  auto load_rows = [&]() {
    const T* qr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + g + 8 * h, p = p0 + rr / rep;
      qr[h] = nullptr;
      st.lim[h] = -1;
      st.vm[h] = 0ull;
      if (p < P) {
        const int i = r * P + p;
        qr[h] = qg + ((size_t)i * H + kvh * rep + rr % rep) * HD;
        if (a.valid[i]) {
          st.lim[h] = a.positions[i];
          if constexpr (SLAB) {
            if (slab) {
              const unsigned char* vis = a.suffix_vis + (size_t)i * a.S;
              for (int j = 0; j < a.S; ++j)
                if (vis[j]) st.vm[h] |= 1ull << j;
            }
          }
        }
      }
    }
    if constexpr (Elem<T>::kF32) {
      // the tile's Q rows into shared memory, by the whole block (zeros
      // past P); the folds read them after the next block barrier
      for (int i = threadIdx.x; i < kTileRows * (HD / 4); i += kThreads) {
        const int rr = i / (HD / 4), c = (i % (HD / 4)) * 4;
        const int p = p0 + rr / rep;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < P)
          v = *reinterpret_cast<const float4*>(
              qg + ((size_t)(r * P + p) * H + kvh * rep + rr % rep) * HD + c);
        *reinterpret_cast<float4*>(s_q + rr * kQRow + c) = v;
      }
      st.qs = s_q + row0 * kQRow;
    } else {
      auto pair = [&](int h, int c) -> uint32_t {
        return qr[h] != nullptr
                   ? *reinterpret_cast<const uint32_t*>(qr[h] + c) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        st.q[kk][0] = pair(0, c);
        st.q[kk][1] = pair(1, c);
        st.q[kk][2] = pair(0, c + 8);
        st.q[kk][3] = pair(1, c + 8);
      }
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      st.o[nt][0] = st.o[nt][1] = st.o[nt][2] = st.o[nt][3] = 0.f;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
  };
  // each thread copies one 16-byte column chunk of every
  // (kThreads / chunks)-th key of a T stage
  constexpr int kChunks = HD / kVec;
  const int chunk = threadIdx.x % kChunks;

  if (slab) {
    if constexpr (SLAB) {
    // the slab split: its S rows as one 64-row stage, straight into a T
    // stage (the int8 kernel's staging stage; f32: the ring's start)
    T* ks = Q8 && !Elem<T>::kF32 ? staged : ring;
    T* vs = ks + kMaxSlab * kRow;
#pragma unroll
    for (int j = threadIdx.x / kChunks; j < kMaxSlab;
         j += kThreads / kChunks) {
      const bool in = j < a.S;
      const size_t off =
          in ? (((size_t)r * a.S + j) * KV + kvh) * HD + chunk * kVec : 0;
      cp_async16(ks + j * kRow + chunk * kVec,
                 static_cast<const T*>(a.suffix_k) + off, in);
      cp_async16(vs + j * kRow + chunk * kVec,
                 static_cast<const T*>(a.suffix_v) + off, in);
    }
    cp_async_commit();
    load_rows();
    cp_async_wait<0>();
    __syncthreads();
    if (NARROW || lean)
      fold<T, HD, 16, false, true>(st, ks + warp * 16 * kRow,
                                   vs + warp * 16 * kRow, warp * 16,
                                   a.scale_log2, nullptr, nullptr);
    else
      fold<T, HD, 64, false, true>(st, ks, vs, 0, a.scale_log2, nullptr,
                                   nullptr);
    }
  } else {
    // One round trip before the walk: the tile's positions (its live
    // chain: keys up to its largest valid position) and the table entries
    // (and an int8 pool's scales) of this split's whole key range.
    const int k_lo = split * a.split_keys;
    const int kb0 = k_lo / bs;
    const int nb = k_lo < max_keys
                       ? (min(k_lo + a.split_keys, max_keys) - 1) / bs - kb0 + 1
                       : 0;
    const int nb_max = (a.split_keys + bs - 1) / bs + 1;
    float* s_ks = reinterpret_cast<float*>(s_tab + nb_max);
    float* s_vs = s_ks + nb_max;
    int seen = 0;
    if (threadIdx.x < tile_pos && p0 + threadIdx.x < P) {
      const int i = r * P + p0 + threadIdx.x;
      const int ok = a.valid[i], pos = a.positions[i];
      seen = ok ? pos + 1 : 0;
    }
    if (threadIdx.x == 0) s_live = 0;
    __syncthreads();
    if (seen > 0) atomicMax(&s_live, seen);
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const int b = min(max(a.table[(size_t)r * M + kb0 + i], 0), a.N - 1);
      s_tab[i] = b;
      if constexpr (Q8) {
        s_ks[i] = a.k_scale[b];
        s_vs[i] = a.v_scale[b];
      }
    }
    __syncthreads();
    const int live = min(s_live, max_keys);
    // split 0 writes the finals of a call without a slab; with one, the
    // merge writes every output
    if ((split > 0 || SLAB) && k_lo >= live) return;
    const int k_hi = min(k_lo + a.split_keys, live);
    constexpr int kKeys = RG::kKeys;
    constexpr int kNW = kKeys / 4;          // keys a narrow tile's warp folds
    const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

    // Stage `tile` of the split into ring slot `slot`. int8: rows of HD
    // bytes, HD / 16 chunks a row; the chunk-0 thread of each key also
    // stores the key's two scales (0 past the split).
    auto load_stage = [&](int tile, int slot) {
      constexpr int kCh = Q8 ? HD / 16 : kChunks;
      const int ch = threadIdx.x % kCh;
#pragma unroll
      for (int j = threadIdx.x / kCh; j < kKeys; j += kThreads / kCh) {
        const int key = k_lo + tile * kKeys + j;
        const bool in = key < k_hi;
        size_t off = 0;
        int bi = 0;
        if (in) {
          const int b = key / bs;
          bi = b - kb0;
          off = (((size_t)s_tab[bi] * bs + (key - b * bs)) * KV + kvh) * HD;
        }
        if constexpr (Q8) {
          signed char* ks = codes + slot * RG::kCodeStage;
          signed char* vs = ks + kKeys * HD;
          const signed char* kp = static_cast<const signed char*>(a.k_pool);
          const signed char* vp = static_cast<const signed char*>(a.v_pool);
          cp_async16(ks + j * HD + ch * 16, kp + off + ch * 16, in);
          cp_async16(vs + j * HD + ch * 16, vp + off + ch * 16, in);
          if (ch == 0) {
            float* sc = key_sc + slot * 2 * kKeys;
            sc[j] = in ? s_ks[bi] : 0.f;
            sc[kKeys + j] = in ? s_vs[bi] : 0.f;
          }
        } else {
          T* ks = ring + slot * RG::kStage;
          T* vs = ks + kKeys * kRow;
          const T* kp = static_cast<const T*>(a.k_pool);
          const T* vp = static_cast<const T*>(a.v_pool);
          cp_async16(ks + j * kRow + ch * kVec, kp + off + ch * kVec, in);
          cp_async16(vs + j * kRow + ch * kVec, vp + off + ch * kVec, in);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < RG::kStages - 1; ++i) {
      if (i < n_tiles) load_stage(i, i);
      cp_async_commit();
    }
    load_rows();              // while the first stages are in flight
    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_async_wait<RG::kStages - 2>();     // stage `tile` has landed
      __syncthreads();                      // and the slot refilled next
                                            // (and the staging stage) is
                                            // no longer read
      const int next = tile + RG::kStages - 1;
      if (next < n_tiles) load_stage(next, next % RG::kStages);
      cp_async_commit();
      const int slot = tile % RG::kStages;
      const T* ks;
      const float* kss = nullptr;
      const float* vss = nullptr;
      if constexpr (Q8) {
        // widen the landed codes to T, 16 codes at a time: in a narrow
        // tile each warp its own kNW keys of K and V (rows warp * kNW..
        // and kKeys + warp * kNW..), which only it reads; in a wide tile
        // the block the whole stage
        const signed char* src = codes + slot * RG::kCodeStage;
        auto widen = [&](int row, int col) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(src + row * HD + col);
          if constexpr (Elem<T>::kF32) {
            float4* dst = reinterpret_cast<float4*>(staged + row * kRow +
                                                    col);
            dst[0] = widen4_f32(w.x);
            dst[1] = widen4_f32(w.y);
            dst[2] = widen4_f32(w.z);
            dst[3] = widen4_f32(w.w);
          } else {
            const uint2 a = widen4<T>(w.x), b = widen4<T>(w.y),
                        c = widen4<T>(w.z), d = widen4<T>(w.w);
            uint4* dst = reinterpret_cast<uint4*>(staged + row * kRow + col);
            dst[0] = make_uint4(a.x, a.y, b.x, b.y);
            dst[1] = make_uint4(c.x, c.y, d.x, d.y);
          }
        };
        constexpr int kCh = HD / 16;          // 16-code chunks a row
        if (NARROW) {
          for (int c = lane; c < 2 * kNW * kCh; c += 32) {
            const int r = c / kCh;
            widen((r < kNW ? 0 : kKeys - kNW) + warp * kNW + r,
                  (c % kCh) * 16);
          }
          __syncwarp();
        } else {
          for (int c = threadIdx.x; c < 2 * kKeys * kCh; c += kThreads)
            widen(c / kCh, (c % kCh) * 16);
          __syncthreads();
        }
        ks = staged;
        kss = key_sc + slot * 2 * kKeys;
        vss = kss + kKeys;
      } else {
        ks = ring + slot * RG::kStage;
      }
      const T* vs = ks + kKeys * kRow;
      const int key0 = k_lo + tile * kKeys;
      if (NARROW || lean)
        fold<T, HD, kNW, Q8, false>(
            st, ks + warp * kNW * kRow, vs + warp * kNW * kRow,
            key0 + warp * kNW, a.scale_log2,
            Q8 ? kss + warp * kNW : nullptr, Q8 ? vss + warp * kNW : nullptr);
      else
        fold<T, HD, kKeys, Q8, false>(st, ks, vs, key0, a.scale_log2, kss,
                                      vss);
    }
  }
  cp_async_wait<0>();
  // the merge may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();                          // the ring is free

  const Sink sink{a.out, a.part_o, a.part_ml, a.positions, a.valid,
                  (size_t)gridDim.x * P * H, max_keys, a.split_keys, split,
                  SLAB, slab};
  if (!NARROW && !lean) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + g + 8 * h, p = p0 + rr / rep;
      if (p >= P) continue;
      const int qi = r * P + p, act = sink.action(qi);
      const size_t row = (size_t)qi * H + kvh * rep + rr % rep;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const float o2[2] = {st.o[nt][2 * h], st.o[nt][2 * h + 1]};
        sink.put<T, HD, 2>(o2, st.m[h], st.l[h], act, row, nt * 8 + 2 * t);
      }
    }
    return;
  }
  // narrow (or lean): the 4 warps' partials over the same 16 rows,
  // merged in warp order through shared memory
  constexpr int kLd = HD + 4;
  float* so = reinterpret_cast<float*>(smem);          // [4][16][kLd]
  float* sml = so + 4 * 16 * kLd;                       // [4][16][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = warp * 16 + g + 8 * h;
    if (t == 0) {
      sml[2 * rr] = st.m[h];
      sml[2 * rr + 1] = st.l[h];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<float2*>(so + rr * kLd + nt * 8 + 2 * t) =
          make_float2(st.o[nt][2 * h], st.o[nt][2 * h + 1]);
  }
  __syncthreads();
  const int rows = min(NARROW ? kTileRows : 16, (P - p0) * rep);
  for (int i = threadIdx.x; i < rows * (HD / 4); i += kThreads) {
    const int rr = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, sml[2 * (w * 16 + rr)]);
    float sum = 0.f, o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int wr = w * 16 + rr;
      const float f = exp2f(sml[2 * wr] - mx);
      sum += f * sml[2 * wr + 1];
      const float4 v = *reinterpret_cast<const float4*>(so + wr * kLd + c);
      o4[0] += f * v.x;
      o4[1] += f * v.y;
      o4[2] += f * v.z;
      o4[3] += f * v.w;
    }
    const int qi = r * P + p0 + rr / rep;
    sink.put<T, HD, 4>(o4, mx, sum, sink.action(qi),
                       (size_t)qi * H + kvh * rep + rr % rep, c);
  }
  if constexpr (Elem<T>::kF32 && !NARROW) {
    // lean: the tile's rows past the first 16 (no valid query) as the
    // wide epilogue writes them: nothing seen
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
    const int past = min(kTileRows, (P - p0) * rep) - 16;
    for (int i = threadIdx.x; i < past * (HD / 4); i += kThreads) {
      const int rr = 16 + i / (HD / 4), c = (i % (HD / 4)) * 4;
      const int qi = r * P + p0 + rr / rep;
      sink.put<T, HD, 4>(z, kNegInf, 0.f, sink.action(qi),
                         (size_t)qi * H + kvh * rep + rr % rep, c);
    }
  }
}

// One warp per output row: the query's partials of pool splits 0.. ns - 1
// and then, with a slab, the slab's (partial `slab`), folded in that
// order. Without a slab, rows whose query needs one split or none were
// written by ragged_split_kernel; with one, this kernel writes every row
// (zeros for an invalid query).
template <class T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_merge_kernel(const int* __restrict__ positions,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ part_o,
                    const float* __restrict__ part_ml,
                    T* __restrict__ out, int rows, int H, int max_keys,
                    int split_keys, int slab) {
  constexpr int kPer = HD / 32;             // columns a lane: 4 or 2
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int qi = row / H;
  const int c = (threadIdx.x & 31) * kPer;
  T* dst = out + (size_t)row * HD + c;
  if (!valid[qi]) {
    // the split kernel writes no output of a call with a slab
    if (slab >= 0) {
      if constexpr (Elem<T>::kF32) {
        for (int i = 0; i < kPer; ++i) dst[i] = 0.f;
      } else {
        for (int i = 0; i < kPer / 2; ++i)
          reinterpret_cast<uint32_t*>(dst)[i] = 0u;
      }
    }
    return;
  }
  const int n = min(positions[qi] + 1, max_keys);
  const int ns = n > 0 ? (n + split_keys - 1) / split_keys : 0;
  if (slab < 0 && ns <= 1) return;
  const int nf = ns + (slab >= 0 ? 1 : 0);  // partials folded
  // launched as a programmatic dependent of ragged_split_kernel: wait for
  // its partials (a no-op when launched plainly)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mx = kNegInf;
  for (int i = 0; i < nf; ++i) {
    const int s = i < ns ? i : slab;
    mx = fmaxf(mx, part_ml[2 * ((size_t)s * rows + row)]);
  }
  float sum = 0.f, o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  for (int i = 0; i < nf; ++i) {
    const int s = i < ns ? i : slab;
    const size_t at = (size_t)s * rows + row;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * at);
    const float f = exp2f(ml.x - mx);
    sum += f * ml.y;
    const float* src = part_o + at * HD + c;
    float v[kPer];
    if constexpr (kPer == 4) {
      const float4 u = *reinterpret_cast<const float4*>(src);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      const float2 u = *reinterpret_cast<const float2*>(src);
      v[0] = u.x; v[1] = u.y;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) o[j] += f * v[j];
  }
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  if constexpr (Elem<T>::kF32) {
    store_out<T, kPer>(dst, o, inv);
  } else {
#pragma unroll
    for (int i = 0; i < kPer / 2; ++i)
      reinterpret_cast<uint32_t*>(dst)[i] =
          ptt::Mma<T>::pack(o[2 * i] * inv, o[2 * i + 1] * inv);
  }
}

template <class T, int HD, bool NARROW, bool Q8, bool SLAB>
cudaError_t launch(const Args& a, int R, cudaStream_t stream) {
  static int granted[64] = {};
  const int tile_pos = (NARROW ? 16 : 64) / (a.H / a.KV);
  const int n_pt = (a.P + tile_pos - 1) / tile_pos;
  const int n_all = a.n_splits + (SLAB ? 1 : 0);
  const int nb_max = (a.split_keys + a.bs - 1) / a.bs + 1;
  using RG = Ring<HD, Q8, T, NARROW>;
  const int smem = RG::kBytes + (NARROW ? RG::kQNarrow : RG::kQWide) +
                   4 * nb_max * (Q8 ? 3 : 1);
  cudaError_t err = hop::allow_smem(
      ragged_split_kernel<T, HD, NARROW, Q8, SLAB>, smem, granted);
  if (err != cudaSuccess) return err;
  ragged_split_kernel<T, HD, NARROW, Q8, SLAB>
      <<<dim3(R, a.KV, n_pt * n_all), kThreads, smem, stream>>>(a);
  if (a.n_splits > 1 || SLAB) {
    // a programmatic dependent launch: the merge's blocks are scheduled
    // as the split kernel's finish their walks, and wait for its results
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = R * a.P * a.H;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((rows + kThreads / 32 - 1) / (kThreads / 32));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ragged_merge_kernel<T, HD>, a.positions,
                              a.valid, static_cast<const float*>(a.part_o),
                              static_cast<const float*>(a.part_ml),
                              static_cast<T*>(a.out), rows, a.H, a.M * a.bs,
                              a.split_keys, SLAB ? a.n_splits : -1);
  }
  return cudaGetLastError();
}

template <class T>
int run(const void* q, const void* k_pool, const void* v_pool,
        const void* k_scale, const void* v_scale, const void* table,
        const void* positions, const void* valid, const void* suffix_k,
        const void* suffix_v, const void* suffix_vis, void* o, void* part_o,
        void* part_ml, int R, int P, int H, int KV, int hd, int N, int bs,
        int M, int S, int narrow, int split_keys, int n_splits, float scale,
        void* stream) {
  const bool q8 = k_scale != nullptr, slab = suffix_k != nullptr;
  if (KV <= 0 || H % KV != 0 || 64 % (H / KV) != 0 ||
      (narrow && 16 % (H / KV) != 0) || split_keys <= 0 ||
      split_keys % kStageKeys != 0 || n_splits < 1 || bs < 1 ||
      (q8 && v_scale == nullptr) ||
      (slab && (suffix_v == nullptr || suffix_vis == nullptr || S < 1 ||
                S > kMaxSlab)) ||
      ((n_splits > 1 || slab) && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.positions = static_cast<const int*>(positions);
  a.valid = static_cast<const unsigned char*>(valid);
  a.suffix_k = suffix_k;
  a.suffix_v = suffix_v;
  a.suffix_vis = static_cast<const unsigned char*>(suffix_vis);
  a.out = o;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.P = P;
  a.H = H;
  a.KV = KV;
  a.N = N;
  a.bs = bs;
  a.M = M;
  a.S = slab ? S : 0;
  a.split_keys = split_keys;
  a.n_splits = n_splits;
  a.scale_log2 = scale * ptt::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_Q8(HD, NW, SL)                                          \
  (q8 ? launch<T, HD, NW, true, SL>(a, R, s)                        \
      : launch<T, HD, NW, false, SL>(a, R, s))
#define PTT_RAGGED(HD, NW) \
  (slab ? PTT_Q8(HD, NW, true) : PTT_Q8(HD, NW, false))
  cudaError_t err;
  if (hd == 128)
    err = narrow ? PTT_RAGGED(128, true) : PTT_RAGGED(128, false);
  else if (hd == 64)
    err = narrow ? PTT_RAGGED(64, true) : PTT_RAGGED(64, false);
  else
    err = cudaErrorInvalidValue;
#undef PTT_RAGGED
#undef PTT_Q8
  return (int)err;
}

}  // namespace

// The host's split plan (nlp/ragged_attention.py::split_plan) gives
// `narrow` (16-row query tiles; H / KV must divide 16), `split_keys` (a
// positive multiple of 64) and `n_splits`. q, an fp pool, the slab and o
// are in the entry point's type (ragged_paged_attention_bf16, _f16,
// _f32). k_scale/v_scale non-null mark int8 pools (f32 [N] scales);
// suffix_k non-null adds the slab (S rows, 1 <= S <= 64, with suffix_v
// and suffix_vis). With n_splits > 1 or a slab, part_o and part_ml are
// f32 [n_splits (+ 1 with a slab), R * P * H, hd] and [.., 2] scratch.
// H / KV must divide 64. Returns the launches' cudaError_t (0 on
// success).
#define PTT_RAGGED_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                      \
      const void* q, const void* k_pool, const void* v_pool,                \
      const void* k_scale, const void* v_scale, const void* table,          \
      const void* positions, const void* valid, const void* suffix_k,       \
      const void* suffix_v, const void* suffix_vis, void* o, void* part_o,  \
      void* part_ml, int R, int P, int H, int KV, int hd, int N, int bs,    \
      int M, int S, int narrow, int split_keys, int n_splits, float scale,  \
      void* stream) {                                                       \
    return run<T>(q, k_pool, v_pool, k_scale, v_scale, table, positions,    \
                  valid, suffix_k, suffix_v, suffix_vis, o, part_o,         \
                  part_ml, R, P, H, KV, hd, N, bs, M, S, narrow,            \
                  split_keys, n_splits, scale, stream);                     \
  }
PTT_RAGGED_ENTRY(ragged_paged_attention_bf16, bf16)
PTT_RAGGED_ENTRY(ragged_paged_attention_f16, f16)
PTT_RAGGED_ENTRY(ragged_paged_attention_f32, float)
#undef PTT_RAGGED_ENTRY
