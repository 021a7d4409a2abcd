// GQA flash-attention backward for Hopper (sm_90a): causal, or
// bidirectional with an optional key-padding mask, in either layout.
//
// Replaces: paddle_tpu/kernels/flash_attention.py's backward kernels, the
// four schedules of flash_attention_pallas_bwd: _flash_bwd_combined_kernel_res
// (pallas_call in _bwd_call_resident, seq <= 2048), _flash_bwd_combined_kernel_str
// (streamed, longer seq) and the split _flash_bwd_dq_kernel /
// _flash_bwd_dkv_kernel (very long seq). The TPU needs four schedules to
// fit 16 MB of scoped VMEM; here one design serves every length.
//
// Computes, from q [B, Sq, H, hd], k/v [B, Sk, KV, hd], out and dout
// [B, Sq, H, hd] (bf16, or f16 through flash_bwd_f16: one type for all
// five, the same kernel templates instantiated for each, as the TPU
// kernels compute in their inputs' dtype; or the head-major [B, H, S, hd]
// of 'bhsd': TMA
// reads q, k, v and dout through tensor maps built from their strides,
// the other tensors are read and written through their strides) and the
// forward's lse [B, H, Sq] (f32, natural log of the scaled scores):
//   P  = exp(scale * Q K^T - lse) where key j is visible to query i
//        (causal: j <= i + Sk - Sq; key mask: key_mask[b, j] != 0), else 0
//   dcap_i = sum_d dO_i * O_i
//   dS = P o (dO V^T - dcap) * scale
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO
// with dK and dV summed over each KV head's rep = H / KV query heads.
// The mask zeroes P, not the scores (the TPU kernels' p re-mask,
// flash_attention.py:417, :486): a masked key gets dK = dV = 0, and a row
// that sees no key (its lse is -1e30) contributes nothing. P and dS are
// rounded to the input type only as the A operands of the second
// products. In f16 that rounding is where the two types part: f16 keeps
// 3 more mantissa bits but flushes |dS| below 2^-24 to zero (and rounds
// it coarsely below 2^-14), where bf16 keeps f32's exponent range; a
// dS that small adds less than the f32 sums' own rounding to dQ and dK
// at the scales a loss scaler keeps the gradients in, and chip_smoke.py's
// f16 gradient check holds the result to the plain f16 path. In f16 the
// dq pass sums dP's k16 steps apart, each product into a fresh f32
// accumulator (the tensor core truncates a sum against its running
// value): where a causal row sees one key, dP - dcap is 0 in exact
// arithmetic, and the truncation residue of five k16 steps at hd 72
// put that row's dQ past 2.5 f16 ulps (S 300, GQA 4:1); bf16's bound
// does not see it, and the bf16 kernel keeps one chain.
// head_dim 64, 72 or 128 (72: the contractions over hd take 5 k16 steps,
// the fifth over columns TMA zero-fills; see hopper_core.cuh).
//
// Bound on the H100: five products (QK^T again, dO V^T, P^T dO, dS K,
// dS^T Q) over the visible pairs against O(S * hd) bytes: tensor-core
// bound at training lengths. The first design (2.5-4.6x SDPA's time)
// built the second products' B operands from 16-bit shared loads,
// staged 32 queries between two barriers and ran mma.sync only. This
// design, three kernels in order on the caller's stream:
//   dcap — one warp per (batch, head, query) row of [B * H, Sq_pad]
//          (Sq_pad = Sq rounded up to 128): dcap = rowsum(dO * O) and
//          lse * log2(e), into an f32 scratch [2, B * H, Sq_pad]. Padding
//          rows get dcap 0 and +1e30, so a query row past Sq (TMA's zero
//          rows) gets P = exp2(0 - 1e30) = 0 with no test, and every
//          64-query slice is a 256-byte, 16-byte-aligned bulk copy.
//   dkdv — a block owns (b, KV head, 128 keys): two consumer warpgroups of
//          64 keys and a producer warpgroup (setmaxnreg 24 / 240). K and V
//          are loaded once by TMA and stay in shared memory; Q, dO (TMA)
//          and the prep rows (bulk copies) of 64 queries stream through a
//          two-stage mbarrier ring, over the rep query heads of the group
//          and, for each, the query tiles from the causal diagonal on.
//          S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16 from shared
//          memory; P^T and dS^T stay in registers as the A operands of
//          dV += P^T dO and dK += dS^T Q (wgmma m64n{hd}k16, dO and Q read
//          MN-major). dK, dV accumulate in f32 registers over the whole
//          group: GQA needs neither an expanded K/V nor a reduction. A
//          block whose 128 keys are all masked writes zeros and walks no
//          queries; a warpgroup skips the products of a query tile that
//          sees none of its keys (causal).
//   dq   — a block owns 128 query rows of one (b, head), the forward's
//          shape: Q and dO loaded once, K and V tiles of 64 keys through
//          the ring (only the tiles that hold a visible key), S = Q K^T
//          and dP = dO V^T on wgmma, dS in registers as the A operand of
//          dQ += dS K (K read MN-major). dQ in f32 registers.
// dQ is a separate pass rather than a fixed-order reduction of partial
// dQ tiles across the dkdv blocks: it recomputes S and dP, 7 products
// where the bound counts 5 (so at most 5/7 of the bound's rate), but it
// needs no atomics and no f32 dQ buffer, and every output is summed in a
// fixed order: two runs are bit-identical.
// Tiles wholly visible (below the diagonal, no masked or missing key)
// take no per-element test. Not done yet: folding dQ into dkdv under a
// fixed-order reduction, overlapping a warpgroup's elementwise work with
// its next products, and TMA stores.
#include <type_traits>

#include "hopper_core.cuh"

namespace {

using hop::Strides;

constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr int kKN = 128;        // dkdv: keys a block, 64 a warpgroup
constexpr int kQM = 64;         // dkdv: queries a streamed tile
constexpr int kDqM = 128;       // dq: query rows a block, 64 a warpgroup
constexpr int kDqN = 64;        // dq: keys a streamed tile
constexpr int kPad = 128;       // the prep rows' padding of Sq
constexpr float kPadLse = 1e30f;

__host__ __device__ __forceinline__ int padded(int sq) {
  return (sq + kPad - 1) / kPad * kPad;
}

// ------------------------------------------------------------------ dcap
// row runs over [B * H, Sq_pad]; lse2 and dcap are the scratch's halves
template <class T, int HD>
__global__ void __launch_bounds__(128)
dcap_kernel(const T* __restrict__ o, const T* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ dcap, long rows, int Sq, int Sq_pad, int H,
            Strides os, Strides ds) {
  const long row = (long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq_pad);
  const long bh = row / Sq_pad;
  if (i >= Sq) {
    if (lane == 0) {
      lse2[row] = kPadLse;
      dcap[row] = 0.f;
    }
    return;
  }
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* op = o + os.at(b, i, h);
  const T* dp = dout + ds.at(b, i, h);
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < HD; c += 64) {
    const float2 a = hop::load2<T>(op + c);
    const float2 d = hop::load2<T>(dp + c);
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    dcap[row] = acc;
    lse2[row] = lse[bh * Sq + i] * hop::kLog2e;
  }
}

// ------------------------------------------------------------------ dkdv
// K, V [chunk][128][64]; per stage Q, dO [chunk][64][64], then the
// stages' lse2 and dcap slices [64] f32; the barriers.
template <int HD>
struct DkdvSmem {
  static constexpr int kC = hop::chunks(HD);
  static constexpr int kKBytes = kC * kKN * hop::kRowBytes;
  static constexpr int kQBytes = kC * kQM * hop::kRowBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = 2 * kKBytes;             // + stage * 2 * kQBytes
  static constexpr int kRows = kQ + kStages * 2 * kQBytes;  // + stage * 512
  static constexpr int kBars = kRows + kStages * 2 * kQM * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse2, const float* __restrict__ dcap,
            const unsigned char* __restrict__ key_mask,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
            int H, int KV, Strides dks, Strides dvs, float scale,
            int causal) {
  using L = DkdvSmem<HD>;
  constexpr int kC = L::kC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int rep = H / KV;
  const int k0 = blockIdx.y * kKN;
  const int off = Sk - Sq;
  const int Sq_pad = padded(Sq);
  const float scale_log2 = scale * hop::kLog2e;
  const unsigned char* mrow =
      key_mask != nullptr ? key_mask + (size_t)b * Sk : nullptr;

  // a block whose keys are all masked: zeros, no queries walked
  if (mrow != nullptr) {
    const int key = k0 + (int)threadIdx.x;
    const int vis = threadIdx.x < kKN && key < Sk && mrow[key] != 0;
    if (!__syncthreads_or(vis)) {
      for (int e = threadIdx.x; e < kKN * (HD / 8); e += kThreads) {
        const int j = k0 + e / (HD / 8), c = (e % (HD / 8)) * 8;
        if (j >= Sk) continue;
        *reinterpret_cast<uint4*>(dk + dks.at(b, j, kvh) + c) =
            make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + dvs.at(b, j, kvh) + c) =
            make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kConsumers);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // query tiles from the first that can see this block's first key
  const int qt0 = causal ? max(0, k0 - off) / kQM : 0;
  const int n_qt = (Sq + kQM - 1) / kQM;

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    hop::mbar_expect_tx(kv_full, 2 * kC * (kKN / hop::kBox) * hop::kBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kKN / hop::kBox; ++r) {
        const int at = (c * kKN + r * hop::kBox) * hop::kRowBytes;
        hop::tma_load(&tm_k, kv_full, smem + L::kK + at, c * hop::kBox,
                      k0 + r * hop::kBox, kvh, b);
        hop::tma_load(&tm_v, kv_full, smem + L::kV + at, c * hop::kBox,
                      k0 + r * hop::kBox, kvh, b);
      }
    hop::Ring<kStages> ring;
    for (int r = 0; r < rep; ++r) {
      const int h = kvh * rep + r;
      const size_t prow = ((size_t)b * H + h) * Sq_pad;
      for (int qt = qt0; qt < n_qt; ++qt) {
        hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        uint64_t* bar = &full[ring.stage];
        hop::mbar_expect_tx(bar, 2 * kC * hop::kBoxBytes + 2 * kQM * 4);
        unsigned char* qb = smem + L::kQ + ring.stage * 2 * L::kQBytes;
        unsigned char* db = qb + L::kQBytes;
        for (int c = 0; c < kC; ++c) {
          const int at = c * kQM * hop::kRowBytes;
          hop::tma_load(&tm_q, bar, qb + at, c * hop::kBox, qt * kQM, h, b);
          hop::tma_load(&tm_do, bar, db + at, c * hop::kBox, qt * kQM, h,
                        b);
        }
        float* rows = reinterpret_cast<float*>(smem + L::kRows) +
                      ring.stage * 2 * kQM;
        hop::bulk_load(rows, lse2 + prow + qt * kQM, kQM * 4, bar);
        hop::bulk_load(rows + kQM, dcap + prow + qt * kQM, kQM * 4, bar);
        ring.advance();
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + w * 64;                 // the warpgroup's keys
  int key[2];
  bool key_vis[2];   // keys past Sk are never stored: no test needed
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = kw0 + warp * 16 + g + 8 * hh;
    key_vis[hh] = mrow == nullptr || key[hh] >= Sk || mrow[key[hh]] != 0;
  }
  const bool warp_vis = __all_sync(0xffffffffu, key_vis[0] && key_vis[1]);
  const uint32_t k_addr = hop::smem_u32(smem + L::kK) + w * 64 *
                          hop::kRowBytes;
  const uint32_t v_addr = hop::smem_u32(smem + L::kV) + w * 64 *
                          hop::kRowBytes;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  hop::mbar_wait(kv_full, 0);
  hop::Ring<kStages> ring;
  for (int r = 0; r < rep; ++r) {
    for (int qt = qt0; qt < n_qt; ++qt) {
      hop::mbar_wait(&full[ring.stage], ring.phase);
      const int i0 = qt * kQM;
      // causal: no query of the tile sees a key of this warpgroup
      if (!(causal && kw0 > i0 + kQM - 1 + off)) {
        const uint32_t qb = hop::smem_u32(smem + L::kQ) +
                            ring.stage * 2 * L::kQBytes;
        const uint32_t db = qb + L::kQBytes;
        const float* rows = reinterpret_cast<const float*>(
                                smem + L::kRows) + ring.stage * 2 * kQM;
        float s[kQM / 2], dp[kQM / 2];   // keys x queries
        hop::wg_fence();
#pragma unroll
        for (int ks = 0; ks < hop::k_steps(HD); ++ks)
          hop::Wgmma<kQM, T>::ss(
              s, hop::desc_k(hop::k_step_addr(k_addr, kKN, ks)),
              hop::desc_k(hop::k_step_addr(qb, kQM, ks)), ks > 0);
#pragma unroll
        for (int ks = 0; ks < hop::k_steps(HD); ++ks)
          hop::Wgmma<kQM, T>::ss(
              dp, hop::desc_k(hop::k_step_addr(v_addr, kKN, ks)),
              hop::desc_k(hop::k_step_addr(db, kQM, ks)), ks > 0);
        hop::wg_commit();
        hop::wg_wait();
        hop::fence_regs(s);
        hop::fence_regs(dp);
        // every query of the tile sees every key of this warp
        const bool all_vis =
            warp_vis && (!causal || kw0 + 63 <= i0 + off);
#pragma unroll
        for (int i = 0; i < kQM / 2; ++i) {
          const int hh = (i >> 1) & 1;
          const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
          float p = hop::exp2_fast(s[i] * scale_log2 - rows[qc]);
          if (!all_vis) {
            const bool vis =
                key_vis[hh] && (!causal || key[hh] <= i0 + qc + off);
            p = vis ? p : 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - rows[kQM + qc]) * scale;
        }
        uint32_t pa[kQM / 16][4], da[kQM / 16][4];
        hop::pack_a<kQM, T>(s, pa);
        hop::pack_a<kQM, T>(dp, da);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < kQM / 16; ++kk)
          hop::Wgmma<HD, T>::rs(dva, pa[kk],
                             hop::desc_mn(db + kk * 16 * hop::kRowBytes,
                                          kQM * hop::kRowBytes));
#pragma unroll
        for (int kk = 0; kk < kQM / 16; ++kk)
          hop::Wgmma<HD, T>::rs(dka, da[kk],
                             hop::desc_mn(qb + kk * 16 * hop::kRowBytes,
                                          kQM * hop::kRowBytes));
        hop::wg_commit();
        hop::wg_wait();
        hop::fence_regs(dva);
        hop::fence_regs(dka);
        hop::fence_regs(pa);
        hop::fence_regs(da);
      }
      hop::mbar_arrive(&empty[ring.stage]);
      ring.advance();
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= Sk) continue;
    T* dkr = dk + dks.at(b, key[hh], kvh);
    T* dvr = dv + dvs.at(b, key[hh], kvh);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkr + c) =
          hop::pack2<T>(dka[4 * j + 2 * hh], dka[4 * j + 2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvr + c) =
          hop::pack2<T>(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
    }
  }
}

// -------------------------------------------------------------------- dq
// Q, dO [chunk][128][64]; per stage K then V [chunk][64][64]; barriers;
// the key-tile states.
template <int HD>
struct DqSmem {
  static constexpr int kC = hop::chunks(HD);
  static constexpr int kQBytes = kC * kDqM * hop::kRowBytes;
  static constexpr int kKBytes = kC * kDqN * hop::kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQBytes;
  static constexpr int kKV = 2 * kQBytes;             // + stage * 2 * kKBytes
  static constexpr int kBars = kKV + kStages * 2 * kKBytes;
  static constexpr int kState = kBars + 8 * (1 + 2 * kStages);
  static int bytes(int n_state) {
    return kState + ((n_state + 15) & ~15) + 1024;
  }
};

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse2, const float* __restrict__ dcap,
          const unsigned char* __restrict__ key_mask, T* __restrict__ dq,
          int Sq, int Sk, int H, int KV, Strides dqs, float scale,
          int causal) {
  using L = DqSmem<HD>;
  constexpr int kC = L::kC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  unsigned char* tile_state = smem + L::kState;

  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int kvh = head / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kDqM;
  const int off = Sk - Sq;
  const int Sq_pad = padded(Sq);
  const float scale_log2 = scale * hop::kLog2e;
  const int n_tiles = hop::key_tiles(m0, kDqM, kDqN, Sq, Sk, causal);
  const unsigned char* mrow =
      key_mask != nullptr ? key_mask + (size_t)b * Sk : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kConsumers);
    }
    hop::fence_barrier_init();
  }
  if (mrow != nullptr)
    hop::scan_key_tiles<kDqN>(mrow, Sk, n_tiles, tile_state);
  __syncthreads();
  auto state = [&](int t) -> int {
    if (mrow != nullptr) return tile_state[t];
    return (t + 1) * kDqN <= Sk ? 2 : 1;
  };

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    hop::mbar_expect_tx(q_full,
                        2 * kC * (kDqM / hop::kBox) * hop::kBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kDqM / hop::kBox; ++r) {
        const int at = (c * kDqM + r * hop::kBox) * hop::kRowBytes;
        hop::tma_load(&tm_q, q_full, smem + L::kQ + at, c * hop::kBox,
                      m0 + r * hop::kBox, head, b);
        hop::tma_load(&tm_do, q_full, smem + L::kDo + at, c * hop::kBox,
                      m0 + r * hop::kBox, head, b);
      }
    hop::Ring<kStages> ring;
    for (int t = 0; t < n_tiles; ++t) {
      if (state(t) == 0) continue;
      hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      uint64_t* bar = &full[ring.stage];
      hop::mbar_expect_tx(bar, 2 * kC * hop::kBoxBytes);
      unsigned char* kb = smem + L::kKV + ring.stage * 2 * L::kKBytes;
      for (int c = 0; c < kC; ++c) {
        const int at = c * kDqN * hop::kRowBytes;
        hop::tma_load(&tm_k, bar, kb + at, c * hop::kBox, t * kDqN, kvh, b);
        hop::tma_load(&tm_v, bar, kb + L::kKBytes + at, c * hop::kBox,
                      t * kDqN, kvh, b);
      }
      ring.advance();
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r_base = m0 + w * 64;
  const int row0 = r_base + warp * 16 + g;
  const uint32_t q_addr = hop::smem_u32(smem + L::kQ) +
                          w * 64 * hop::kRowBytes;
  const uint32_t do_addr = hop::smem_u32(smem + L::kDo) +
                           w * 64 * hop::kRowBytes;
  float lrow[2], crow[2];
  const size_t prow = ((size_t)b * H + head) * Sq_pad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lrow[hh] = lse2[prow + row0 + 8 * hh];   // rows < Sq_pad
    crow[hh] = dcap[prow + row0 + 8 * hh];
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  hop::mbar_wait(q_full, 0);
  hop::Ring<kStages> ring;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = state(t);
    if (st == 0) continue;
    hop::mbar_wait(&full[ring.stage], ring.phase);
    const int k0 = t * kDqN;
    if (!(causal && k0 > r_base + 63 + off)) {
      const uint32_t kb = hop::smem_u32(smem + L::kKV) +
                          ring.stage * 2 * L::kKBytes;
      const uint32_t vb = kb + L::kKBytes;
      float s[kDqN / 2], dp[kDqN / 2];   // queries x keys
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < hop::k_steps(HD); ++ks)
        hop::Wgmma<kDqN, T>::ss(
            s, hop::desc_k(hop::k_step_addr(q_addr, kDqM, ks)),
            hop::desc_k(hop::k_step_addr(kb, kDqN, ks)), ks > 0);
      if constexpr (std::is_same<T, hop::f16>::value) {
        hop::wg_commit();
        hop::wg_wait();
        hop::fence_regs(s);
        // f16: dP's k16 steps each into a fresh accumulator, summed in
        // f32. The tensor core's accumulation truncates against the
        // running sum, and dS = P (dP - dcap) cancels where a row sees
        // few keys (causal row 0: dP = dcap exactly), so the truncation
        // residue reached 1.4-1.7e-3 of the floored scale at hd 72 (five
        // k16 steps), past F16_TOL; f16's 1.25e-3 sees what bf16's 2e-2
        // does not
#pragma unroll
        for (int ks = 0; ks < hop::k_steps(HD); ++ks) {
          float t[kDqN / 2];
          hop::wg_fence();
          hop::Wgmma<kDqN, T>::ss(
              t, hop::desc_k(hop::k_step_addr(do_addr, kDqM, ks)),
              hop::desc_k(hop::k_step_addr(vb, kDqN, ks)), false);
          hop::wg_commit();
          hop::wg_wait();
          hop::fence_regs(t);
#pragma unroll
          for (int i = 0; i < kDqN / 2; ++i) dp[i] = ks ? dp[i] + t[i] : t[i];
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < hop::k_steps(HD); ++ks)
          hop::Wgmma<kDqN, T>::ss(
              dp, hop::desc_k(hop::k_step_addr(do_addr, kDqM, ks)),
              hop::desc_k(hop::k_step_addr(vb, kDqN, ks)), ks > 0);
        hop::wg_commit();
        hop::wg_wait();
        hop::fence_regs(s);
        hop::fence_regs(dp);
      }
      const bool all_vis =
          st == 2 && (!causal || k0 + kDqN - 1 <= r_base + off);
#pragma unroll
      for (int i = 0; i < kDqN / 2; ++i) {
        const int hh = (i >> 1) & 1;
        float p = hop::exp2_fast(s[i] * scale_log2 - lrow[hh]);
        if (!all_vis) {
          const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const bool vis = key < Sk &&
                           (!causal || key <= row0 + 8 * hh + off) &&
                           (mrow == nullptr || mrow[key] != 0);
          p = vis ? p : 0.f;
        }
        dp[i] = p * (dp[i] - crow[hh]) * scale;
      }
      uint32_t da[kDqN / 16][4];
      hop::pack_a<kDqN, T>(dp, da);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kDqN / 16; ++kk)
        hop::Wgmma<HD, T>::rs(dqa, da[kk],
                           hop::desc_mn(kb + kk * 16 * hop::kRowBytes,
                                        kDqN * hop::kRowBytes));
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(dqa);
      hop::fence_regs(da);
    }
    hop::mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + 8 * hh;
    if (i >= Sq) continue;
    T* out = dq + dqs.at(b, i, head);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t4) =
          hop::pack2<T>(dqa[4 * j + 2 * hh], dqa[4 * j + 2 * hh + 1]);
  }
}

// st: the element strides of q, k, v, out, dout, dq, dk, dv, in that order
template <class T, int HD>
int launch(const CUtensorMap* tm, const T* o, const T* dout,
           const float* lse, float* scratch, T* dq, T* dk, T* dv,
           const unsigned char* mask, int B, int Sq, int Sk, int H, int KV,
           const Strides* st, float scale, int causal, cudaStream_t stream) {
  const int Sq_pad = padded(Sq);
  const long rows = (long)B * H * Sq_pad;
  float* lse2 = scratch;
  float* dcap = scratch + rows;
  dcap_kernel<T, HD><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      o, dout, lse, lse2, dcap, rows, Sq, Sq_pad, H, st[3], st[4]);
  const int smem1 = DkdvSmem<HD>::kBytes;
  static int granted1[64], granted2[64];
  cudaError_t err = hop::allow_smem(dkdv_kernel<T, HD>, smem1, granted1);
  if (err != cudaSuccess) return (int)err;
  dim3 g1(B * KV, (Sk + kKN - 1) / kKN);
  dkdv_kernel<T, HD><<<g1, kThreads, smem1, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse2, dcap, mask, dk, dv, Sq, Sk, H, KV,
      st[6], st[7], scale, causal);
  const int smem2 =
      DqSmem<HD>::bytes(mask != nullptr ? (Sk + kDqN - 1) / kDqN : 0);
  err = hop::allow_smem(dq_kernel<T, HD>, smem2, granted2);
  if (err != cudaSuccess) return (int)err;
  dim3 g2(B * H, (Sq + kDqM - 1) / kDqM);
  dq_kernel<T, HD><<<g2, kThreads, smem2, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse2, dcap, mask, dq, Sq, Sk, H, KV, st[5],
      scale, causal);
  return (int)cudaGetLastError();
}

template <class T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* scratch, void* dq, void* dk,
        void* dv, const void* key_mask, int B, int Sq, int Sk, int H, int KV,
        int hd, const long long* maps, const long long* strides,
        float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm[4];
  const void* bases[4] = {q, k, v, dout};
  for (int t = 0; t < 4; ++t)
    if (!hop::encode_map(&tm[t], bases[t], maps + 7 * t,
                         hop::tma_type<T>()))
      return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
#define PTT_ARGS                                                          \
  tm, static_cast<const T*>(o), static_cast<const T*>(dout),              \
      static_cast<const float*>(lse), static_cast<float*>(scratch),       \
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),      \
      static_cast<const unsigned char*>(key_mask), B, Sq, Sk, H, KV, st,  \
      scale, causal, s
  if (hd == 128) return launch<T, 128>(PTT_ARGS);
  if (hd == 72) return launch<T, 72>(PTT_ARGS);
  if (hd == 64) return launch<T, 64>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out, dout, dq, dk and dv all bf16 (flash_bwd_bf16) or all f16
// (flash_bwd_f16). `scratch`: 2 * B * H * Sq_pad f32 (Sq_pad: Sq rounded
// up to 128; kernels/flash_attention.py::bwd_scratch_numel); `key_mask`
// (uint8 [B, Sk]) may be null; `maps` is a host array of 28 int64: the
// seven tensor-map values (kernels/flash_attention.py::tma_dims) of q, k,
// v and dout in turn; `strides` is a host array of 24 int64: the batch,
// sequence and head element strides of q, k, v, out, dout, dq, dk and
// dv, in that order. Returns the launches' cudaError_t (0 on success;
// cudaErrorInvalidValue when a tensor map is refused).
#define PTT_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* o, const void* dout, const void* lse,      \
                      void* scratch, void* dq, void* dk, void* dv,           \
                      const void* key_mask, int B, int Sq, int Sk, int H,    \
                      int KV, int hd, const long long* maps,                 \
                      const long long* strides, float scale, int causal,     \
                      void* stream) {                                        \
    return run<T>(q, k, v, o, dout, lse, scratch, dq, dk, dv, key_mask, B,   \
                  Sq, Sk, H, KV, hd, maps, strides, scale, causal, stream);  \
  }
PTT_BWD_ENTRY(flash_bwd_bf16, hop::bf16)
PTT_BWD_ENTRY(flash_bwd_f16, hop::f16)
#undef PTT_BWD_ENTRY
