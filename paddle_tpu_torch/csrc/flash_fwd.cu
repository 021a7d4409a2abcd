// GQA flash-attention forward for Hopper (sm_90a): causal, or
// bidirectional with an optional key-padding mask, in either layout.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::_flash_fwd_kernel
// (pallas_call in _fwd_call) on the serving path's cold prefill
// (nlp/paged.py::_attention_paged, is_prefill=True), in the training
// forward (nlp/llama.py::_attention), where it also writes the LSE, in the
// eager API's flash_attention / scaled_dot_product_attention, in the
// ERNIE encoder (nlp/ernie.py::_encoder_layer: head-major, key-masked)
// and in DiT's blocks (mix/dit.py::_block: head-major, non-causal, hd 72).
//
// Computes out[b, i, h] = softmax(q[b, i, h] . k[b, :, h // rep]^T * scale
// over the visible keys) . v[b, :, h // rep]. Causal: key j is visible to
// query i when j <= i + (Sk - Sq), the bottom-right alignment of mha_ref.
// With a non-null `key_mask` (uint8 [B, Sk], nonzero = visible), key j of
// batch row b is visible to every query of that row only where
// key_mask[b, j] != 0; a row that sees no key writes zeros and an LSE of
// -1e30, as the TPU kernel does (mha_ref would give uniform attention).
// q/out [B, Sq, H, hd] and k/v [B, Sk, KV, hd] ('bshd') or [B, H, Sq, hd]
// and [B, KV, Sk, hd] ('bhsd'): TMA reads q, k and v through tensor maps
// built from their strides, and out is written through its strides, so
// neither layout is copied into the other. bf16 or f16 in and out (one
// type for q, k, v and out: flash_fwd_bf16 and flash_fwd_f16, the same
// kernel template instantiated for each, as the TPU kernel computes in its
// input's dtype); scores and accumulation f32, P rounded to the input type
// as the A operand of P.V. With a non-null `lse` [B, H, Sq] (f32) it also writes
// each row's log-sum-exp of the scaled scores, the residual of the
// backward (flash_bwd.cu), in the domain the TPU kernel keeps it.
// head_dim 64, 72 (DiT-XL/2's 1152 / 16) or 128. Query head h reads KV
// head h / (H / KV): the expanded K/V is never built. Rows and keys past
// Sq / Sk are zero-filled by TMA and masked here, so any Sq and Sk run
// without padding copies.
//
// Bound on the H100: ~4 * hd * (visible pairs) flops per (batch, head)
// against ~4 * S * hd bytes, far above the card's ~295 flop/byte ridge at
// training lengths: tensor-core bound. The first design (2.8-4.9x SDPA's
// time) built the P.V operand from 16-bit shared loads, copied
// tiles synchronously and ran mma.sync only. This design:
//   - a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows and one producer warpgroup, whose one thread
//     issues every TMA copy (setmaxnreg: 24 registers for the producer,
//     240 for the consumers);
//   - Q is loaded once; K and V tiles of 128 keys stream through a
//     two-stage ring of shared tiles (hopper_core.cuh), full/empty
//     mbarriers between producer and consumers, so the next tile's copy
//     overlaps this tile's products;
//   - S = Q K^T on wgmma m64n128k16 from shared memory (both K-major);
//     the online softmax in f32 registers; O += P V on wgmma m64n{hd}k16
//     with P re-packed from S's accumulator into A-fragment registers
//     and V read MN-major (the transpose bit): scores never touch
//     shared or device memory; the two warpgroups' products and
//     softmaxes interleave as the warp schedulers find them;
//   - masking only where needed: a tile wholly visible to every row of a
//     warpgroup (below the causal diagonal, inside Sk, no masked key)
//     takes no per-element test; with a key mask the block first marks
//     the tiles that hold any visible key and walks only those; a
//     warpgroup skips the products of a tile wholly past its diagonal;
//   - the blocks with the most causal work are launched first.
// hd 72: Q K^T takes 5 k16 steps, the fifth over columns 64..79, which
// TMA zero-fills past the tensor's 72 (hopper_core.cuh); P V uses N = 72
// exactly. What holds it back (PERF.md): the softmax is not hidden
// behind the other warpgroup's products. Issuing tile j's S with tile
// j-1's P V (one warpgroup's softmax under its own P V, a third ring
// stage to hold V), taking turns between the warpgroups on named
// barriers, and three consumer warpgroups at hd 64 and 72 were each
// measured no faster than this plain order, so none is kept. Not done
// yet either: TMA stores of O, a persistent grid, and sharing one K/V
// copy among the rep query heads of a group (left to L2).
#include "hopper_core.cuh"

namespace {

using hop::Strides;

constexpr int kBN = 128;        // keys a tile
constexpr int kBM = 128;        // query rows a block: 2 warpgroups x 64
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;

// Shared-memory plan (bytes from a 1024-aligned base): Q [chunk][128][64];
// per stage K then V [chunk][128][64]; the barriers; the key-tile states.
template <int HD>
struct FwdSmem {
  static constexpr int kC = hop::chunks(HD);
  static constexpr int kQBytes = kC * kBM * hop::kRowBytes;
  static constexpr int kKVBytes = kC * kBN * hop::kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQBytes;
  static constexpr int kBars = kKV + kStages * 2 * kKVBytes;
  static constexpr int kState = kBars + 8 * (1 + 2 * kStages);
  static int bytes(int n_state) {
    return kState + ((n_state + 15) & ~15) + 1024;
  }
};

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 T* __restrict__ out, float* __restrict__ lse,
                 const unsigned char* __restrict__ key_mask, int Sq, int Sk,
                 int H, int KV, Strides os, float scale_log2, int causal) {
  using L = FwdSmem<HD>;
  constexpr int kC = L::kC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  unsigned char* tile_state = smem + L::kState;

  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int kvh = head / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heavy blocks first
  const int off = Sk - Sq;
  const int n_tiles = hop::key_tiles(m0, kBM, kBN, Sq, Sk, causal);
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
    hop::scan_key_tiles<kBN>(mrow, Sk, n_tiles, tile_state);
  __syncthreads();
  // 0: no visible key (not walked); 1: per-element test; 2: all visible
  auto state = [&](int t) -> int {
    if (mrow != nullptr) return tile_state[t];
    return (t + 1) * kBN <= Sk ? 2 : 1;
  };

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    hop::mbar_expect_tx(q_full, kC * (kBM / hop::kBox) * hop::kBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kBM / hop::kBox; ++r)
        hop::tma_load(&tm_q, q_full,
                      smem + L::kQ + (c * kBM + r * hop::kBox) *
                                         hop::kRowBytes,
                      c * hop::kBox, m0 + r * hop::kBox, head, b);
    hop::Ring<kStages> ring;
    for (int t = 0; t < n_tiles; ++t) {
      if (state(t) == 0) continue;
      hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      uint64_t* bar = &full[ring.stage];
      hop::mbar_expect_tx(bar, 2 * kC * (kBN / hop::kBox) * hop::kBoxBytes);
      unsigned char* kb = smem + L::kKV + ring.stage * 2 * L::kKVBytes;
      unsigned char* vb = kb + L::kKVBytes;
      for (int c = 0; c < kC; ++c)
        for (int r = 0; r < kBN / hop::kBox; ++r) {
          const int at = (c * kBN + r * hop::kBox) * hop::kRowBytes;
          const int key = t * kBN + r * hop::kBox;
          hop::tma_load(&tm_k, bar, kb + at, c * hop::kBox, key, kvh, b);
          hop::tma_load(&tm_v, bar, vb + at, c * hop::kBox, key, kvh, b);
        }
      ring.advance();
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<240>();
  const int w = threadIdx.x / 128 - 1;           // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r_base = m0 + w * 64;                // the warpgroup's rows
  const int row0 = r_base + warp * 16 + g;       // this thread's rows:
                                                 // row0, row0 + 8
  const uint32_t q_addr = hop::smem_u32(smem + L::kQ) +
                          w * 64 * hop::kRowBytes;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {hop::kNegInf, hop::kNegInf};
  float l_run[2] = {0.f, 0.f};   // this thread's part of the row sums
  hop::mbar_wait(q_full, 0);
  hop::Ring<kStages> ring;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = state(t);
    if (st == 0) continue;
    hop::mbar_wait(&full[ring.stage], ring.phase);
    const int k0 = t * kBN;
    if (!(causal && k0 > r_base + 63 + off)) {
      const uint32_t kb = hop::smem_u32(smem + L::kKV) +
                          ring.stage * 2 * L::kKVBytes;
      const uint32_t vb = kb + L::kKVBytes;
      float s[kBN / 2];
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < hop::k_steps(HD); ++ks)
        hop::Wgmma<kBN, T>::ss(
            s, hop::desc_k(hop::k_step_addr(q_addr, kBM, ks)),
            hop::desc_k(hop::k_step_addr(kb, kBN, ks)), ks > 0);
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(s);
      const bool all_vis =
          st == 2 && (!causal || k0 + kBN - 1 <= r_base + off);
      float mx[2] = {hop::kNegInf, hop::kNegInf};
      if (all_vis) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          s[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int hh = (i >> 1) & 1;
          const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const bool vis = key < Sk &&
                           (!causal || key <= row0 + 8 * hh + off) &&
                           (mrow == nullptr || mrow[key] != 0);
          s[i] = vis ? s[i] * scale_log2 : hop::kNegInf;
          mx[hh] = fmaxf(mx[hh], s[i]);
        }
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        m_new[hh] = fmaxf(m_run[hh], mx[hh]);
        alpha[hh] = exp2f(m_run[hh] - m_new[hh]);
        m_run[hh] = m_new[hh];
        l_run[hh] *= alpha[hh];
      }
      if (all_vis) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = hop::exp2_fast(s[i] - m_new[hh]);
          l_run[hh] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = s[i] > 0.5f * hop::kNegInf ? hop::exp2_fast(s[i] - m_new[hh])
                                            : 0.f;
          l_run[hh] += s[i];
        }
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[kBN / 16][4];
      hop::pack_a<kBN, T>(s, pa);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hop::Wgmma<HD, T>::rs(o, pa[kk],
                           hop::desc_mn(vb + kk * 16 * hop::kRowBytes,
                                        kBN * hop::kRowBytes));
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(o);
      hop::fence_regs(pa);
    }
    hop::mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }

  // epilogue: the row sums over the quad, O / l, the LSE
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    const int i = row0 + 8 * hh;
    if (i >= Sq) continue;
    const float inv = l_run[hh] > 0.f ? 1.f / l_run[hh] : 0.f;
    T* orow = out + os.at(b, i, head);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = hop::pack2<T>(
          o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + head) * Sq + i] =
          l_run[hh] > 0.f ? m_run[hh] * hop::kLn2 + logf(l_run[hh])
                          : hop::kNegInf;
  }
}

template <class T, int HD>
int launch(const CUtensorMap* maps, T* o, float* lse,
           const unsigned char* mask, int B, int Sq, int Sk, int H, int KV,
           Strides os, float scale, int causal, cudaStream_t stream) {
  const int n_state = mask != nullptr ? (Sk + kBN - 1) / kBN : 0;
  const int smem = FwdSmem<HD>::bytes(n_state);
  static int granted[64];
  cudaError_t err = hop::allow_smem(flash_fwd_kernel<T, HD>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], o, lse, mask, Sq, Sk, H, KV, os,
      scale * hop::kLog2e, causal);
  return (int)cudaGetLastError();
}

template <class T>
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* key_mask, int B, int Sq, int Sk, int H, int KV, int hd,
        const long long* maps, const long long* out_strides, float scale,
        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm[3];
  const void* bases[3] = {q, k, v};
  for (int t = 0; t < 3; ++t)
    if (!hop::encode_map(&tm[t], bases[t], maps + 7 * t,
                         hop::tma_type<T>()))
      return (int)cudaErrorInvalidValue;
  Strides os{out_strides[0], out_strides[1], out_strides[2]};
  float* l = static_cast<float*>(lse);
  T* out = static_cast<T*>(o);
  const unsigned char* m = static_cast<const unsigned char*>(key_mask);
  if (hd == 128) return launch<T, 128>(tm, out, l, m, B, Sq, Sk, H, KV, os,
                                       scale, causal, s);
  if (hd == 72) return launch<T, 72>(tm, out, l, m, B, Sq, Sk, H, KV, os,
                                     scale, causal, s);
  if (hd == 64) return launch<T, 64>(tm, out, l, m, B, Sq, Sk, H, KV, os,
                                     scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v and out all bf16 (flash_fwd_bf16) or all f16 (flash_fwd_f16).
// `maps` is a host array of 21 int64: for q, k and v in turn, the seven
// tensor-map values of kernels/flash_attention.py::tma_dims (extents
// head_dim, seq, heads, batch; byte strides of seq, head, batch).
// `out_strides`: the batch, sequence and head element strides of out.
// `lse` and `key_mask` may be null. Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue when a tensor map is refused).
#define PTT_FWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, const void* key_mask, int B, int Sq,       \
                      int Sk, int H, int KV, int hd, const long long* maps, \
                      const long long* out_strides, float scale,            \
                      int causal, void* stream) {                           \
    return run<T>(q, k, v, o, lse, key_mask, B, Sq, Sk, H, KV, hd, maps,    \
                  out_strides, scale, causal, stream);                      \
  }
PTT_FWD_ENTRY(flash_fwd_bf16, hop::bf16)
PTT_FWD_ENTRY(flash_fwd_f16, hop::f16)
#undef PTT_FWD_ENTRY
