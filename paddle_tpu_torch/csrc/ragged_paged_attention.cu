// Ragged paged attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/nlp/ragged_attention.py::_rpa_kernel (pallas_call
// in ragged_paged_attention) without its int8-pool and suffix-slab
// options: every decode row, every fused prefill+decode batch and every
// chunked-prefill continuation of the serving path.
//
// Computes, for each row r and query p: query head h of q[r, p] attends to
// the chain keys j <= positions[r, p] of KV head h / (H / KV), where chain
// key j lives at pool block table[r, j / bs], slot j % bs. Invalid queries
// (valid[r, p] == 0) write zeros. q [R, P, H, hd], pools [N, bs, KV, hd]
// (one layer), out [R, P, H, hd] bf16; table, positions int32; valid one
// byte per query. The pool write of the same call happens before this
// kernel (nlp/paged.py::_attention_paged), so a cold row sees its own keys.
//
// Bound on the H100: memory. Each (row, KV head) reads its live K and V
// once, bs * hd * 2 bytes per block each, for ~4 * rep flops a byte, far
// below the ~295 flop/byte ridge; a decode step of 8 rows of 1024 keys at
// Llama-3-8B widths moves 33.5 MB, 0.010 ms at 3.35 TB/s. The TPU kernel
// reads only the LIVE chain instead of gathering the table's full width,
// and so does this one. What the card needs beyond that is enough bytes in
// flight: a decode step has only R * KV (row, KV head) pairs.
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
//  * The query tile is sized to the work. A narrow tile (P * rep <= 16:
//    decode) is one GQA group of 16 / rep positions, 16 rows (the mma M);
//    its 4 warps take 16 keys each of every stage and are merged through
//    shared memory at the end. A wide tile (chunked and fused prefill) is
//    64 rows, 16 a warp, each warp taking all 64 keys of a stage.
//  * The copies are pipelined: a ring of 3 (hd 128) or 4 (hd 64) stages
//    of 64 keys of K and V, filled with cp.async (16-byte LDGSTS, which
//    suits the pool's 256- or 128-byte rows; zero-filled past the split),
//    so two stages are in flight while a third one's products run. A
//    split's table entries are read into shared memory once, before the
//    ring starts (the int8 pool's per-block scales would sit beside them).
//  * Outputs. A query whose visible keys all lie in split 0 gets its final
//    bf16 output from split 0, as does an invalid query (zeros). Any other
//    query gets, from each split holding some of its keys, an f32 partial:
//    O unnormalised, the running max in log2 units and the sum. Then
//    ragged_merge_kernel folds each such query's partials in split order.
//    No atomics: two runs give identical bits.
//  * Products on mma.sync m16n8k16 (attention_core.cuh), online softmax
//    in f32; V's B fragments by ldmatrix.trans. The work is memory bound,
//    and wgmma's M of 64 would be mostly padding in decode.
#include "attention_core.cuh"
#include "hopper_core.cuh"

namespace {

using ptt::bf16;
using ptt::kNegInf;

constexpr int kThreads = 128;     // 4 warps
constexpr int kStageKeys = 64;    // keys of K and of V per ring stage

// A staged K or V row is HD + 8 elements, so the 8 rows of a fragment
// load or of an ldmatrix start 4 banks apart.
template <int HD>
struct Ring {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  static constexpr int kRow = HD + 8;
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kStage = 2 * kStageKeys * kRow;   // K, then V
  static constexpr int kBytes = kStages * kStage * (int)sizeof(bf16);
};

// 16 bytes from device to shared memory, asynchronously; zeros if !full.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
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

// Four 8x8 bf16 matrices, transposed; lane l gives the address of row
// l % 8 of matrix l / 8, and r[i] holds matrix i's B fragment half.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hop::smem_u32(p))
      : "memory");
}

// One warp's 16 query rows: Q's A fragments, the O accumulator, and for
// rows g and g + 8 of this lane the running max (log2 units), the sum
// and the last chain key the row sees (-1: none).
template <int HD>
struct Rows {
  uint32_t q[HD / 16][4];
  float o[HD / 8][4];
  float m[2], l[2];
  int lim[2];
};

// Fold NK staged keys into a warp's rows: K rows ks, V rows vs (row
// stride Ring<HD>::kRow), chain key key0 first. Scores are scaled by
// scale * log2(e) so exp2 gives the weights.
template <int HD, int NK>
__device__ __forceinline__ void fold(Rows<HD>& st, const bf16* ks,
                                     const bf16* vs, int key0,
                                     float scale_log2) {
  constexpr int kRow = Ring<HD>::kRow;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[NK / 8][4];
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt) {
      const bf16* kr = ks + (nt * 8 + g) * kRow + kk * 16 + 2 * t;
      ptt::mma_bf16(s[nt], st.q[kk], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
  // mask (key j visible to a row iff j <= its lim), then each row's max
  // over these keys: a row's scores sit in the 4 lanes of its quad
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = key0 + nt * 8 + 2 * t + (e & 1);
      s[nt][e] = j <= st.lim[h] ? s[nt][e] * scale_log2 : kNegInf;
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
  // O += P V: the accumulators of key n-tiles 2kk, 2kk+1 are the A
  // fragment of k-step kk; V's B fragments of head_dim n-tiles 2dp,
  // 2dp+1 come from one transposed ldmatrix (keys 0-7 / 8-15 x columns
  // 0-7 / 8-15 of the pair)
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    a[0] = ptt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = ptt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = ptt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = ptt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (kk * 16 + vr) * kRow + dp * 16 + vc);
      ptt::mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      ptt::mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Where a block's results go.
struct Sink {
  bf16* out;
  float* part_o;           // [n_splits, R * P * H, hd] f32
  float* part_ml;          // [n_splits, R * P * H, 2]: max, sum
  const int* positions;
  const unsigned char* valid;
  size_t rows;             // R * P * H
  int max_keys, split_keys, split;

  // Splits holding query qi's visible keys (0: an invalid query).
  __device__ __forceinline__ int splits_of(int qi) const {
    if (!valid[qi]) return 0;
    const int n = min(positions[qi] + 1, max_keys);
    return n > 0 ? (n + split_keys - 1) / split_keys : 0;
  }

  // Columns c.. c + NC - 1 of output row `row` ((r * P + p) * H + head),
  // whose query needs `ns` splits: O unnormalised, with its max and sum.
  template <int HD, int NC>
  __device__ __forceinline__ void put(const float (&o)[NC], float mx,
                                      float sum, int ns, size_t row,
                                      int c) const {
    if (ns <= 1) {
      if (split != 0) return;
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      uint32_t w[NC / 2];
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        w[i] = ptt::pack_bf16(o[2 * i] * inv, o[2 * i + 1] * inv);
      bf16* dst = out + row * HD + c;
      if constexpr (NC == 4)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else if (split < ns) {
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

template <int HD, bool NARROW>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(const bf16* __restrict__ q,
                    const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ positions,
                    const unsigned char* __restrict__ valid,
                    bf16* __restrict__ out, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int P, int H, int KV, int N,
                    int bs, int M, int split_keys, int n_splits,
                    float scale_log2) {
  using RG = Ring<HD>;
  constexpr int kTileRows = NARROW ? 16 : 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* s_tab = reinterpret_cast<int*>(smem + RG::kBytes);
  __shared__ int s_live;
  const int rep = H / KV, tile_pos = kTileRows / rep;
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int split = blockIdx.z % n_splits;
  const int p0 = blockIdx.z / n_splits * tile_pos;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int max_keys = M * bs;

  // One round trip before the walk: the tile's positions (its live
  // chain: keys up to its largest valid position) and the table entries
  // of this split's whole key range, loaded together.
  const int k_lo = split * split_keys;
  const int kb0 = k_lo / bs;
  const int nb = k_lo < max_keys
                     ? (min(k_lo + split_keys, max_keys) - 1) / bs - kb0 + 1
                     : 0;
  int seen = 0;
  if (threadIdx.x < tile_pos && p0 + threadIdx.x < P) {
    const int i = r * P + p0 + threadIdx.x;
    const int ok = valid[i], pos = positions[i];
    seen = ok ? pos + 1 : 0;
  }
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  if (seen > 0) atomicMax(&s_live, seen);
  for (int i = threadIdx.x; i < nb; i += kThreads)
    s_tab[i] = min(max(table[(size_t)r * M + kb0 + i], 0), N - 1);
  __syncthreads();
  const int live = min(s_live, max_keys);
  if (split > 0 && k_lo >= live) return;    // split 0 writes the finals
  const int k_hi = min(k_lo + split_keys, live);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kStageKeys - 1) /
                                        kStageKeys : 0;

  // Stage `tile` of the split into ring slot `slot`: each thread copies
  // one 16-byte column chunk of every (kThreads / chunks)-th key.
  constexpr int kChunks = HD / 8;
  const int chunk = threadIdx.x % kChunks;
  auto load_stage = [&](int tile, int slot) {
    bf16* ks = ring + slot * RG::kStage;
    bf16* vs = ks + kStageKeys * RG::kRow;
#pragma unroll
    for (int j = threadIdx.x / kChunks; j < kStageKeys;
         j += kThreads / kChunks) {
      const int key = k_lo + tile * kStageKeys + j;
      const bool in = key < k_hi;
      size_t off = 0;
      if (in) {
        const int b = key / bs;
        off = (((size_t)s_tab[b - kb0] * bs + (key - b * bs)) * KV + kvh) *
                  HD + chunk * 8;
      }
      cp_async16(ks + j * RG::kRow + chunk * 8, k_pool + off, in);
      cp_async16(vs + j * RG::kRow + chunk * 8, v_pool + off, in);
    }
  };
#pragma unroll
  for (int i = 0; i < RG::kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i, i);
    cp_async_commit();
  }

  // this warp's rows, loaded while the first stages are in flight: tile
  // row rr is position p0 + rr / rep, head kvh * rep + rr % rep
  const int row0 = NARROW ? 0 : warp * 16;
  Rows<HD> st;
  {
    const bf16* qr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + g + 8 * h, p = p0 + rr / rep;
      qr[h] = nullptr;
      st.lim[h] = -1;
      if (p < P) {
        const int i = r * P + p;
        qr[h] = q + ((size_t)i * H + kvh * rep + rr % rep) * HD;
        if (valid[i]) st.lim[h] = positions[i];
      }
    }
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
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      st.o[nt][0] = st.o[nt][1] = st.o[nt][2] = st.o[nt][3] = 0.f;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<RG::kStages - 2>();       // stage `tile` has landed
    __syncthreads();                        // and the slot refilled next
                                            // is no longer read
    const int next = tile + RG::kStages - 1;
    if (next < n_tiles) load_stage(next, next % RG::kStages);
    cp_async_commit();
    const bf16* ks = ring + (tile % RG::kStages) * RG::kStage;
    const bf16* vs = ks + kStageKeys * RG::kRow;
    const int key0 = k_lo + tile * kStageKeys;
    if (NARROW)
      fold<HD, 16>(st, ks + warp * 16 * RG::kRow, vs + warp * 16 * RG::kRow,
                   key0 + warp * 16, scale_log2);
    else
      fold<HD, 64>(st, ks, vs, key0, scale_log2);
  }
  cp_async_wait<0>();
  // the merge may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();                          // the ring is free

  const Sink sink{out, part_o, part_ml, positions, valid,
                  (size_t)gridDim.x * P * H, max_keys, split_keys, split};
  if (!NARROW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + g + 8 * h, p = p0 + rr / rep;
      if (p >= P) continue;
      const int qi = r * P + p, ns = sink.splits_of(qi);
      const size_t row = (size_t)qi * H + kvh * rep + rr % rep;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const float o2[2] = {st.o[nt][2 * h], st.o[nt][2 * h + 1]};
        sink.put<HD, 2>(o2, st.m[h], st.l[h], ns, row, nt * 8 + 2 * t);
      }
    }
    return;
  }
  // narrow: the 4 warps' partials over the same 16 rows, merged in warp
  // order through shared memory
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
  const int rows = min(kTileRows, (P - p0) * rep);
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
    sink.put<HD, 4>(o4, mx, sum, sink.splits_of(qi),
                    (size_t)qi * H + kvh * rep + rr % rep, c);
  }
}

// One warp per output row: the query's partials of splits 0.. ns - 1,
// folded in that order (rows whose query needs one split or none were
// written by ragged_split_kernel).
template <int HD>
__global__ void __launch_bounds__(kThreads)
ragged_merge_kernel(const int* __restrict__ positions,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ part_o,
                    const float* __restrict__ part_ml,
                    bf16* __restrict__ out, int rows, int H, int max_keys,
                    int split_keys) {
  constexpr int kPer = HD / 32;             // columns a lane: 4 or 2
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int qi = row / H;
  if (!valid[qi]) return;
  const int n = min(positions[qi] + 1, max_keys);
  const int ns = n > 0 ? (n + split_keys - 1) / split_keys : 0;
  if (ns <= 1) return;
  // launched as a programmatic dependent of ragged_split_kernel: wait for
  // its partials (a no-op when launched plainly)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = (threadIdx.x & 31) * kPer;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s)
    mx = fmaxf(mx, part_ml[2 * ((size_t)s * rows + row)]);
  float sum = 0.f, o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  for (int s = 0; s < ns; ++s) {
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
    for (int i = 0; i < kPer; ++i) o[i] += f * v[i];
  }
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  bf16* dst = out + (size_t)row * HD + c;
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i)
    reinterpret_cast<uint32_t*>(dst)[i] =
        ptt::pack_bf16(o[2 * i] * inv, o[2 * i + 1] * inv);
}

template <int HD, bool NARROW>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* positions,
                   const unsigned char* valid, void* o, float* part_o,
                   float* part_ml, int R, int P, int H, int KV, int N,
                   int bs, int M, int split_keys, int n_splits, float scale,
                   cudaStream_t stream) {
  static int granted[64] = {};
  const int tile_pos = (NARROW ? 16 : 64) / (H / KV);
  const int n_pt = (P + tile_pos - 1) / tile_pos;
  const int smem = Ring<HD>::kBytes +
                   4 * ((split_keys + bs - 1) / bs + 1);
  cudaError_t err =
      hop::allow_smem(ragged_split_kernel<HD, NARROW>, smem, granted);
  if (err != cudaSuccess) return err;
  ragged_split_kernel<HD, NARROW>
      <<<dim3(R, KV, n_pt * n_splits), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), table, positions, valid,
      static_cast<bf16*>(o), part_o, part_ml, P, H, KV, N, bs, M,
      split_keys, n_splits, scale * ptt::kLog2e);
  if (n_splits > 1) {
    // a programmatic dependent launch: the merge's blocks are scheduled
    // as the split kernel's finish their walks, and wait for its results
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = R * P * H;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((rows + kThreads / 32 - 1) / (kThreads / 32));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ragged_merge_kernel<HD>, positions, valid,
                              static_cast<const float*>(part_o),
                              static_cast<const float*>(part_ml),
                              static_cast<bf16*>(o), rows, H, M * bs,
                              split_keys);
  }
  return cudaGetLastError();
}

}  // namespace

// The host's split plan (nlp/ragged_attention.py::split_plan) gives
// `narrow` (16-row query tiles; H / KV must divide 16), `split_keys` (a
// positive multiple of 64) and `n_splits`; with n_splits > 1, part_o and
// part_ml are f32 [n_splits, R * P * H, hd] and [n_splits, R * P * H, 2]
// scratch. H / KV must divide 64. Returns the launches' cudaError_t (0 on
// success).
extern "C" int ragged_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* positions, const void* valid, void* o,
    void* part_o, void* part_ml, int R, int P, int H, int KV, int hd,
    int N, int bs, int M, int narrow, int split_keys, int n_splits,
    float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || 64 % (H / KV) != 0 ||
      (narrow && 16 % (H / KV) != 0) || split_keys <= 0 ||
      split_keys % kStageKeys != 0 || n_splits < 1 || bs < 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  const unsigned char* val = static_cast<const unsigned char*>(valid);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_ml);
#define PTT_RAGGED(HD, NW)                                                 \
  launch<HD, NW>(q, k_pool, v_pool, tab, pos, val, o, po, pm, R, P, H, KV, \
                 N, bs, M, split_keys, n_splits, scale, s)
  cudaError_t err;
  if (hd == 128)
    err = narrow ? PTT_RAGGED(128, true) : PTT_RAGGED(128, false);
  else if (hd == 64)
    err = narrow ? PTT_RAGGED(64, true) : PTT_RAGGED(64, false);
  else
    err = cudaErrorInvalidValue;
#undef PTT_RAGGED
  return (int)err;
}
