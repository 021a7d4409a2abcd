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
// [B, Sq, H, hd] (bf16; or the head-major [B, H, S, hd] of 'bhsd': every
// tensor is read and written through its batch, sequence and head
// strides) and the forward's lse [B, H, Sq] (f32, natural log of the
// scaled scores):
//   P  = exp(scale * Q K^T - lse) where key j is visible to query i
//        (causal: j <= i + Sk - Sq; key mask: key_mask[b, j] != 0), else 0
//   dcap_i = sum_d dO_i * O_i
//   dS = P o (dO V^T - dcap) * scale
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO
// with dK and dV summed over each KV head's rep = H / KV query heads.
// The mask zeroes P, not the scores (the TPU kernels' p re-mask,
// flash_attention.py:417, :486): a masked key gets dK = dV = 0, and a row
// that sees no key (its lse is -1e30) contributes nothing.
// Products on mma.sync.m16n8k16 (bf16 in, f32 accumulate); P and dS are
// rounded to bf16 only as the A operands of the second products. head_dim
// 64, 72 or 128: the contractions over hd (S^T = K Q^T, dP^T = V dO^T,
// S = Q K^T, dP = dO V^T) take ceil(hd / 16) k16 steps over rows whose
// columns past hd are staged as zeros (attention_core.cuh).
//
// Three kernels, in order on the caller's stream:
//   dcap — one warp per (batch, head, query) row: rowsum(dO * O) into an
//          f32 [B, H, Sq] scratch (the XLA op of the TPU wrapper).
//   dkdv — grid (B * KV, 64-key tiles); a block holds its K/V tile in
//          shared memory, each warp 16 keys (their visibilities in
//          registers), and walks the rep query heads
//          of its group and, for each, the 32-query tiles from the causal
//          diagonal on, accumulating dK and dV in f32 registers. GQA needs
//          neither an expanded K/V nor a reduction over the group.
//   dq   — grid (B * H, 64-query tiles), each warp 16 queries with Q and
//          dO fragments in registers, over the 64-key tiles up to the
//          diagonal (K and V staged through shared memory), dQ in f32
//          registers. Like the TPU's split dq kernel it needs no atomics
//          and no f32 dQ buffer, and is deterministic.
//
// Bound on the H100: about 2.5x the forward's tensor-core work (five
// products against two) over the same O(S * hd) bytes, so tensor-core
// bound at training lengths. What this simple version leaves: the dkdv
// blocks re-read each query tile from L2 once per key tile, loads are not
// pipelined against the products, there is no wgmma or TMA, and key tiles
// whose keys are all masked are still walked.
#include "attention_core.cuh"

namespace {

using ptt::bf16;
using ptt::Strides;
using ptt::mma_bf16;
using ptt::pack_bf16;
using ptt::pack_raw;

constexpr int kThreads = 128;   // 4 warps
constexpr int kKeyTile = 64;    // dkdv: keys per block, 16 per warp
constexpr int kQTile = 32;      // dkdv: queries per inner step
constexpr int kQRows = 64;      // dq: queries per block, 16 per warp

// ------------------------------------------------------------------ dcap
// row runs over the [B, H, Sq] order of dcap
template <int HD>
__global__ void __launch_bounds__(kThreads)
dcap_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            float* __restrict__ dcap, long rows, int Sq, int H, Strides os,
            Strides ds) {
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const long bh = row / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const bf16* op = o + os.at(b, i, h);
  const bf16* dp = dout + ds.at(b, i, h);
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < HD; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) dcap[row] = acc;
}

// ------------------------------------------------------------------ dkdv
template <int HD>
struct DkdvSmem {
  static constexpr int kRow = ptt::HeadDim<HD>::kRow;
  bf16 k[kKeyTile][kRow];
  bf16 v[kKeyTile][kRow];
  bf16 q[kQTile][kRow];
  bf16 dout[kQTile][kRow];
  float lse[kQTile];      // lse * log2(e)
  float dcap[kQTile];
};

// Copy `rows` rows of HD bf16 (row r from src(r), or zeros for nullptr)
// into dst[r][...], and zeros into the columns past HD that the k-steps
// read; 16-byte chunks over the block's threads.
template <int HD, int ROWS, class Src>
__device__ __forceinline__ void stage_rows(
    bf16 (*dst)[ptt::HeadDim<HD>::kRow], Src src) {
  constexpr int kChunks = ptt::HeadDim<HD>::kCols / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bf16* p = col < HD ? src(r) : nullptr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p != nullptr) val = *reinterpret_cast<const uint4*>(p + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// A fragment (16 x 16, row-major) of rows row0..row0+15, columns
// ks*16.. of a shared tile whose rows are HeadDim<HD>::kRow elements apart.
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t a[4], const bf16* t,
                                       int row0, int ks) {
  constexpr int kRow = ptt::HeadDim<HD>::kRow;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const bf16* r0 = t + (size_t)(row0 + g) * kRow + ks * 16 + 2 * tq;
  const bf16* r1 = r0 + 8 * kRow;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dcap,
            const unsigned char* __restrict__ key_mask,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
            int H, int KV, Strides qs, Strides ks, Strides vs, Strides dos,
            Strides dks, Strides dvs, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvSmem<HD>& sm = *reinterpret_cast<DkdvSmem<HD>*>(smem_raw);
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int rep = H / KV;
  const int k0 = blockIdx.y * kKeyTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const float scale_log2 = scale * ptt::kLog2e;

  stage_rows<HD, kKeyTile>(sm.k, [&](int r) -> const bf16* {
    const int j = k0 + r;
    return j < Sk ? k + ks.at(b, j, kvh) : nullptr;
  });
  stage_rows<HD, kKeyTile>(sm.v, [&](int r) -> const bf16* {
    const int j = k0 + r;
    return j < Sk ? v + vs.at(b, j, kvh) : nullptr;
  });
  const int wrow = warp * 16;                 // this warp's first tile key
  // this lane's two keys (rows g and g + 8 of its warp's 16): in range
  // and unmasked, held in registers for the whole block
  bool key_vis[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + wrow + g + hh * 8;
    key_vis[hh] =
        j < Sk && (key_mask == nullptr || key_mask[(size_t)b * Sk + j] != 0);
  }

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  // queries that can see this tile's first key: i >= k0 - off
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt0 = q_first / kQTile;
  const int n_qt = (Sq + kQTile - 1) / kQTile;

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i0 = qt * kQTile;
      __syncthreads();   // the previous step is done with the q/dO tiles
      stage_rows<HD, kQTile>(sm.q, [&](int rr) -> const bf16* {
        const int i = i0 + rr;
        return i < Sq ? q + qs.at(b, i, h) : nullptr;
      });
      stage_rows<HD, kQTile>(sm.dout, [&](int rr) -> const bf16* {
        const int i = i0 + rr;
        return i < Sq ? dout + dos.at(b, i, h) : nullptr;
      });
      if (threadIdx.x < kQTile) {
        const int i = i0 + threadIdx.x;
        const size_t li = ((size_t)b * H + h) * Sq + i;
        sm.lse[threadIdx.x] = i < Sq ? lse[li] * ptt::kLog2e : 0.f;
        sm.dcap[threadIdx.x] = i < Sq ? dcap[li] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
      float s[kQTile / 8][4], dp[kQTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < ptt::HeadDim<HD>::kSteps; ++ks) {
        uint32_t ak[4], av[4];
        a_frag<HD>(ak, &sm.k[0][0], wrow, ks);
        a_frag<HD>(av, &sm.v[0][0], wrow, ks);
#pragma unroll
        for (int nt = 0; nt < kQTile / 8; ++nt) {
          const bf16* qr = &sm.q[nt * 8 + g][ks * 16 + 2 * t];
          mma_bf16(s[nt], ak, *reinterpret_cast<const uint32_t*>(qr),
                   *reinterpret_cast<const uint32_t*>(qr + 8));
          const bf16* dr = &sm.dout[nt * 8 + g][ks * 16 + 2 * t];
          mma_bf16(dp[nt], av, *reinterpret_cast<const uint32_t*>(dr),
                   *reinterpret_cast<const uint32_t*>(dr + 8));
        }
      }
      // P^T and dS^T in place of S^T and dP^T
#pragma unroll
      for (int nt = 0; nt < kQTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + wrow + g + (e >> 1) * 8;
          const int jq = nt * 8 + 2 * t + (e & 1);
          const int i = i0 + jq;
          const bool vis =
              key_vis[e >> 1] && i < Sq && (!causal || key <= i + off);
          const float p =
              vis ? exp2f(s[nt][e] * scale_log2 - sm.lse[jq]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - sm.dcap[jq]) * scale;
        }
      }
      // dV += P^T dO, dK += dS^T Q: the accumulators of n-tiles 2kk and
      // 2kk+1 are the A fragment of k-step kk (k = queries)
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        ap[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        ap[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ap[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        ad[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        ad[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        ad[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        ad[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int kq = kk * 16 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const int d = nt * 8 + g;
          mma_bf16(dva[nt], ap, pack_raw(sm.dout[kq][d], sm.dout[kq + 1][d]),
                   pack_raw(sm.dout[kq + 8][d], sm.dout[kq + 9][d]));
          mma_bf16(dka[nt], ad, pack_raw(sm.q[kq][d], sm.q[kq + 1][d]),
                   pack_raw(sm.q[kq + 8][d], sm.q[kq + 9][d]));
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + wrow + g + hh * 8;
    if (key >= Sk) continue;
    bf16* dkr = dk + dks.at(b, key, kvh);
    bf16* dvr = dv + dvs.at(b, key, kvh);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkr + c) =
          pack_bf16(dka[nt][2 * hh], dka[nt][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvr + c) =
          pack_bf16(dva[nt][2 * hh], dva[nt][2 * hh + 1]);
    }
  }
}

// -------------------------------------------------------------------- dq
template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dcap,
          const unsigned char* __restrict__ key_mask, bf16* __restrict__ dq,
          int Sq, int Sk, int H, int KV, Strides qs, Strides ks, Strides vs,
          Strides dos, Strides dqs, float scale, int causal) {
  __shared__ ptt::KVTile<HD> tile;
  __shared__ bool key_vis[ptt::kKeys];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_tile0 = blockIdx.y * kQRows;
  const int row0 = q_tile0 + warp * 16;
  const int off = Sk - Sq;
  const float scale_log2 = scale * ptt::kLog2e;

  // Q and dO A-fragments of this warp's rows g and g + 8, for all of hd
  // (zero past it)
  constexpr int kSteps = ptt::HeadDim<HD>::kSteps;
  uint32_t qa[kSteps][4], da[kSteps][4];
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const bf16* q0 = r0 < Sq ? q + qs.at(b, r0, h) : nullptr;
  const bf16* q1 = r1 < Sq ? q + qs.at(b, r1, h) : nullptr;
  const bf16* d0 = r0 < Sq ? dout + dos.at(b, r0, h) : nullptr;
  const bf16* d1 = r1 < Sq ? dout + dos.at(b, r1, h) : nullptr;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ptt::frag_pair<HD>(q0, c);
    qa[ks][1] = ptt::frag_pair<HD>(q1, c);
    qa[ks][2] = ptt::frag_pair<HD>(q0, c + 8);
    qa[ks][3] = ptt::frag_pair<HD>(q1, c + 8);
    da[ks][0] = ptt::frag_pair<HD>(d0, c);
    da[ks][1] = ptt::frag_pair<HD>(d1, c);
    da[ks][2] = ptt::frag_pair<HD>(d0, c + 8);
    da[ks][3] = ptt::frag_pair<HD>(d1, c + 8);
  }
  float lrow[2], crow[2];
  const size_t lbase = ((size_t)b * H + h) * Sq;
  lrow[0] = r0 < Sq ? lse[lbase + r0] * ptt::kLog2e : 0.f;
  lrow[1] = r1 < Sq ? lse[lbase + r1] * ptt::kLog2e : 0.f;
  crow[0] = r0 < Sq ? dcap[lbase + r0] : 0.f;
  crow[1] = r1 < Sq ? dcap[lbase + r1] : 0.f;

  float dqa[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.f;

  int last = Sk - 1;
  if (causal) last = min(last, q_tile0 + kQRows - 1 + off);
  const int n_tiles = last < 0 ? 0 : last / ptt::kKeys + 1;
  const unsigned char* mrow =
      key_mask != nullptr ? key_mask + (size_t)b * Sk : nullptr;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * ptt::kKeys;
    ptt::load_tile<HD>(
        tile,
        [&](int j) -> const bf16* {
          return k0 + j < Sk ? k + ks.at(b, k0 + j, kvh) : nullptr;
        },
        [&](int j) -> const bf16* {
          return k0 + j < Sk ? v + vs.at(b, k0 + j, kvh) : nullptr;
        });
    if (threadIdx.x < ptt::kKeys) {
      const int key = k0 + threadIdx.x;
      key_vis[threadIdx.x] =
          key < Sk && (mrow == nullptr || mrow[key] != 0);
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kh = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* kr = &tile.k[kh + nt * 8 + g][ks * 16 + 2 * t];
          mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
          const bf16* vr = &tile.v[kh + nt * 8 + g][ks * 16 + 2 * t];
          mma_bf16(dp[nt], da[ks], *reinterpret_cast<const uint32_t*>(vr),
                   *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int i = row0 + g + hh * 8;
          const int kj = kh + nt * 8 + 2 * t + (e & 1);
          const int key = k0 + kj;
          const bool vis =
              i < Sq && key_vis[kj] && (!causal || key <= i + off);
          const float p = vis ? exp2f(s[nt][e] * scale_log2 - lrow[hh]) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - crow[hh]) * scale;
        }
      }
      // dQ += dS K (k = keys; K read as a col-major B operand)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        a[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        a[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        a[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int kr = kh + kk * 16 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const int d = nt * 8 + g;
          mma_bf16(dqa[nt], a, pack_raw(tile.k[kr][d], tile.k[kr + 1][d]),
                   pack_raw(tile.k[kr + 8][d], tile.k[kr + 9][d]));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + g + hh * 8;
    if (i >= Sq) continue;
    bf16* out = dq + dqs.at(b, i, h);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * t) =
          pack_bf16(dqa[nt][2 * hh], dqa[nt][2 * hh + 1]);
  }
}

// st: the strides of q, k, v, out, dout, dq, dk, dv, in that order
template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dcap, bf16* dq,
           bf16* dk, bf16* dv, const unsigned char* mask, int B, int Sq,
           int Sk, int H, int KV, const Strides* st, float scale, int causal,
           cudaStream_t stream) {
  const long rows = (long)B * Sq * H;
  const int warps = kThreads / 32;
  dcap_kernel<HD><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                    stream>>>(o, dout, dcap, rows, Sq, H, st[3], st[4]);
  const int smem = (int)sizeof(DkdvSmem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g1(B * KV, (Sk + kKeyTile - 1) / kKeyTile);
  dkdv_kernel<HD><<<g1, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, mask, dk, dv, Sq, Sk, H, KV, st[0], st[1],
      st[2], st[4], st[6], st[7], scale, causal);
  dim3 g2(B * H, (Sq + kQRows - 1) / kQRows);
  dq_kernel<HD><<<g2, kThreads, 0, stream>>>(
      q, k, v, dout, lse, dcap, mask, dq, Sq, Sk, H, KV, st[0], st[1], st[2],
      st[4], st[5], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dcap is an f32 [B, H, Sq] scratch the caller allocates; `key_mask`
// (uint8 [B, Sk]) may be null; `strides` is a host array of 24 int64: the
// batch, sequence and head strides (in elements) of q, k, v, out, dout,
// dq, dk and dv, in that order. Returns the launches' cudaError_t (0 on
// success).
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dcap, void* dq,
                              void* dk, void* dv, const void* key_mask,
                              int B, int Sq, int Sk, int H, int KV, int hd,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
#define PTT_ARGS                                                          \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),           \
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),     \
      static_cast<float*>(dcap), static_cast<bf16*>(dq),                  \
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),                     \
      static_cast<const unsigned char*>(key_mask), B, Sq, Sk, H, KV, st,  \
      scale, causal, s
  if (hd == 128) return launch<128>(PTT_ARGS);
  if (hd == 72) return launch<72>(PTT_ARGS);
  if (hd == 64) return launch<64>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}
