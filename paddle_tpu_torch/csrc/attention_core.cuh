// Core of the ragged paged-attention kernel (ragged_paged_attention.cu):
// one block of 4 warps owns 64 query rows (16 per warp) of one KV head
// and streams 64-key tiles of K and V through shared memory, with the
// online softmax in f32 registers.
//
// Products run on the tensor cores through mma.sync.m16n8k16 (bf16 in,
// f32 accumulate): S = Q K^T with Q's A-fragments held in registers for
// the whole key loop, then O += P V with P re-packed from S's
// accumulator fragments straight into A-fragments (the C layout of two
// n8 tiles is the A layout of one k16 step), so scores never touch
// shared or device memory.
//
// head_dim HD is any multiple of 8 (64, 72, 128 are instantiated). A
// contraction over hd (Q K^T) takes k_steps(HD) = ceil(HD / 16) k16 steps: at HD 72 the last step
// covers columns 64..79, whose columns 72..79 are the rows' padding.
// Every staged row is kRow elements wide; the columns HD..kCols-1 that
// the last k-step reads are staged as zeros, and a fragment read from
// device memory is zero past HD (`frag_pair`), so the tail adds exact
// zeros. P V, whose output runs over hd, takes HD / 8 n8 tiles and
// never reads the pad.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8):       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // query rows per block, 16 per warp
constexpr int kKeys = 64;       // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// k16 steps of a contraction over hd, the columns they read (kCols:
// head_dim, then zeros) and the staged row width (kRow: at least kCols,
// and 8 more than a multiple of 16 elements, so the 8 rows of a warp's
// fragment load start 4, 12, 20 or 28 words apart and fall in distinct
// banks: HD + 8 for 64 and 128, HD + 16 for 72)
constexpr int k_steps(int hd) { return (hd + 15) / 16; }
template <int HD>
struct HeadDim {
  static_assert(HD % 8 == 0 && HD >= 16, "head_dim: a multiple of 8");
  static constexpr int kSteps = k_steps(HD);
  static constexpr int kCols = kSteps * 16;
  static constexpr int kRow = HD % 16 == 0 ? HD + 8 : HD + 16;
  static_assert(kCols >= HD, "the k16 steps must cover head_dim");
  static_assert(kCols <= kRow,
                "the k16 steps must stay inside a staged row");
};

// The 32-bit pair of elements c, c + 1 of a device row, or 0 from
// column HD on (the k-step tail past head_dim); row may be nullptr.
template <int HD>
__device__ __forceinline__ uint32_t frag_pair(const bf16* row, int c) {
  return (row != nullptr && c < HD)
             ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K and V tiles, rows HeadDim<HD>::kRow wide so the fragment loads of
// one warp fall in distinct banks; 16-byte aligned for the uint4 stores.
template <int HD>
struct alignas(16) KVTile {
  bf16 k[kKeys][HeadDim<HD>::kRow];
  bf16 v[kKeys][HeadDim<HD>::kRow];
};

// Stage one tile: row `j` of the tile comes from krow(j) / vrow(j), a
// pointer to HD contiguous bf16 values, or nullptr for a key past the
// end (zero-filled; the mask hides it). 16-byte loads; columns HD.. up
// to the k-steps' reach are written as zeros.
template <int HD, class RowK, class RowV>
__device__ __forceinline__ void load_tile(KVTile<HD>& tile, RowK krow,
                                          RowV vrow) {
  constexpr int kChunks = HeadDim<HD>::kCols / 8;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int row = i / kChunks, c = (i % kChunks) * 8;
    const bf16* kp = c < HD ? krow(row) : nullptr;
    const bf16* vp = c < HD ? vrow(row) : nullptr;
    uint4 kz = make_uint4(0, 0, 0, 0), vz = kz;
    if (kp != nullptr) kz = *reinterpret_cast<const uint4*>(kp + c);
    if (vp != nullptr) vz = *reinterpret_cast<const uint4*>(vp + c);
    *reinterpret_cast<uint4*>(&tile.k[row][c]) = kz;
    *reinterpret_cast<uint4*>(&tile.v[row][c]) = vz;
  }
}

// One warp's 16 query rows: Q fragments, O accumulator and the running
// max (log2 units) and sum of rows g and g+8 of this lane.
template <int HD>
struct WarpState {
  static constexpr int kSteps = HeadDim<HD>::kSteps;
  uint32_t q[kSteps][4];
  float o[HD / 8][4];
  float m[2];
  float l[2];

  // qrow(r): pointer to query row r (0..15) of this warp, or nullptr.
  template <class RowQ>
  __device__ __forceinline__ void init(RowQ qrow) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bf16* q0 = qrow(g);
    const bf16* q1 = qrow(g + 8);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      q[ks][0] = frag_pair<HD>(q0, c);
      q[ks][1] = frag_pair<HD>(q1, c);
      q[ks][2] = frag_pair<HD>(q0, c + 8);
      q[ks][3] = frag_pair<HD>(q1, c + 8);
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Fold one staged tile into the running softmax. vis(h, r, j): whether
  // warp row r (0..15) sees tile key j (0..63); h = r / 8 is this lane's
  // row slot (0 for row g, 1 for row g + 8), a constant once unrolled.
  // Scores are scaled by scale * log2(e) so exp2 gives the weights.
  template <class Vis>
  __device__ __forceinline__ void step(const KVTile<HD>& tile,
                                       float scale_log2, Vis vis) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const bf16* kr = &tile.k[nt * 8 + g][ks * 16 + 2 * t];
        mma_bf16(s[nt], q[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // mask, then the per-row max over this tile (a row's 64 scores sit
    // in the 4 lanes of its quad: reduce over lanes t = 0..3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = vis(e >> 1, r, j) ? s[nt][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    // probabilities; a masked score is exactly kNegInf and gets weight
    // 0 (exp2(kNegInf - m) would be 1 on a row with nothing visible yet)
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = s[nt][e] > 0.5f * kNegInf
                            ? exp2f(s[nt][e] - m[h]) : 0.f;
        s[nt][e] = p;
        sum[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // O += P V: P's accumulator fragments of n-tiles 2kk, 2kk+1 are the
    // A fragment of k-step kk; V is read as a col-major B operand
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int k0 = kk * 16 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const int d = nt * 8 + g;
        const uint32_t b0 = pack_raw(tile.v[k0][d], tile.v[k0 + 1][d]);
        const uint32_t b1 = pack_raw(tile.v[k0 + 8][d], tile.v[k0 + 9][d]);
        mma_bf16(o[nt], a, b0, b1);
      }
    }
  }

  // O / l in bf16 to orow(r) (warp row r, or nullptr to skip). A row
  // that saw no key (l == 0) writes zeros.
  template <class RowO>
  __device__ __forceinline__ void store(RowO orow) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* out = orow(g + h * 8);
      if (out == nullptr) continue;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * t) =
            pack_bf16(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
      }
    }
  }
};

}  // namespace ptt
