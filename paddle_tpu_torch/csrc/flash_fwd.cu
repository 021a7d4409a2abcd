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
// and [B, KV, Sk, hd] ('bhsd'): the kernel reads every tensor through its
// batch, sequence and head strides (elements; the head_dim stride is 1),
// so neither layout is copied into the other. bf16 in and out; scores and
// accumulation f32. With a non-null `lse` [B, H, Sq] (f32) it also writes
// each row's log-sum-exp of the scaled scores, the residual of the
// backward (flash_bwd.cu), in the domain the TPU kernel keeps it.
// head_dim 64, 72 (DiT-XL/2's 1152 / 16: the QK^T contraction takes 5
// k16 steps, the last over 8 columns of zeros, attention_core.cuh) or 128.
// Query head h reads KV head h / (H / KV) straight from k/v: the expanded
// K/V is never built. Rows and keys past Sq / Sk are masked here, so any
// Sq and Sk run without padding copies.
//
// Bound on the H100: at prefill widths (hd = 128, S in the hundreds) the
// work is ~4 * hd * (S^2 / 2) flops per (batch, head) against ~4 * S * hd
// bytes, i.e. far above the card's ~295 flop/byte ridge: tensor-core bound.
// Design: one block per (batch * head, 64-query tile), 4 warps x 16 rows;
// K/V tiles of 64 keys staged in shared memory, with the tile's 64 key
// visibilities (in range and unmasked) staged beside them once per tile;
// QK^T and PV on mma.sync (attention_core.cuh); the key loop stops at the
// tile's causal diagonal, so a causal call does about half the work of a
// full one. Not done yet: wgmma, TMA, a multi-stage copy pipeline, sharing
// one K/V tile among the rep query heads of a group, and skipping K tiles
// whose keys are all masked.
#include "attention_core.cuh"

namespace {

using ptt::bf16;
using ptt::Strides;

template <int HD>
__global__ void __launch_bounds__(ptt::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse,
                 const unsigned char* __restrict__ key_mask, int Sq, int Sk,
                 int H, int KV, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale_log2, int causal) {
  __shared__ ptt::KVTile<HD> tile;
  __shared__ bool key_vis[ptt::kKeys];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int q_tile0 = blockIdx.y * ptt::kRows;
  const int row0 = q_tile0 + warp * 16;    // this warp's first query
  const int off = Sk - Sq;                 // causal diagonal offset

  ptt::WarpState<HD> st;
  st.init([&](int r) -> const bf16* {
    const int i = row0 + r;
    return i < Sq ? q + qs.at(b, i, h) : nullptr;
  });

  // keys past the block's last visible one never enter the loop
  int last = Sk - 1;
  if (causal) last = min(last, q_tile0 + ptt::kRows - 1 + off);
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
    st.step(tile, scale_log2, [&](int, int r, int j) {
      return key_vis[j] && (!causal || k0 + j <= row0 + r + off);
    });
    __syncthreads();
  }

  st.store([&](int r) -> bf16* {
    const int i = row0 + r;
    return i < Sq ? out + os.at(b, i, h) : nullptr;
  });
  if (lse != nullptr) {
    st.store_lse([&](int r) -> float* {
      const int i = row0 + r;
      return i < Sq ? lse + ((size_t)b * H + h) * Sq + i : nullptr;
    });
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, const unsigned char* mask, int B, int Sq, int Sk,
            int H, int KV, const Strides* st, float scale, int causal,
            cudaStream_t stream) {
  dim3 grid(B * H, (Sq + ptt::kRows - 1) / ptt::kRows);
  flash_fwd_kernel<HD><<<grid, ptt::kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, mask, Sq, Sk,
      H, KV, st[0], st[1], st[2], st[3], scale * ptt::kLog2e, causal);
}

}  // namespace

// `strides` is a host array of 12 int64: the batch, sequence and head
// strides (in elements) of q, k, v and out, in that order. `lse` and
// `key_mask` may be null. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* key_mask,
                              int B, int Sq, int Sk, int H, int KV, int hd,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const unsigned char* m = static_cast<const unsigned char*>(key_mask);
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  if (hd == 128) {
    launch<128>(q, k, v, o, l, m, B, Sq, Sk, H, KV, st, scale, causal, s);
  } else if (hd == 72) {
    launch<72>(q, k, v, o, l, m, B, Sq, Sk, H, KV, st, scale, causal, s);
  } else if (hd == 64) {
    launch<64>(q, k, v, o, l, m, B, Sq, Sk, H, KV, st, scale, causal, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
