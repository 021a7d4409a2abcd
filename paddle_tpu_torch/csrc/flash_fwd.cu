// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/flash_attention.py::_flash_fwd_kernel
// (pallas_call in _fwd_call) on the serving path's cold prefill
// (nlp/paged.py::_attention_paged, is_prefill=True) and in the training
// forward (nlp/llama.py::_attention), where it also writes the LSE.
//
// Computes out[b, i, h] = softmax(q[b, i, h] . k[b, :, h // rep]^T * scale
// masked to keys j <= i + (Sk - Sq)) . v[b, :, h // rep], the bottom-right
// causal alignment of mha_ref. q [B, Sq, H, hd], k/v [B, Sk, KV, hd], out
// [B, Sq, H, hd], all bf16 and contiguous; scores and accumulation f32.
// With a non-null `lse` [B, H, Sq] (f32) it also writes each row's
// log-sum-exp of the scaled scores, the residual of the backward
// (flash_bwd.cu), in the domain the TPU kernel keeps it.
// Query head h reads KV head h / (H / KV) straight from k/v: the expanded
// K/V is never built. Rows and keys past Sq / Sk are masked here, so any
// Sq <= Sk runs without padding copies.
//
// Bound on the H100: at prefill widths (hd = 128, S in the hundreds) the
// work is ~4 * hd * (S^2 / 2) flops per (batch, head) against ~4 * S * hd
// bytes, i.e. far above the card's ~295 flop/byte ridge: tensor-core bound.
// Design: one block per (batch * head, 64-query tile), 4 warps x 16 rows;
// K/V tiles of 64 keys staged in shared memory; QK^T and PV on mma.sync
// (attention_core.cuh); the key loop stops at the tile's causal diagonal,
// so a causal call does about half the work of a full one. Not done yet:
// wgmma, TMA, a multi-stage copy pipeline and sharing one K/V tile among
// the rep query heads of a group.
#include "attention_core.cuh"

namespace {

using ptt::bf16;

template <int HD>
__global__ void __launch_bounds__(ptt::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale_log2, int causal) {
  __shared__ ptt::KVTile<HD> tile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int q_tile0 = blockIdx.y * ptt::kRows;
  const int row0 = q_tile0 + warp * 16;    // this warp's first query
  const int off = Sk - Sq;                 // causal diagonal offset

  ptt::WarpState<HD> st;
  st.init([&](int r) -> const bf16* {
    const int i = row0 + r;
    return i < Sq ? q + (((size_t)b * Sq + i) * H + h) * HD : nullptr;
  });

  // keys past the block's last visible one never enter the loop
  int last = Sk - 1;
  if (causal) last = min(last, q_tile0 + ptt::kRows - 1 + off);
  const int n_tiles = last < 0 ? 0 : last / ptt::kKeys + 1;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * ptt::kKeys;
    ptt::load_tile<HD>(
        tile,
        [&](int j) -> const bf16* {
          return k0 + j < Sk ? kb + (size_t)(k0 + j) * KV * HD : nullptr;
        },
        [&](int j) -> const bf16* {
          return k0 + j < Sk ? vb + (size_t)(k0 + j) * KV * HD : nullptr;
        });
    __syncthreads();
    st.step(tile, scale_log2, [&](int, int r, int j) {
      const int key = k0 + j;
      return key < Sk && (!causal || key <= row0 + r + off);
    });
    __syncthreads();
  }

  st.store([&](int r) -> bf16* {
    const int i = row0 + r;
    return i < Sq ? out + (((size_t)b * Sq + i) * H + h) * HD : nullptr;
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
            float* lse, int B, int Sq, int Sk, int H, int KV, float scale,
            int causal, cudaStream_t stream) {
  dim3 grid(B * H, (Sq + ptt::kRows - 1) / ptt::kRows);
  flash_fwd_kernel<HD><<<grid, ptt::kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      KV, scale * ptt::kLog2e, causal);
}

}  // namespace

// `lse` may be null (serving). Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int H, int KV, int hd, float scale, int causal,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 128) {
    launch<128>(q, k, v, o, l, B, Sq, Sk, H, KV, scale, causal, s);
  } else if (hd == 64) {
    launch<64>(q, k, v, o, l, B, Sq, Sk, H, KV, scale, causal, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
