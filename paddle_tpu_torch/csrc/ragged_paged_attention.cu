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
// Bound on the H100: decode is memory bound: each (row, KV head) reads its
// live K and V once, bs * hd * 2 bytes per block each, for ~4 * rep flops
// per byte, far below the ~295 flop/byte ridge. The TPU kernel exists to
// read only the LIVE chain instead of gathering the full table width, and
// this one does the same: a block walks ceil((max valid position in its
// query tile + 1) / bs) blocks, reading the table itself, and a tile with
// no valid query reads no K/V at all (the padded decode rows of a fused
// step). Design: one block per (row, KV head, tile of 64 / rep query
// positions); its 64 query rows are the rep heads of a GQA group at each
// position, so one K/V tile in shared memory serves the whole group;
// products on mma.sync (attention_core.cuh), online softmax in f32. Not
// done yet: splitting a long chain across blocks (decode at small batch
// fills R * KV blocks of the card's 132 SMs), cp.async/TMA pipelining.
#include "attention_core.cuh"

namespace {

using ptt::bf16;

template <int HD>
__global__ void __launch_bounds__(ptt::kThreads)
ragged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
              const bf16* __restrict__ v_pool,
              const int* __restrict__ table,
              const int* __restrict__ positions,
              const unsigned char* __restrict__ valid,
              bf16* __restrict__ out, int P, int H, int KV, int N, int bs,
              int M, float scale_log2) {
  __shared__ ptt::KVTile<HD> tile;
  __shared__ int s_live;
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int rep = H / KV, qt = ptt::kRows / rep;
  const int p0 = blockIdx.z * qt;
  const int warp = threadIdx.x >> 5;

  // live chain of this tile: keys up to its largest valid position
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  if (threadIdx.x < qt && p0 + threadIdx.x < P) {
    const int i = r * P + p0 + threadIdx.x;
    if (valid[i]) atomicMax(&s_live, positions[i] + 1);
  }
  __syncthreads();
  const int live = min(s_live, M * bs);

  // warp row w (0..15) is block row warp*16 + w: position p0 + row / rep,
  // head kvh * rep + row % rep
  int pos[2], ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = warp * 16 + (threadIdx.x & 31) / 4 + half * 8;
    const int p = p0 + row / rep;
    ok[half] = p < P && valid[r * P + p];
    pos[half] = p < P ? positions[r * P + p] : -1;
  }
  auto qrow = [&](int w) -> const bf16* {
    const int row = warp * 16 + w, p = p0 + row / rep;
    return p < P ? q + (((size_t)r * P + p) * H + kvh * rep + row % rep) * HD
                 : nullptr;
  };
  ptt::WarpState<HD> st;
  st.init(qrow);

  const int* tab = table + (size_t)r * M;
  auto key_row = [&](const bf16* pool, int key) -> const bf16* {
    if (key >= live) return nullptr;
    const int blk = min(max(tab[key / bs], 0), N - 1);
    return pool + (((size_t)blk * bs + key % bs) * KV + kvh) * HD;
  };
  const int n_tiles = (live + ptt::kKeys - 1) / ptt::kKeys;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * ptt::kKeys;
    ptt::load_tile<HD>(
        tile, [&](int j) { return key_row(k_pool, k0 + j); },
        [&](int j) { return key_row(v_pool, k0 + j); });
    __syncthreads();
    st.step(tile, scale_log2, [&](int half, int, int j) {
      return ok[half] && k0 + j <= pos[half];
    });
    __syncthreads();
  }

  st.store([&](int w) -> bf16* {
    const int row = warp * 16 + w, p = p0 + row / rep;
    return p < P
               ? out + (((size_t)r * P + p) * H + kvh * rep + row % rep) * HD
               : nullptr;
  });
}

template <int HD>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* positions, const unsigned char* valid, void* o,
            int R, int P, int H, int KV, int N, int bs, int M, float scale,
            cudaStream_t stream) {
  const int qt = ptt::kRows / (H / KV);
  dim3 grid(R, KV, (P + qt - 1) / qt);
  ragged_kernel<HD><<<grid, ptt::kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), table, positions, valid,
      static_cast<bf16*>(o), P, H, KV, N, bs, M, scale * ptt::kLog2e);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). H / KV must divide 64.
extern "C" int ragged_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* positions, const void* valid, void* o,
    int R, int P, int H, int KV, int hd, int N, int bs, int M, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  const unsigned char* val = static_cast<const unsigned char*>(valid);
  if (KV <= 0 || H % KV != 0 || ptt::kRows % (H / KV) != 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 128) {
    launch<128>(q, k_pool, v_pool, tab, pos, val, o, R, P, H, KV, N, bs, M,
                scale, s);
  } else if (hd == 64) {
    launch<64>(q, k_pool, v_pool, tab, pos, val, o, R, P, H, KV, N, bs, M,
               scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
