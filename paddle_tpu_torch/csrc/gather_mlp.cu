// The MoE dispatch gather fused into the expert gate and up products, for
// Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/moe_dispatch.py::_gather_mlp_kernel
// (pallas_call in gather_mlp_pallas), which no path of the JAX package
// launches (nlp/moe.py:343-349 measured it as a negative result there);
// the port holds it at the MoE step's shapes in chip_smoke.py.
//
//   g[e, m] = xin[e, m] . wg[e],  u[e, m] = xin[e, m] . wu[e],
//   xin[e, m] = src[idx[e, m]], a zero row where idx < 0 (or >= T),
// src [T, D], wg and wu [E, D, F] row-major, g and u [E, M, F], xin
// [E, M, D]; bf16 in and out, f32 accumulation, one rounding. xin is the
// backward's residual and is written once.
//
// Bound on the H100: the products. At the MoE step's shape (T 40960, E
// 16, M 6400, D 2048, F 1024; 63,602 of 102,400 slots filled at the
// routing chip_smoke.py holds) the filled slots' products are 0.534
// TFLOP, 0.540 ms at 989 TFLOP/s, against ~1.23 GB of bytes, 0.37 ms at
// 3.35 TB/s, of which the writes of g, u and xin are 838 MB: they have
// to run under the products. The first design (mma.sync from shared
// tiles, each B fragment packed from four scalar 2-byte loads, no copy
// pipeline, 64 x 128 tiles, every slot computed) took 6.84 ms, 12x that
// bound.
//
// This design:
//   - a plan kernel sorts each expert's 64-slot halves into live ones
//     (some slot filled) and dead ones. The groups of 320 slots fill from
//     the front, so their tails are whole dead halves (at the MoE step's
//     held routing about a third of them); a half with one filled slot
//     is live;
//   - the product kernel is a persistent grid, one block an SM, walking
//     tiles of two live halves (128 slots) x 128 columns of F, the
//     experts' live pairs one after another, F innermost: the 8 F tiles
//     of a pair run side by side and re-gather its rows from L2, and an
//     expert's weights stay in L2 while its pairs pass. Only the last pair
//     of an expert can be half empty; every block's share is within one
//     tile of another's. The dead halves get their zero rows of g, u and
//     xin by TMA stores of one zeroed 64 x 64 box, issued at the start by
//     one thread and running on under the products;
//   - three warpgroups: one producer, two consumers of 64 slots each.
//     The K = D loop runs in 64-column steps through a 4-stage ring of 48
//     KB stages: the A tile (128 gathered rows x 64 columns, K-major) and
//     the wg and wu tiles (64 rows x 128 columns each, MN-major, side by
//     side, by TMA from one thread). Hopper's TMA has no row gather, so
//     the 128 producer threads land the A rows by cp.async, 16 bytes
//     each, straight to their 128-byte-swizzled places (the layout TMA's
//     SWIZZLE_128B writes, which wgmma reads), an empty slot and columns
//     past D zero-filled through the source-size operand: no branch on
//     the data path. Each producer thread's copies reach the stage's full
//     barrier by cp.async.mbarrier.arrive, beside the TMA bytes. (One-row
//     TMA boxes do land rows in the right swizzle, which follows the
//     shared address, but TMA's cost per request made them far slower);
//   - one A tile feeds both products: per k16 step each consumer issues
//     one wgmma m64n256k16 whose B is the wg and wu tiles together, 128
//     f32 accumulators a thread; a stage is released when its products
//     are done, with the next stage's already issued;
//   - xin: the F-tile-0 tile of each pair stores each staged A half-tile
//     to xin by TMA (the swizzled tile is TMA's own layout; the store
//     clips at M and D), so xin costs no extra read;
//   - the epilogue stores the accumulators as bf16 pairs straight from
//     registers while the producer already fills the next tile's stages.
// Each output element is one K reduction in a fixed order, so two calls
// give identical bits. Measured (H100 SXM at 700 W, one CUDA graph;
// PERF.md): 1.168 ms at the routing chip_smoke.py holds, 46 % of the
// bound and below an index gather plus two torch.bmm (1.306); 1.55 ms
// with every slot filled (56 %). What holds it back: the card runs at
// its 700 W limit under this kernel (1.5-1.7 GHz); a deeper ring paid
// more than a shared-memory epilogue with TMA stores (which cost a
// stage); clusters of two blocks sharing the weight tiles by TMA
// multicast, fewer producer threads and L2 prefetches of the gathered
// rows did not help.
#include "hopper_core.cuh"

namespace {

using hop::bf16;

constexpr int kHalf = 64;           // slots a consumer warpgroup
constexpr int kBM = 2 * kHalf;      // slots a tile: two halves
constexpr int kBN = 128;            // columns of F a tile, for g and for u
constexpr int kBK = 64;             // the K step: one 128-byte row chunk
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kProducers = 128;
constexpr int kConsumerWarps = 8;
constexpr int kABytes = kBM * hop::kRowBytes;                  // 16 KB
constexpr int kBBytes = (kBN / hop::kBox) * hop::kBoxBytes;    // 16 KB
constexpr int kStageBytes = kABytes + 2 * kBBytes;             // 48 KB
constexpr int kStages = 4;
// shared memory: the ring, one zero 64 x 64 box (the dead halves' TMA
// stores read it), the barriers
constexpr int kZeroOff = kStages * kStageBytes;
constexpr int kBarOff = kZeroOff + hop::kBoxBytes;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "one block an SM");
constexpr int kPlanThreads = 256;
constexpr int kPlanChunk = 1024;    // halves a plan block sorts at a time

// ----------------------------------------------------------------- plan
// Block e sorts expert e's halves (64 slots each, H of them) into the
// live ones (some slot in [0, T)) and the dead ones, each list in slot
// order: live[e * H + k], k < count[2 e]; dead[e * H + k], k < count[2 e
// + 1]. Chunks of kPlanChunk halves: a warp votes on each half's 64
// indices, then a block-wide scan of per-thread counts places them.
__global__ void __launch_bounds__(kPlanThreads)
mlp_plan_kernel(const int* __restrict__ idx, int T, int M, int H,
                int* __restrict__ live, int* __restrict__ dead,
                int* __restrict__ count) {
  __shared__ unsigned char flag[kPlanChunk];
  __shared__ int scan[kPlanThreads];
  const int e = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int* idx_e = idx + (size_t)e * M;
  constexpr int kPer = kPlanChunk / kPlanThreads;   // halves a thread
  int n_live = 0, n_dead = 0;
  for (int h0 = 0; h0 < H; h0 += kPlanChunk) {
    for (int h = warp; h < kPlanChunk && h0 + h < H; h += kPlanThreads / 32) {
      const int m = (h0 + h) * kHalf + lane;
      const int a = m < M ? __ldg(idx_e + m) : -1;
      const int b = m + 32 < M ? __ldg(idx_e + m + 32) : -1;
      const bool any = __any_sync(0xffffffffu, (a >= 0 && a < T) ||
                                                   (b >= 0 && b < T));
      if (lane == 0) flag[h] = any;
    }
    __syncthreads();
    const int first = h0 + threadIdx.x * kPer;
    int mine = 0, valid = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (first + k < H) {
        ++valid;
        mine += flag[threadIdx.x * kPer + k];
      }
    scan[threadIdx.x] = mine;
    __syncthreads();
    for (int o = 1; o < kPlanThreads; o <<= 1) {   // inclusive scan
      const int v = threadIdx.x >= o ? scan[threadIdx.x - o] : 0;
      __syncthreads();
      scan[threadIdx.x] += v;
      __syncthreads();
    }
    int at_live = n_live + scan[threadIdx.x] - mine;
    // dead halves before this thread's: the chunk's halves before it
    // that are not live
    int at_dead = n_dead + (first - h0) - (scan[threadIdx.x] - mine);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < valid) {
        if (flag[threadIdx.x * kPer + k])
          live[(size_t)e * H + at_live++] = first + k;
        else
          dead[(size_t)e * H + at_dead++] = first + k;
      }
    const int chunk = min(kPlanChunk, H - h0);
    const int total = scan[kPlanThreads - 1];
    n_live += total;
    n_dead += chunk - total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    count[2 * e] = n_live;
    count[2 * e + 1] = n_dead;
  }
}

// ----------------------------------------------------------------- main
// The walk's tiles are (expert, pair j of its live halves, F tile), F
// innermost, the experts' pairs one after another: tile t is pair t / n_f
// of that sequence. A tile's halves are the expert's live halves 2 j and
// 2 j + 1 (-1 past its n live ones). Block b takes tiles b, b + grid,
// ...; its Walk steps through the experts' pair counts as t grows, and
// `next` reads a tile's list entries a tile ahead, so their latency runs
// under the tile before.
struct Tile {
  int e, f0, j, n, a, b;   // e < 0: past the last tile
  __device__ __forceinline__ int half(int k) const {
    return 2 * j + k < n ? (k ? b : a) : -1;
  }
};

struct Walk {
  int e, base, n;          // expert, its first pair's index, its live halves
  __device__ __forceinline__ Tile next(int t, int n_f, int E, int H,
                                       const int* __restrict__ live,
                                       const int* __restrict__ count) {
    const int pt = t / n_f;
    while (e < E && pt >= base + (n + 1) / 2) {
      base += (n + 1) / 2;
      if (++e < E) n = __ldg(count + 2 * e);
    }
    if (e >= E) return {-1, 0, 0, 0, 0, 0};
    const int j = pt - base;
    const int* l = live + (size_t)e * H;
    return {e, (t % n_f) * kBN, j, n, __ldg(l + 2 * j),
            __ldg(l + min(2 * j + 1, H - 1))};
  }
};

__global__ void __launch_bounds__(kThreads, 1)
gather_mlp_kernel(const __grid_constant__ CUtensorMap tm_wg,
                  const __grid_constant__ CUtensorMap tm_wu,
                  const __grid_constant__ CUtensorMap tm_xin,
                  const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_u,
                  const bf16* __restrict__ src, const int* __restrict__ idx,
                  const int* __restrict__ live, const int* __restrict__ dead,
                  const int* __restrict__ count, bf16* __restrict__ g,
                  bf16* __restrict__ u, bf16* __restrict__ xin, int T,
                  int E, int M, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int H = (M + kHalf - 1) / kHalf;
  const int n_f = (F + kBN - 1) / kBN, n_k = (D + kBK - 1) / kBK;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's expect_tx arrival and every producer thread's
      // cp.async arrival; one arrival a consumer warp
      hop::mbar_init(&full[s], 1 + kProducers);
      hop::mbar_init(&empty[s], kConsumerWarps);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kProducers) {
    // --------------------------------------------------------- producer
    hop::Ring<kStages> ring;
    Walk wk{0, 0, __ldg(count)};
    Tile next = wk.next(blockIdx.x, n_f, E, H, live, count);
    // Thread p copies 16-byte group p % 8 of rows p / 8 + 16 i, i = 0..7
    // (rows 0..63 are the first half's): a warp's copies cover 4 whole
    // 128-byte row chunks an instruction.
    const int p = threadIdx.x, grp = p & 7, r0 = p >> 3;
    const int swz = (grp ^ (r0 & 7)) << 4;   // the row's swizzled group
    for (int t = blockIdx.x; next.e >= 0; t += gridDim.x) {
      const Tile tl = next;
      next = wk.next(t + gridDim.x, n_f, E, H, live, count);
      const int h2[2] = {tl.half(0), tl.half(1)};
      const int* idx_e = idx + (size_t)tl.e * M;
      int rows[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int h = h2[i / 4];
        const int m = h * kHalf + (r0 + 16 * i) % kHalf;
        const int v = h >= 0 && m < M ? __ldg(idx_e + m) : -1;
        rows[i] = (v >= 0 && v < T) ? v : -1;
      }
      for (int kc = 0; kc < n_k; ++kc) {
        hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        unsigned char* st = smem + ring.stage * kStageBytes;
        uint64_t* bar = &full[ring.stage];
        if (p == 0) {
          hop::mbar_expect_tx(bar, 2 * kBBytes);
#pragma unroll
          for (int c = 0; c < kBN / hop::kBox; ++c) {
            const int f = tl.f0 + c * hop::kBox;
            hop::tma_load(&tm_wg, bar, st + kABytes + c * hop::kBoxBytes, f,
                          kc * kBK, tl.e, 0);
            hop::tma_load(&tm_wu, bar,
                          st + kABytes + kBBytes + c * hop::kBoxBytes, f,
                          kc * kBK, tl.e, 0);
          }
        }
        const int col = kc * kBK + grp * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (h2[i / 4] < 0) continue;           // no second half
          const bool in = rows[i] >= 0 && col < D;
          hop::cp_async16_zfill(
              st + (r0 + 16 * i) * hop::kRowBytes + swz,
              in ? src + (size_t)rows[i] * D + col : src, in ? 16 : 0);
        }
        hop::cp_async_arrive(bar);
        ring.advance();
      }
    }
    hop::cp_async_wait_all();
    return;
  }

  // ---------------------------------------------------------- consumers
  const int w = threadIdx.x / 128 - 1;           // the half of a tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, gq = lane >> 2, tq = lane & 3;
  const uint32_t base = hop::smem_u32(smem);

  // dead halves: zero rows of g, u and xin, spread over the grid, by TMA
  // stores of one zeroed 64 x 64 box (clipped at M, F and D): one thread
  // issues them and the copies run on under the products
  {
    const int ctid = threadIdx.x - kProducers;   // 0..255
    reinterpret_cast<uint4*>(smem + kZeroOff)[ctid] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(smem + kZeroOff)[ctid + 256] =
        make_uint4(0, 0, 0, 0);
    hop::fence_proxy_async();
    hop::named_sync(1, 256);
    if (ctid == 32) {     // a thread that issues no other bulk copy
      const unsigned char* z = smem + kZeroOff;
      for (int i = blockIdx.x; i < E * H; i += gridDim.x) {
        const int e = i / H, k = i - e * H;
        const int n = __ldg(count + 2 * e + 1);
        const int m0 = __ldg(dead + i) * kHalf;
        if (k >= n) continue;
        for (int c = 0; c < F; c += hop::kBox) {
          hop::tma_store(&tm_g, z, c, m0, e, 0);
          hop::tma_store(&tm_u, z, c, m0, e, 0);
        }
        for (int c = 0; c < D; c += hop::kBox)
          hop::tma_store(&tm_xin, z, c, m0, e, 0);
      }
      hop::bulk_commit();
    }
  }

  hop::Ring<kStages> ring;
  Walk wk{0, 0, __ldg(count)};
  Tile next = wk.next(blockIdx.x, n_f, E, H, live, count);
  for (int t = blockIdx.x; next.e >= 0; t += gridDim.x) {
    const Tile tl = next;
    next = wk.next(t + gridDim.x, n_f, E, H, live, count);
    const int my_half = tl.half(w);
    if (my_half < 0) {
      // the tile's second half is past the expert's list: pass its stages
      for (int kc = 0; kc < n_k; ++kc) {
        hop::mbar_wait(&full[ring.stage], ring.phase);
        if (lane == 0) hop::mbar_arrive(&empty[ring.stage]);
        ring.advance();
      }
      continue;
    }
    const bool store_xin = tl.f0 == 0 && tid == 0;
    const int m_half = my_half * kHalf;
    // g's accumulators, then u's: columns 0..127 and 128..255 of one
    // m64n256 product (the wg and wu tiles lie side by side). The tile's
    // first product overwrites them (scale-d 0): no other instruction
    // writes them inside the loop, which ptxas needs to keep the products
    // in flight rather than wait for each in turn.
    float acc[128];
    int prev = -1;
    for (int kc = 0; kc < n_k; ++kc) {
      const int s = ring.stage;
      hop::mbar_wait(&full[s], ring.phase);
      const uint32_t st = base + s * kStageBytes;
      const uint32_t a = st + w * kHalf * hop::kRowBytes;
      hop::fence_proxy_async();                  // the cp.async rows
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        hop::Wgmma<256>::ss_mn(
            acc, hop::desc_k(a + ks * 32),
            hop::desc_mn(st + kABytes + ks * 16 * hop::kRowBytes,
                         hop::kBoxBytes),
            kc > 0 || ks > 0);
      hop::wg_commit();
      if (store_xin) {
        hop::tma_store(&tm_xin,
                       smem + s * kStageBytes + w * kHalf * hop::kRowBytes,
                       kc * kBK, m_half, tl.e, 0);
        hop::bulk_commit();
      }
      // the previous stage's products (and its xin store's reads) are
      // done: release it while this stage's run
      hop::wg_wait_pending<1>();
      if (store_xin) hop::bulk_wait_read<1>();
      if (prev >= 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
      ring.advance();
    }
    hop::wg_wait();
    if (store_xin) hop::bulk_wait_read<0>();
    if (lane == 0) hop::mbar_arrive(&empty[prev]);
    hop::fence_regs(acc);
    // epilogue: rows m_half + 16 warp + gq (+ 8), columns 8 j + 2 tq (+ 1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m_half + warp * 16 + gq + 8 * hh;
      if (m >= M) continue;
      const size_t at = ((size_t)tl.e * M + m) * F + tl.f0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (tl.f0 + col >= F) continue;
        *reinterpret_cast<uint32_t*>(g + at + col) =
            hop::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(u + at + col) = hop::pack_bf16(
            acc[64 + 4 * j + 2 * hh], acc[64 + 4 * j + 2 * hh + 1]);
      }
    }
  }
  hop::bulk_wait_all();    // the xin and zero stores of this thread
}

}  // namespace

// src [T, D] bf16; idx [E, M] int32 (-1 = empty slot); wg, wu [E, D, F]
// bf16; g, u [E, M, F] and xin [E, M, D] bf16; D and F multiples of 8.
// `maps` is a host array of 35 int64: for wg, wu, xin, g and u in turn
// the seven tensor-map values of kernels/moe_dispatch.py::mlp_tma_dims.
// `plan` an int32 scratch of kernels/moe_dispatch.py::mlp_scratch_ints
// (E, M) ints: the live and dead half lists [E, H] each and their counts
// [E, 2] (H = ceil(M / 64)). `grid`: the persistent grid, one block an
// SM. Launches the plan, then the products. Returns the launches'
// cudaError_t (0 on success; cudaErrorInvalidValue when a tensor map is
// refused).
extern "C" int gather_mlp_bf16(const void* src, const void* idx,
                               const void* wg, const void* wu, void* g,
                               void* u, void* xin, int T, int E, int M,
                               int D, int F, const long long* maps,
                               void* plan, int grid, void* stream) {
  if (D % 8 || F % 8 || T < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if ((long)E * M == 0) return (int)cudaSuccess;
  const long H = (M + kHalf - 1) / kHalf;
  if ((long)E * ((H + 1) / 2) * ((F + kBN - 1) / kBN) > 0x7fffffff ||
      (long)E * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[5];
  const void* bases[5] = {wg, wu, xin, g, u};
  for (int k = 0; k < 5; ++k)
    if (!hop::encode_map(&tm[k], bases[k], maps + 7 * k))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* live = static_cast<int*>(plan);
  int* dead = live + (size_t)E * H;
  int* count = dead + (size_t)E * H;
  mlp_plan_kernel<<<E, kPlanThreads, 0, s>>>(static_cast<const int*>(idx),
                                              T, M, (int)H, live, dead,
                                              count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static int granted[64];
  err = hop::allow_smem(gather_mlp_kernel, kSmemBytes, granted);
  if (err != cudaSuccess) return (int)err;
  gather_mlp_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], static_cast<const bf16*>(src),
      static_cast<const int*>(idx), live, dead, count, static_cast<bf16*>(g),
      static_cast<bf16*>(u), static_cast<bf16*>(xin), T, E, M, D, F);
  return (int)cudaGetLastError();
}
