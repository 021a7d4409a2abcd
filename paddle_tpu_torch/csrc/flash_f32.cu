// GQA flash attention in f32 for Hopper (sm_90a), forward and backward,
// on TF32 tensor cores: the f32 option of the flash kernels.
//
// Replaces, for f32 q, k and v: paddle_tpu/kernels/flash_attention.py's
// _flash_fwd_kernel (pallas_call in _fwd_call) and its backward kernels
// (_bwd_call_resident's, and the streamed and split schedules of
// flash_attention_pallas_bwd): the TPU kernels compute in q's dtype and
// write out, dq, dk and dv in it. The f32 finetune of ERNIE (the eager
// encoder's scaled_dot_product_attention) and the training stack at
// LlamaConfig(dtype=float32) reach them.
//
// Computes what flash_fwd.cu and flash_bwd.cu compute (their headers give
// the formulas): causal with the bottom-right alignment, or bidirectional
// with an optional uint8 [B, Sk] key mask (a row that sees no key writes
// zeros and an LSE of -1e30; the backward's mask zeroes P); 'bshd' or
// 'bhsd' through strides (TMA reads q, k, v and dout through tensor maps,
// outputs are written through their strides); GQA without an expanded K/V;
// head_dim 64, 72 or 128; any Sq and Sk (TMA zero-fills past them); the f32
// LSE of the scaled scores; a backward whose sums run in a fixed order
// (no atomics: two runs are bit-identical). q, k, v, out, dout, dq, dk
// and dv are all f32.
//
// Precision. Every product runs on TF32 tensor cores (10 mantissa bits)
// with f32 accumulation; the tensor core reads an f32 operand as TF32 by
// dropping its low 13 bits. The products that give the scores, S = Q K^T
// in the forward and S, dP = dO V^T in the backward, split each operand
// into hi and lo and sum three products (hi hi + hi lo + lo hi): the
// scores then carry ~2^-21 of their scale, so the LSE keeps f32's
// accuracy, and P and dS no TF32 error of the scores. hi = rna(x) (to
// nearest, ties away, by an integer add and mask: sm_90 has no
// instruction for cvt.rna.tf32.f32, and ptxas expands it into a
// compare-and-select sequence) and lo = x - hi, which the tensor core
// truncates as it reads it; the forward's Q and K take hi = trunc(x)
// instead (K: its raw tile as the tensor core reads it; Q: one operation
// fewer; lo < 2^-10 of x, the dropped lo lo part ~2^-20).
// The backward's dP keeps its sum out of the
// tensor core's accumulation, which truncates against its running sum:
// dS = P (dP - dcap) cancels where a row sees few keys (causal row 0: dP
// - dcap is the residue of O's rounding, ~1e-3), so each two k8 steps'
// six parts go into a fresh tile, added to the f32 sum on the CUDA cores.
// On the card (H100 SXM at 700 W), fresh tiles of one k8 step or two
// gave the same dq at [1, 300, 4/1, 72] causal, four doubled its error
// there, and dP in one chain brought dq near F32_TOL at [4, 2048, 16/8,
// 128]. Both directions' S chain all their instructions in one
// accumulator (the forward's fresh tiles would take 64 more registers a
// consumer thread, past the 168 that ptxas allocates under 384 threads):
// its error moves P, and the forward's LSE, by ~1e-5 and no more. The second
// products (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K) take single
// TF32 parts, P and dS rounded from their f32 registers, the other
// operand rounded once a tile: ~2^-11 relative per term (~1e-3 of a
// vector's scale at most). tests/test_torch_flash_f32_emulation.py
// emulates both directions' roundings and grouping in numpy (the
// backward: 7.2e-4 of F32_TOL's 2.5e-3 at [1, 300, 4/1, 72] causal,
// 6.6e-4 at [2, 128, 2/1, 128]; dP with its lo parts dropped 0.67); its
// model of the accumulation (exact products, the sum truncated once an
// instruction) is kinder to long groups than the card, which decides
// them.
//
// Bound on the H100: the same flops as the 16-bit kernels (4 hd per
// visible pair forward, 10 backward) against twice their bytes, at the
// 495 TFLOP/s TF32 rate: tensor-core bound at training lengths. The
// forward's three-part S makes it 4 products where the bound counts 2;
// the backward's three-part scores and its dq pass make it 15 where the
// bound counts 5 (dkdv: S and dP three parts, dV and dK one; dq: S and dP
// again, dQ).
//
// Forward design. A block owns 128 query rows of one (batch, head): a
// producer warpgroup and two consumer warpgroups of 64 rows, over 64-key
// tiles (setmaxnreg: 40 registers for the producer, 232 for the
// consumers).
//   - Thread 0 issues every TMA copy, in boxes of 32 x 64 f32: Q once, K
//     tiles into a two-stage ring, V tiles into one landing buffer.
//   - S = Q K^T on wgmma m64n64k8 in three TF32 parts, as the backward's
//     score products (score_products): Q the resident A side, split in
//     registers a k8 step at a time (ARows); K the streamed B side, read
//     raw as its hi part (the tensor core truncates it: hi = trunc(k)),
//     whose lo plane (k - hi) the producer warpgroup's other 127 threads
//     (the splitters) write once it has landed (split_lo; the backward
//     rounds its tiles in place, split_tile, which costs a third more
//     shared-memory traffic). The consumers free the lo plane and the K
//     stage as soon as S is done.
//   - O += P V on wgmma m64n{hd}k8, P as A from registers (rounded, in
//     the permuted key order of its accumulator: the lane holding columns
//     2t, 2t + 1 supplies k = t and k = t + 4, so no shuffle), V as B
//     from V^T: TF32 wgmma reads B only K-major, so the splitters also
//     write each landed V tile transposed and rounded, its K rows (keys)
//     in that same permuted order (transpose_v), and free V's landing
//     buffer for the next tile's copy.
//   - The splitters run one tile ahead: the next K's split under this
//     tile's softmax and P V, the next V's transpose under the next S.
//     One lo plane and one V^T buffer suffice for that, which is what
//     lets hd 128 fit: Q 64 KB, the K ring 64 KB, V's landing, K's lo
//     plane and V^T 32 KB each (224 KB).
//   - The online softmax stays in f32 registers; masking, the tile-state
//     scan of a key mask (tiles past the 1952 that fit at hd 128 take the
//     per-element test), hop::key_tiles and the heavy-blocks-first order
//     are the 16-bit forward's. hd 72: S takes 9 k8 steps (the third
//     chunk's zero-filled tail is never read), P V's N is 72.
// What holds it (PERF.md §6): not the tensor cores (S in one part
// instead of three saved ~10 %, no P V ~3 % on the card) but the rest of
// each tile: its copies, splits and barrier hand-offs (which of them was
// not measured; 64-row boxes in place of 16-row ones saved ~6 %).
//
// Backward design. Three kernels in order on the caller's stream, as
// flash_bwd.cu's: dcap (one warp a (batch, head, query) row: rowsum(dO
// O) and lse log2(e) into the f32 scratch), dkdv (a block owns 128 keys of
// one (batch, KV head), K and V resident, walking the group's query heads
// and, for each, 32-query tiles from the causal diagonal on) and dq (a
// block owns 128 query rows of one (batch, head), Q and dO resident,
// walking 32-key tiles below the diagonal). A block is a producer
// warpgroup and two consumer warpgroups of 64 resident rows each.
//   - The score products run on wgmma m64n32k8 (f32 += tf32 x tf32): A the
//     warpgroup's 64 resident rows, split in registers a k8 step at a time
//     (four shared loads at offsets fixed a thread, ARows); B the streamed
//     tile, K-major from shared memory: the [chunk][32][32] TMA tiles with
//     the 128-byte swizzle are the layout wgmma reads. wgmma takes a TF32
//     operand from shared memory only K-major, and truncates it, so once
//     a tile has landed the producer warpgroup's other 127 threads (the
//     splitters; thread 0 issues the TMA copies) round it in place (hi)
//     and write its lo parts to a plane of the same layout, then mark the
//     stage ready. The consumers free the lo planes as soon as their
//     score products are done, so the next tile's split runs under their
//     softmax and second products. The resident side's lo planes would
//     not fit beside the ring at hd 128 (K and V take 128 KB of the 227).
//   - Two k8 steps' A fragments are in flight; dP's fresh tiles alternate
//     between two, so one group's adds overlap the next group's products.
//   - The second products stay on mma.sync m16n8k8, their B operand read
//     from the rounded tile by scalar shared loads (eight offsets a thread
//     place every load at a constant from one of them). They contract over
//     queries (dV, dK) or keys (dQ), so their B operands are MN-major,
//     which wgmma takes for 16-bit types only. P and dS reach them from the
//     score accumulators without a shuffle, in the forward's permuted
//     order.
//   - Tiles: dkdv's streamed queries were 16, now 32, the N of the score
//     products; at hd 128 the resident 128 KB, the two-stage ring (32 KB
//     a stage) and the lo planes (32 KB) take 224 KB. dq stays at 32 keys
//     for the same sum.
//   - No atomics: dQ is its own pass, and every sum runs in a fixed order,
//     so two runs are bit-identical.
// What held the first backward design back (H100 SXM at 700 W:
// 41.38 ms at train_f32's [16, 2048, 32/8, 128], 6.7 % of the bound;
// eager_f32 [64, 512, 12, 64] 4.016 ms, 1.01x SDPA f32's backward): every
// operand value of every product was a scalar shared load and a cvt.rna,
// repeated by each of the eight warps for every product it entered, all
// on mma.sync, over 16-query dkdv tiles. What holds this one (PERF.md
// §6): the second products on mma.sync, whose TF32 rate on the card is a
// fraction of wgmma's and whose B loads (each warp reads the whole
// streamed tile) are most of the shared-memory traffic. Putting them on
// wgmma needs their B operand K-major, i.e. P^T or dS written to shared
// memory, and either 64-key dkdv blocks (128 keys' dK and dV accumulators
// exceed the 168 registers a thread ptxas allocates under 384 threads,
// and it serializes the wgmma) or room that hd 128 does not leave; both
// variants ran slower on the card than this design (PERF.md §6).
#include "hopper_core.cuh"

namespace {

using hop::Strides;

constexpr int kCols = hop::row_elems<float>();   // 32: one swizzled row
constexpr int kBoxRows = 16;                     // TMA box: 32 x 16 f32
constexpr int kBoxBytes = kCols * kBoxRows * 4;  // 2 KB
constexpr int kRowBytes = hop::kRowBytes;        // 128
constexpr int kWarps = 8;                        // consumer warps, 16 rows
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = 128 + kConsumers;       // + the producer warpgroup
constexpr int kStages = 2;
constexpr int kBM = 128;       // forward and dq: query rows a block
constexpr int kFwdBN = 64;     // forward: keys a tile
constexpr int kFwdBox = 64;    // forward: TMA box rows (32 x 64 f32, 8 KB:
                               // a quarter of the copies of 16-row boxes)
constexpr int kFwdBoxBytes = kCols * kFwdBox * 4;
constexpr int kKN = 128;       // dkdv: keys a block, 64 a warpgroup
constexpr int kTN = 32;        // backward: a streamed tile's rows (dkdv's
                               // queries, dq's keys)
constexpr int kPad = 128;      // the prep rows' padding of Sq
constexpr float kPadLse = 1e30f;

static_assert(kCols * 4 == kRowBytes, "a chunk row is one swizzle row");
static_assert(kBoxRows % 8 == 0 && kFwdBN % kBoxRows == 0 &&
              kTN % kBoxRows == 0 &&
              kBM % kBoxRows == 0 && kKN % kBoxRows == 0,
              "tiles are whole boxes, boxes whole 8-row swizzle atoms");
static_assert(kBM % kFwdBox == 0 && kFwdBN % kFwdBox == 0,
              "the forward's tiles are whole boxes");
static_assert(kBM == 16 * kWarps && kKN == 16 * kWarps,
              "each consumer warp owns 16 rows of a block");

__host__ __device__ constexpr int chunks(int hd) {
  return hop::chunks_of<float>(hd);
}

__host__ __device__ __forceinline__ int padded(int sq) {
  return (sq + kPad - 1) / kPad * kPad;
}

// Element (r, col) of a swizzled tile of R rows a chunk: chunk col / 32,
// its row r, 16-byte group (col % 32) / 4 XOR-ed with r % 8 (as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it into 1024-byte-aligned chunks)
template <int R>
__device__ __forceinline__ float lds(const float* tile, int r, int col) {
  return tile[((col >> 5) * R + r) * kCols +
              ((((col >> 2) & 7) ^ (r & 7)) << 2) + (col & 3)];
}

// d (an m16n8 accumulator: d[0], d[1] row g, columns 2t, 2t + 1; d[2],
// d[3] row g + 8) += A B over one k8 step, f32 += tf32 x tf32 on mma.sync.
// A fragment (m16k8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4); B (k8n8, col): b0 (t, g), b1 (t + 4, g). g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void mma_raw(float* d, uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ------------------------------------------------- the score products
// The score products (the forward's S, the backward's S and dP) on wgmma
// m64nNk8 with TF32 operands: the warpgroup's 64 rows of X (a resident
// tile, read raw) by the N rows of a streamed tile Y, over head_dim. Y is
// split once a tile by the splitters (split_tile): its landed TMA tile
// rounded in place (hi = rna(y)) and lo = y - hi written to a plane of
// the same layout. X's values are split in registers (ARows) as the A
// fragments of each k8 step.

// D (+)= A B over one k8 step: m64nNk8, f32 += tf32 * tf32. A four TF32
// registers, the warp's m16k8 fragment (a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4) of its 16 rows, as mma.m16n8k8's); B K-major
// from shared memory (128-byte swizzle: a k8 step is 32 bytes of a row).
// scale_d 0: D = A B, a fresh tile. N 32 and 64 (scores), 64, 72 and 128
// (the forward's O += P V).
template <int N>
struct WgTf32;
template <>
struct WgTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgTf32<64> {
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgTf32<72> {
  static __device__ __forceinline__ void rs(float (&d)[36],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgTf32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <int R>
__device__ __forceinline__ void fence_a(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// x rounded to TF32, to nearest with ties away (cvt.rna's result for
// every finite x and for inf; a NaN comes out NaN or inf) in two integer
// operations, where sm_90 has no instruction for cvt.rna.tf32.f32 and
// ptxas expands it into a compare-and-select sequence
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// A k8 step's split A fragments come from a raw tile of R rows a chunk:
// rows x0 + g, x0 + g + 8 (x0 a multiple of 16, so both rows are g
// modulo the swizzle's 8), columns 8 ks + t, 8 ks + t + 4. sw[q] is the
// thread's offset, in floats, of 16-byte group q of row x0 + g (its
// swizzled place, plus t), so each value is one shared load at an offset
// known at compile time from it.
template <int R>
struct ARows {
  int sw[8];
  __device__ __forceinline__ ARows(int x0, int g, int t4) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      sw[q] = (x0 + g) * kCols + ((q ^ g) << 2) + t4;
  }
  // hi = rna(x) (kTrunc: x with its low 13 bits dropped, one operation
  // fewer); lo = x - hi, whose low bits the tensor core drops (its
  // truncation: ~2^-10 of lo, ~2^-21 of x; kTrunc ~2^-20)
  template <bool kTrunc = false>
  __device__ __forceinline__ void split(const float* x, int ks,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) const {
    const float* c = x + (ks >> 2) * R * kCols;
    const int q = (2 * ks) & 7;
    const float v[4] = {c[sw[q]], c[sw[q] + 8 * kCols], c[sw[q + 1]],
                        c[sw[q + 1] + 8 * kCols]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = kTrunc ? __float_as_uint(v[e]) & 0xFFFFE000u : rna(v[e]);
      lo[e] = __float_as_uint(v[e] - __uint_as_float(hi[e]));
    }
  }
};

// acc (m64nN: the warpgroup's rows x0.. of X by Y's N rows) = X Y^T over
// HD columns, three TF32 parts a k8 step (hi hi + hi lo + lo hi). X a raw
// tile of R rows a chunk, split in registers (kTruncX: by truncation,
// ARows::split); Y's hi (rounded in place, or raw and read truncated) and
// lo planes at shared addresses yhi, ylo ([chunk][N][32]). kFresh: each
// kG k8 steps'
// parts into a fresh tile, added to acc in f32 on the CUDA cores, two
// tiles in turn so that one group's adds overlap the next group's
// products (dP: dS = P (dP - dcap) cancels where a row sees few keys,
// and the tensor core's accumulation truncates against its running sum);
// else one chain in the tensor core's accumulator (S: an error of the
// scores moves P, and the forward's LSE, by as much relatively, and no
// more). The A fragments of two steps are in flight at a time.
template <int HD, int R, bool kFresh, int N = kTN, bool kTruncX = false>
__device__ __forceinline__ void score_products(float (&acc)[N / 2],
                                               const float* x, int x0,
                                               uint32_t yhi, uint32_t ylo,
                                               int g, int t4) {
  constexpr int kSteps = HD / 8;
  constexpr int kG = 2;   // dP: k8 steps a fresh tile
  const ARows<R> rows(x0, g, t4);
  uint32_t hi[2][4], lo[2][4];
  float tmp[2][N / 2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int b = ks & 1, tb = (ks / kG) & 1;
    rows.template split<kTruncX>(x, ks, hi[b], lo[b]);
    const uint64_t dh = hop::desc_k(hop::k_step_addr(yhi, N, ks));
    const uint64_t dl = hop::desc_k(hop::k_step_addr(ylo, N, ks));
    hop::wg_fence();
    if constexpr (kFresh) {
      WgTf32<N>::rs(tmp[tb], hi[b], dh, ks % kG != 0);
      WgTf32<N>::rs(tmp[tb], hi[b], dl, 1);
      WgTf32<N>::rs(tmp[tb], lo[b], dh, 1);
    } else {
      WgTf32<N>::rs(acc, hi[b], dh, ks > 0);
      WgTf32<N>::rs(acc, hi[b], dl, 1);
      WgTf32<N>::rs(acc, lo[b], dh, 1);
    }
    hop::wg_commit();
    hop::wg_wait_pending<1>();     // step ks - 1 has completed
    fence_a(hi);
    fence_a(lo);
    if constexpr (kFresh) {
      if (ks > 0 && (ks - 1) % kG == kG - 1) {   // a fresh tile is whole
        const int pb = ((ks - 1) / kG) & 1;
        hop::fence_regs(tmp[pb]);
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          acc[i] = ks > kG ? acc[i] + tmp[pb][i] : tmp[pb][i];
      }
    }
  }
  hop::wg_wait();
  if constexpr (kFresh) {
    constexpr int pb = ((kSteps - 1) / kG) & 1;
    hop::fence_regs(tmp[pb]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      acc[i] = kSteps > kG ? acc[i] + tmp[pb][i] : tmp[pb][i];
  } else {
    hop::fence_regs(acc);
  }
}

// acc[4n..] (16 x HD) += P Y on mma.sync m16n8k8: P the warp's 16 x K
// accumulator (p[4j + e] as acc's layout), Y a tile of 32 rows a chunk,
// rows 0..K-1 contracted. Step j takes keys 8j..8j+7 in the order k = t
// <-> row 8j + 2t, k = t + 4 <-> row 8j + 2t + 1, so p's registers are
// the A fragment as they are (rounded). Y's values are TF32 already (a
// hi plane): taken as they are. Lane (g, t) reads rows 8j + 2t + e,
// columns 8n + g: with gh = g / 4, their 16-byte group 2 (n % 4) + gh
// lands at 2 ((n % 4) ^ t) + (gh ^ e) of the row, so eight offsets a
// thread (e, n % 4) place every load at a constant from one of them.
// Each k8 step's B fragments are loaded before its products.
template <int HD, int K>
__device__ __forceinline__ void p_times_hi(float* acc, const float* p,
                                           const float* y, int g, int t4) {
  int off[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      off[e][m] = (2 * t4 + e) * kCols +
                  (((m ^ t4) << 3) | (((g >> 2) ^ e) << 2)) + (g & 3);
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const uint32_t a0 = rna(p[4 * j + 0]), a1 = rna(p[4 * j + 2]);
    const uint32_t a2 = rna(p[4 * j + 1]), a3 = rna(p[4 * j + 3]);
    uint32_t b[HD / 8][2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float* c = y + (n >> 2) * kTN * kCols + 8 * j * kCols;
      b[n][0] = __float_as_uint(c[off[0][n & 3]]);
      b[n][1] = __float_as_uint(c[off[1][n & 3]]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      mma_raw(acc + 4 * n, a0, a1, a2, a3, b[n][0], b[n][1]);
  }
}

// The producer warpgroup's threads 1-127 (thread 0 issues the TMA
// copies) split each landed tile of the backward's ring (split_tile), so
// the consumers find it ready.
constexpr int kSplitters = 127;

// A landed tile of n floats rounded to TF32 in place (hi = rna(x)), and
// lo = x - hi at the same offsets of `lo` (the tensor core drops its low
// bits as it reads it): the splitters (tid < kSplitters) share it, a
// 16-byte vector each in turn. The writes are made visible to the tensor
// core's reads (the async proxy) here, before the splitters arrive on the
// stage's ready barrier.
__device__ __forceinline__ void split_tile(float* t, float* lo, int n,
                                           int tid) {
  for (int i = tid * 4; i < n; i += kSplitters * 4) {
    const float4 x = *reinterpret_cast<float4*>(t + i);
    const float4 h = make_float4(
        __uint_as_float(rna(x.x)), __uint_as_float(rna(x.y)),
        __uint_as_float(rna(x.z)), __uint_as_float(rna(x.w)));
    *reinterpret_cast<float4*>(t + i) = h;
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
  hop::fence_proxy_async();
}

// ---------------------------------------------------------------- forward
// The forward's landed K tile split for the score products without a
// write to it: the tensor core reads the raw tile as hi, truncated (hi =
// k with its low 13 bits dropped), so only lo = k - hi goes to `lo` (the
// plane of the same layout; < 2^-10 of k, itself read truncated: ~2^-20
// of k). That saves rna's in-place rewrite of the tile, a third of the
// split's shared-memory traffic. As split_tile: the splitters share it,
// and the writes are made visible to the tensor core's reads here.
__device__ __forceinline__ void split_lo(const float* t, float* lo, int n,
                                         int tid) {
  for (int i = tid * 4; i < n; i += kSplitters * 4) {
    const float4 x = *reinterpret_cast<const float4*>(t + i);
    auto l = [](float v) {
      return v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
    };
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(l(x.x), l(x.y), l(x.z), l(x.w));
  }
  hop::fence_proxy_async();
}

// Q [chunk][128][32] (raw); per stage K [chunk][64][32] (raw, read as its
// truncated hi part); V as it lands [chunk][64][32]; K's lo plane; V^T
// [key chunk][HD][32] (rounded, keys permuted); the barriers (Q landed;
// per stage K landed, empty and ready; V landed, V's landing free, V^T
// ready and free, K's lo plane free); the key-tile states. At hd 128:
// 64 + 2 x 32 + 32 + 32 + 32 KB = 224 KB of the 227.
template <int HD>
struct FwdSmem {
  static constexpr int kC = chunks(HD);
  static constexpr int kQBytes = kC * kBM * kRowBytes;
  static constexpr int kKBytes = kC * kFwdBN * kRowBytes;
  static constexpr int kVtBytes = (kFwdBN / kCols) * HD * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                   // + stage * kKBytes
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kLo = kV + kKBytes;
  static constexpr int kVt = kLo + kKBytes;
  static constexpr int kBars = kVt + kVtBytes;
  // the barriers' slots, in the order fwd_kernel lays its pointers out
  static constexpr int kQFull = 0;
  static constexpr int kKFull = kQFull + 1;            // + stage
  static constexpr int kKEmpty = kKFull + kStages;     // + stage
  static constexpr int kKReady = kKEmpty + kStages;    // + stage
  static constexpr int kVFull = kKReady + kStages;
  static constexpr int kVEmpty = kVFull + 1;
  static constexpr int kVtReady = kVEmpty + 1;
  static constexpr int kVtFree = kVtReady + 1;
  static constexpr int kLoFree = kVtFree + 1;
  static constexpr int kNumBars = kLoFree + 1;
  static constexpr int kState = kBars + 8 * kNumBars;
  // key-tile states that fit beside the rest (1952 at hd 128: 124,928
  // keys); the tiles past them take the per-element test
  static constexpr int kMaxStates = (232448 - 1024 - kState) & ~15;
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 &&
                    kVtBytes % 1024 == 0,
                "tiles keep the swizzle's 1024-byte period");
  static_assert(kMaxStates >= 1024, "room for the key-tile states");
  static int bytes(int n_state) {
    return kState + ((n_state + 15) & ~15) + 1024;
  }
};

// The landed V tile ([chunk][64 keys][32], swizzled) rounded to TF32 and
// written transposed, as the K-major B operand of O += P V: [key chunk
// kc][HD rows][32 keys] with the 128-byte swizzle, each 8-key group in
// the order of P's A fragment (position 4h + i of group j holds key 8j +
// 2i + h: the lane holding P's columns 2t, 2t + 1 supplies k = t and k =
// t + 4). A splitter writes one 16-byte vector of a V^T row in turn (four
// keys of column d), reading its four values where lanes of consecutive d
// hit distinct banks, and writing where eight consecutive rows' vectors
// fill the 32 banks.
template <int HD>
__device__ __forceinline__ void transpose_v(const float* v, float* vt,
                                            int tid) {
  for (int e = tid; e < HD * (kFwdBN / 4); e += kSplitters) {
    const int d = e % HD, jh = e / HD, j = jh >> 1, h = jh & 1;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = __uint_as_float(rna(lds<kFwdBN>(v, 8 * j + 2 * i + h, d)));
    const int kc = j >> 2, q = 2 * (j & 3) + h;
    *reinterpret_cast<float4*>(vt + (kc * HD + d) * kCols +
                               ((q ^ (d & 7)) << 2)) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  hop::fence_proxy_async();
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ out,
           float* __restrict__ lse, const unsigned char* __restrict__ key_mask,
           int Sq, int Sk, int H, int KV, Strides os, float scale_log2,
           int causal, int n_state) {
  using L = FwdSmem<HD>;
  constexpr int kC = L::kC;
  constexpr int kTileTx = kC * (kFwdBN / kFwdBox) * kFwdBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars + L::kQFull;
  uint64_t* k_full = bars + L::kKFull;
  uint64_t* k_empty = bars + L::kKEmpty;
  uint64_t* k_ready = bars + L::kKReady;
  uint64_t* v_full = bars + L::kVFull;
  uint64_t* v_empty = bars + L::kVEmpty;
  uint64_t* vt_ready = bars + L::kVtReady;
  uint64_t* vt_free = bars + L::kVtFree;
  uint64_t* lo_free = bars + L::kLoFree;
  unsigned char* tile_state = smem + L::kState;
  float* lo_k = reinterpret_cast<float*>(smem + L::kLo);
  float* v_land = reinterpret_cast<float*>(smem + L::kV);
  float* vt = reinterpret_cast<float*>(smem + L::kVt);

  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int kvh = head / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heavy blocks first
  const int off = Sk - Sq;
  const int n_tiles = hop::key_tiles(m0, kBM, kFwdBN, Sq, Sk, causal);
  const unsigned char* mrow =
      key_mask != nullptr ? key_mask + (size_t)b * Sk : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&k_full[s], 1);
      hop::mbar_init(&k_empty[s], kConsumers);
      hop::mbar_init(&k_ready[s], kSplitters);
    }
    hop::mbar_init(v_full, 1);
    hop::mbar_init(v_empty, kSplitters);
    hop::mbar_init(vt_ready, kSplitters);
    hop::mbar_init(vt_free, kConsumers);
    hop::mbar_init(lo_free, kConsumers);
    hop::fence_barrier_init();
  }
  if (mrow != nullptr)
    hop::scan_key_tiles<kFwdBN>(mrow, Sk, min(n_tiles, n_state), tile_state);
  __syncthreads();
  // 0: no visible key (not walked); 1: per-element test; 2: all visible
  auto state = [&](int t) -> int {
    if (mrow != nullptr) return t < n_state ? tile_state[t] : 1;
    return (t + 1) * kFwdBN <= Sk ? 2 : 1;
  };

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<40>();
    if (threadIdx.x > 0) {
      // the splitters: K once landed and its lo plane free (the last
      // tile's S done), then V once landed and V^T free (the last tile's
      // P V done)
      hop::Ring<kStages> ring;
      int u = 0;
      for (int t = 0; t < n_tiles; ++t) {
        if (state(t) == 0) continue;
        const uint32_t par = u & 1;
        hop::mbar_wait(&k_full[ring.stage], ring.phase);
        if (u > 0) hop::mbar_wait(lo_free, par ^ 1u);
        split_lo(reinterpret_cast<const float*>(smem + L::kK +
                                                ring.stage * L::kKBytes),
                 lo_k, L::kKBytes / 4, threadIdx.x - 1);
        hop::mbar_arrive(&k_ready[ring.stage]);
        hop::mbar_wait(v_full, par);
        if (u > 0) hop::mbar_wait(vt_free, par ^ 1u);
        transpose_v<HD>(v_land, vt, threadIdx.x - 1);
        hop::mbar_arrive(v_empty);
        hop::mbar_arrive(vt_ready);
        ring.advance();
        ++u;
      }
      return;
    }
    hop::mbar_expect_tx(q_full, kC * (kBM / kFwdBox) * kFwdBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kBM / kFwdBox; ++r)
        hop::tma_load(&tm_q, q_full,
                      smem + L::kQ + (c * kBM + r * kFwdBox) * kRowBytes,
                      c * kCols, m0 + r * kFwdBox, head, b);
    hop::Ring<kStages> ring;
    int u = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (state(t) == 0) continue;
      hop::mbar_wait(&k_empty[ring.stage], ring.phase ^ 1u);
      uint64_t* bar = &k_full[ring.stage];
      hop::mbar_expect_tx(bar, kTileTx);
      unsigned char* kb = smem + L::kK + ring.stage * L::kKBytes;
      for (int c = 0; c < kC; ++c)
        for (int r = 0; r < kFwdBN / kFwdBox; ++r)
          hop::tma_load(&tm_k, bar, kb + (c * kFwdBN + r * kFwdBox) *
                                             kRowBytes,
                        c * kCols, t * kFwdBN + r * kFwdBox, kvh, b);
      if (u > 0) hop::mbar_wait(v_empty, (u - 1) & 1);
      hop::mbar_expect_tx(v_full, kTileTx);
      for (int c = 0; c < kC; ++c)
        for (int r = 0; r < kFwdBN / kFwdBox; ++r)
          hop::tma_load(&tm_v, v_full,
                        smem + L::kV + (c * kFwdBN + r * kFwdBox) *
                                           kRowBytes,
                        c * kCols, t * kFwdBN + r * kFwdBox, kvh, b);
      ring.advance();
      ++u;
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<232>();
  const int tid = threadIdx.x - 128;
  const int w = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int x0 = w * 64 + warp * 16;             // the warp's rows of Q
  const int r_base = m0 + w * 64;                // the warpgroup's rows
  const int r_warp = m0 + x0;                    // the warp's 16 rows
  const int row0 = r_warp + g;                   // this thread's rows:
                                                 // row0, row0 + 8
  const float* qs = reinterpret_cast<const float*>(smem + L::kQ);
  const uint32_t lo_addr = hop::smem_u32(lo_k);
  const uint32_t vt_addr = hop::smem_u32(vt);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {hop::kNegInf, hop::kNegInf};
  float l_run[2] = {0.f, 0.f};   // this thread's part of the row sums
  hop::mbar_wait(q_full, 0);
  hop::Ring<kStages> ring;
  int u = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = state(t);
    if (st == 0) continue;
    const uint32_t par = u & 1;
    hop::mbar_wait(&k_ready[ring.stage], ring.phase);
    const int k0 = t * kFwdBN;
    // causal: the warpgroup's rows see no key of the tile
    const bool seen = !(causal && k0 > r_base + 63 + off);
    float s[kFwdBN / 2];
    if (seen)
      score_products<HD, kBM, false, kFwdBN, true>(
          s, qs, x0, hop::smem_u32(smem + L::kK + ring.stage * L::kKBytes),
          lo_addr, g, t4);
    hop::mbar_arrive(lo_free);                 // K's planes are read
    hop::mbar_arrive(&k_empty[ring.stage]);
    uint32_t pa[kFwdBN / 8][4];
    if (seen) {
      const bool all_vis =
          st == 2 && (!causal || k0 + kFwdBN - 1 <= r_warp + off);
      float mx[2] = {hop::kNegInf, hop::kNegInf};
#pragma unroll
      for (int i = 0; i < kFwdBN / 2; ++i) {
        const int hh = (i >> 1) & 1;
        bool vis = true;
        if (!all_vis) {
          const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          vis = key < Sk && (!causal || key <= row0 + 8 * hh + off) &&
                (mrow == nullptr || mrow[key] != 0);
        }
        s[i] = vis ? s[i] * scale_log2 : hop::kNegInf;
        mx[hh] = fmaxf(mx[hh], s[i]);
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
#pragma unroll
      for (int i = 0; i < kFwdBN / 2; ++i) {
        const int hh = (i >> 1) & 1;
        s[i] = s[i] > 0.5f * hop::kNegInf ? hop::exp2_fast(s[i] - m_new[hh])
                                          : 0.f;
        l_run[hh] += s[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P rounded to TF32 as the A fragments of the 8 key steps, in the
      // permuted order V^T's rows follow
#pragma unroll
      for (int j = 0; j < kFwdBN / 8; ++j) {
        pa[j][0] = rna(s[4 * j + 0]);
        pa[j][1] = rna(s[4 * j + 2]);
        pa[j][2] = rna(s[4 * j + 1]);
        pa[j][3] = rna(s[4 * j + 3]);
      }
    }
    hop::mbar_wait(vt_ready, par);
    if (seen) {
      hop::wg_fence();
#pragma unroll
      for (int j = 0; j < kFwdBN / 8; ++j)
        WgTf32<HD>::rs(o, pa[j],
                       hop::desc_k(hop::k_step_addr(vt_addr, HD, j)), 1);
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(o);
      hop::fence_regs(pa);
    }
    hop::mbar_arrive(vt_free);
    ring.advance();
    ++u;
  }

  // epilogue: the row sums over the quad, O / l, the LSE
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    const int i = row0 + 8 * hh;
    if (i >= Sq) continue;
    const float inv = l_run[hh] > 0.f ? 1.f / l_run[hh] : 0.f;
    float* orow = out + os.at(b, i, head);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) = make_float2(
          o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + head) * Sq + i] =
          l_run[hh] > 0.f ? m_run[hh] * hop::kLn2 + logf(l_run[hh])
                          : hop::kNegInf;
  }
}

// --------------------------------------------------------------- dcap
// One warp per (batch, head, query) row of [B * H, Sq_pad]: dcap =
// rowsum(dO * O) and lse * log2(e), into the f32 scratch's halves; rows
// past Sq get dcap 0 and +1e30 (P = exp2(0 - 1e30) = 0 with no test).
template <int HD>
__global__ void __launch_bounds__(128)
dcap_kernel(const float* __restrict__ o, const float* __restrict__ dout,
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
  const float* op = o + os.at(b, i, h);
  const float* dp = dout + ds.at(b, i, h);
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < HD; c += 64) {
    const float2 a = *reinterpret_cast<const float2*>(op + c);
    const float2 d = *reinterpret_cast<const float2*>(dp + c);
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    dcap[row] = acc;
    lse2[row] = lse[bh * Sq + i] * hop::kLog2e;
  }
}

// ---------------------------------------------------------------- dkdv
// K, V [chunk][128][32] (raw); per stage Q, dO [chunk][32][32] (rounded in
// place once landed); Q's and dO's lo planes; the stages' lse2 and dcap
// slices [32] f32; the barriers (K and V landed; per stage landed, ready
// and empty; the lo planes free).
template <int HD>
struct DkdvSmem {
  static constexpr int kC = chunks(HD);
  static constexpr int kKBytes = kC * kKN * kRowBytes;
  static constexpr int kQBytes = kC * kTN * kRowBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = 2 * kKBytes;             // + stage * 2 * kQBytes
  static constexpr int kLo = kQ + kStages * 2 * kQBytes;   // Q lo, dO lo
  static constexpr int kRows = kLo + 2 * kQBytes;
  static constexpr int kBars = kRows + kStages * 2 * kTN * 4;
  static constexpr int kBytes = kBars + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kKBytes % 1024 == 0 && kQBytes % 1024 == 0,
                "tiles keep the swizzle's 1024-byte period");
  static_assert(kBytes <= 232448, "a block's 227 KB of shared memory");
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse2, const float* __restrict__ dcap,
            const unsigned char* __restrict__ key_mask,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
            int H, int KV, Strides dks, Strides dvs, float scale,
            int causal) {
  using L = DkdvSmem<HD>;
  constexpr int kC = L::kC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;
  uint64_t* lo_free = ready + kStages;
  float* lo_q = reinterpret_cast<float*>(smem + L::kLo);
  float* lo_do = lo_q + L::kQBytes / 4;

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
      for (int e = threadIdx.x; e < kKN * (HD / 4); e += kThreads) {
        const int j = k0 + e / (HD / 4), c = (e % (HD / 4)) * 4;
        if (j >= Sk) continue;
        *reinterpret_cast<float4*>(dk + dks.at(b, j, kvh) + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + dvs.at(b, j, kvh) + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kConsumers);
      hop::mbar_init(&ready[s], kSplitters);
    }
    hop::mbar_init(lo_free, kConsumers);
    hop::fence_barrier_init();
  }
  __syncthreads();

  // query tiles from the first that can see this block's first key
  const int qt0 = causal ? max(0, k0 - off) / kTN : 0;
  const int n_qt = (Sq + kTN - 1) / kTN;

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<40>();
    if (threadIdx.x > 0) {
      // the splitters: each tile once landed, and once the consumers are
      // past the last tile's reads of the lo planes
      hop::Ring<kStages> ring;
      int t = 0;
      for (int r = 0; r < rep; ++r)
        for (int qt = qt0; qt < n_qt; ++qt, ++t) {
          hop::mbar_wait(&full[ring.stage], ring.phase);
          if (t > 0) hop::mbar_wait(lo_free, (t - 1) & 1);
          float* qt_ = reinterpret_cast<float*>(smem + L::kQ +
                                                ring.stage * 2 * L::kQBytes);
          split_tile(qt_, lo_q, L::kQBytes / 4, threadIdx.x - 1);
          split_tile(qt_ + L::kQBytes / 4, lo_do, L::kQBytes / 4,
                     threadIdx.x - 1);
          hop::mbar_arrive(&ready[ring.stage]);
          ring.advance();
        }
      return;
    }
    hop::mbar_expect_tx(kv_full, 2 * kC * (kKN / kBoxRows) * kBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kKN / kBoxRows; ++r) {
        const int at = (c * kKN + r * kBoxRows) * kRowBytes;
        hop::tma_load(&tm_k, kv_full, smem + L::kK + at, c * kCols,
                      k0 + r * kBoxRows, kvh, b);
        hop::tma_load(&tm_v, kv_full, smem + L::kV + at, c * kCols,
                      k0 + r * kBoxRows, kvh, b);
      }
    hop::Ring<kStages> ring;
    for (int r = 0; r < rep; ++r) {
      const int h = kvh * rep + r;
      const size_t prow = ((size_t)b * H + h) * Sq_pad;
      for (int qt = qt0; qt < n_qt; ++qt) {
        hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        uint64_t* bar = &full[ring.stage];
        hop::mbar_expect_tx(bar, 2 * kC * (kTN / kBoxRows) * kBoxBytes +
                                     2 * kTN * 4);
        unsigned char* qb = smem + L::kQ + ring.stage * 2 * L::kQBytes;
        unsigned char* db = qb + L::kQBytes;
        for (int c = 0; c < kC; ++c)
          for (int rr = 0; rr < kTN / kBoxRows; ++rr) {
            const int at = (c * kTN + rr * kBoxRows) * kRowBytes;
            const int q = qt * kTN + rr * kBoxRows;
            hop::tma_load(&tm_q, bar, qb + at, c * kCols, q, h, b);
            hop::tma_load(&tm_do, bar, db + at, c * kCols, q, h, b);
          }
        float* rows = reinterpret_cast<float*>(smem + L::kRows) +
                      ring.stage * 2 * kTN;
        hop::bulk_load(rows, lse2 + prow + qt * kTN, kTN * 4, bar);
        hop::bulk_load(rows + kTN, dcap + prow + qt * kTN, kTN * 4, bar);
        ring.advance();
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<232>();
  const int tid = threadIdx.x - 128;
  const int w = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int x0 = w * 64 + warp * 16;           // the warp's rows of K, V
  const int kg0 = k0 + w * 64;                 // the warpgroup's keys
  const int kw0 = k0 + x0;                     // the warp's keys
  int key[2];
  bool key_vis[2];   // keys past Sk are never stored: no test needed
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = kw0 + g + 8 * hh;
    key_vis[hh] = mrow == nullptr || key[hh] >= Sk || mrow[key[hh]] != 0;
  }
  const bool warp_vis = __all_sync(0xffffffffu, key_vis[0] && key_vis[1]);
  const float* ks_ = reinterpret_cast<const float*>(smem + L::kK);
  const float* vs_ = reinterpret_cast<const float*>(smem + L::kV);
  const uint32_t lo_q_addr = hop::smem_u32(lo_q);
  const uint32_t lo_do_addr = hop::smem_u32(lo_do);
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  hop::mbar_wait(kv_full, 0);
  hop::Ring<kStages> ring;
  for (int r = 0; r < rep; ++r) {
    for (int qt = qt0; qt < n_qt; ++qt) {
      hop::mbar_wait(&ready[ring.stage], ring.phase);
      const int i0 = qt * kTN;
      const float* qt_ = reinterpret_cast<const float*>(
          smem + L::kQ + ring.stage * 2 * L::kQBytes);
      const float* dt_ = qt_ + L::kQBytes / 4;
      // causal: no query of the tile sees a key of this warpgroup
      const bool seen = !(causal && kg0 > i0 + kTN - 1 + off);
      float s[kTN / 2], dp[kTN / 2];   // keys x queries
      if (seen) {
        score_products<HD, kKN, false>(s, ks_, x0, hop::smem_u32(qt_),
                                       lo_q_addr, g, t4);
        score_products<HD, kKN, true>(dp, vs_, x0, hop::smem_u32(dt_),
                                      lo_do_addr, g, t4);
      }
      hop::mbar_arrive(lo_free);        // the lo planes are read
      if (seen) {
        const float* rows = reinterpret_cast<const float*>(
                                smem + L::kRows) + ring.stage * 2 * kTN;
        // every query of the tile sees every key of this warp
        const bool all_vis =
            warp_vis && (!causal || kw0 + 15 <= i0 + off);
#pragma unroll
        for (int i = 0; i < kTN / 2; ++i) {
          const int hh = (i >> 1) & 1;
          const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
          float p = hop::exp2_fast(s[i] * scale_log2 - rows[qc]);
          if (!all_vis) {
            const bool vis =
                key_vis[hh] && (!causal || key[hh] <= i0 + qc + off);
            p = vis ? p : 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - rows[kTN + qc]) * scale;
        }
        p_times_hi<HD, kTN>(dva, s, dt_, g, t4);
        p_times_hi<HD, kTN>(dka, dp, qt_, g, t4);
      }
      hop::mbar_arrive(&empty[ring.stage]);
      ring.advance();
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= Sk) continue;
    float* dkr = dk + dks.at(b, key[hh], kvh);
    float* dvr = dv + dvs.at(b, key[hh], kvh);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(dkr + c) =
          make_float2(dka[4 * j + 2 * hh], dka[4 * j + 2 * hh + 1]);
      *reinterpret_cast<float2*>(dvr + c) =
          make_float2(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------------ dq
// Q, dO [chunk][128][32] (raw); per stage K then V [chunk][32][32]
// (rounded in place once landed); K's and V's lo planes; the barriers (Q
// and dO landed; per stage landed, ready and empty; the lo planes free);
// the key-tile states.
template <int HD>
struct DqSmem {
  static constexpr int kC = chunks(HD);
  static constexpr int kQBytes = kC * kBM * kRowBytes;
  static constexpr int kKBytes = kC * kTN * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQBytes;
  static constexpr int kKV = 2 * kQBytes;             // + stage * 2 * kKBytes
  static constexpr int kLo = kKV + kStages * 2 * kKBytes;   // K lo, V lo
  static constexpr int kBars = kLo + 2 * kKBytes;
  static constexpr int kState = kBars + 8 * (2 + 3 * kStages);
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0,
                "tiles keep the swizzle's 1024-byte period");
  static int bytes(int n_state) {
    return kState + ((n_state + 15) & ~15) + 1024;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse2, const float* __restrict__ dcap,
          const unsigned char* __restrict__ key_mask, float* __restrict__ dq,
          int Sq, int Sk, int H, int KV, Strides dqs, float scale,
          int causal) {
  using L = DqSmem<HD>;
  constexpr int kC = L::kC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;
  uint64_t* lo_free = ready + kStages;
  float* lo_k = reinterpret_cast<float*>(smem + L::kLo);
  float* lo_v = lo_k + L::kKBytes / 4;
  unsigned char* tile_state = smem + L::kState;

  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int kvh = head / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int off = Sk - Sq;
  const int Sq_pad = padded(Sq);
  const float scale_log2 = scale * hop::kLog2e;
  const int n_tiles = hop::key_tiles(m0, kBM, kTN, Sq, Sk, causal);
  const unsigned char* mrow =
      key_mask != nullptr ? key_mask + (size_t)b * Sk : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kConsumers);
      hop::mbar_init(&ready[s], kSplitters);
    }
    hop::mbar_init(lo_free, kConsumers);
    hop::fence_barrier_init();
  }
  if (mrow != nullptr)
    hop::scan_key_tiles<kTN>(mrow, Sk, n_tiles, tile_state);
  __syncthreads();
  auto state = [&](int t) -> int {
    if (mrow != nullptr) return tile_state[t];
    return (t + 1) * kTN <= Sk ? 2 : 1;
  };

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    hop::reg_dealloc<40>();
    if (threadIdx.x > 0) {
      // the splitters, as dkdv's
      hop::Ring<kStages> ring;
      int u = 0;
      for (int t = 0; t < n_tiles; ++t) {
        if (state(t) == 0) continue;
        hop::mbar_wait(&full[ring.stage], ring.phase);
        if (u > 0) hop::mbar_wait(lo_free, (u - 1) & 1);
        float* kt = reinterpret_cast<float*>(smem + L::kKV +
                                             ring.stage * 2 * L::kKBytes);
        split_tile(kt, lo_k, L::kKBytes / 4, threadIdx.x - 1);
        split_tile(kt + L::kKBytes / 4, lo_v, L::kKBytes / 4,
                   threadIdx.x - 1);
        hop::mbar_arrive(&ready[ring.stage]);
        ring.advance();
        ++u;
      }
      return;
    }
    hop::mbar_expect_tx(q_full, 2 * kC * (kBM / kBoxRows) * kBoxBytes);
    for (int c = 0; c < kC; ++c)
      for (int r = 0; r < kBM / kBoxRows; ++r) {
        const int at = (c * kBM + r * kBoxRows) * kRowBytes;
        hop::tma_load(&tm_q, q_full, smem + L::kQ + at, c * kCols,
                      m0 + r * kBoxRows, head, b);
        hop::tma_load(&tm_do, q_full, smem + L::kDo + at, c * kCols,
                      m0 + r * kBoxRows, head, b);
      }
    hop::Ring<kStages> ring;
    for (int t = 0; t < n_tiles; ++t) {
      if (state(t) == 0) continue;
      hop::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      uint64_t* bar = &full[ring.stage];
      hop::mbar_expect_tx(bar, 2 * kC * (kTN / kBoxRows) * kBoxBytes);
      unsigned char* kb = smem + L::kKV + ring.stage * 2 * L::kKBytes;
      for (int c = 0; c < kC; ++c)
        for (int r = 0; r < kTN / kBoxRows; ++r) {
          const int at = (c * kTN + r * kBoxRows) * kRowBytes;
          const int key = t * kTN + r * kBoxRows;
          hop::tma_load(&tm_k, bar, kb + at, c * kCols, key, kvh, b);
          hop::tma_load(&tm_v, bar, kb + L::kKBytes + at, c * kCols, key,
                        kvh, b);
        }
      ring.advance();
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hop::reg_alloc<232>();
  const int tid = threadIdx.x - 128;
  const int w = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int x0 = w * 64 + warp * 16;           // the warp's rows of Q, dO
  const int r_base = m0 + w * 64;              // the warpgroup's rows
  const int row0 = m0 + x0 + g;                // this thread's: row0, +8
  const float* qs = reinterpret_cast<const float*>(smem + L::kQ);
  const float* dos = reinterpret_cast<const float*>(smem + L::kDo);
  const uint32_t lo_k_addr = hop::smem_u32(lo_k);
  const uint32_t lo_v_addr = hop::smem_u32(lo_v);
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  float lrow[2], crow[2];
  const size_t prow = ((size_t)b * H + head) * Sq_pad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lrow[hh] = lse2[prow + row0 + 8 * hh];   // rows < Sq_pad
    crow[hh] = dcap[prow + row0 + 8 * hh];
  }

  hop::mbar_wait(q_full, 0);
  hop::Ring<kStages> ring;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = state(t);
    if (st == 0) continue;
    hop::mbar_wait(&ready[ring.stage], ring.phase);
    const int k0 = t * kTN;
    const float* kt = reinterpret_cast<const float*>(
        smem + L::kKV + ring.stage * 2 * L::kKBytes);
    const float* vt = kt + L::kKBytes / 4;
    const bool seen = !(causal && k0 > r_base + 63 + off);
    float s[kTN / 2], dp[kTN / 2];   // queries x keys
    if (seen) {
      score_products<HD, kBM, false>(s, qs, x0, hop::smem_u32(kt),
                                     lo_k_addr, g, t4);
      score_products<HD, kBM, true>(dp, dos, x0, hop::smem_u32(vt),
                                    lo_v_addr, g, t4);
    }
    hop::mbar_arrive(lo_free);          // the lo planes are read
    if (seen) {
      const bool all_vis =
          st == 2 && (!causal || k0 + kTN - 1 <= m0 + x0 + off);
#pragma unroll
      for (int i = 0; i < kTN / 2; ++i) {
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
      p_times_hi<HD, kTN>(dqa, dp, kt, g, t4);
    }
    hop::mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + 8 * hh;
    if (i >= Sq) continue;
    float* orow = dq + dqs.at(b, i, head);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
          make_float2(dqa[4 * j + 2 * hh], dqa[4 * j + 2 * hh + 1]);
  }
}

// ---------------------------------------------------------------- host
// The tensor maps of n tensors, boxes of kCols x box_rows f32
bool encode_maps(CUtensorMap* tm, const void* const* bases, int n,
                 const long long* maps, int box_rows = kBoxRows) {
  for (int t = 0; t < n; ++t)
    if (!hop::encode_map(&tm[t], bases[t], maps + 7 * t,
                         hop::tma_type<float>(), kCols, box_rows))
      return false;
  return true;
}

template <int HD>
int launch_fwd(const CUtensorMap* tm, float* o, float* lse,
               const unsigned char* mask, int B, int Sq, int Sk, int H,
               int KV, Strides os, float scale, int causal, cudaStream_t s) {
  using L = FwdSmem<HD>;
  const int tiles = (Sk + kFwdBN - 1) / kFwdBN;
  const int n_state =
      mask == nullptr ? 0 : tiles < L::kMaxStates ? tiles : L::kMaxStates;
  const int smem = L::bytes(n_state);
  static int granted[64];
  cudaError_t err = hop::allow_smem(fwd_kernel<HD>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  fwd_kernel<HD><<<grid, kThreads, smem, s>>>(
      tm[0], tm[1], tm[2], o, lse, mask, Sq, Sk, H, KV, os,
      scale * hop::kLog2e, causal, n_state);
  return (int)cudaGetLastError();
}

// st: the element strides of q, k, v, out, dout, dq, dk, dv, in that order
template <int HD>
int launch_bwd(const CUtensorMap* tm, const float* o, const float* dout,
               const float* lse, float* scratch, float* dq, float* dk,
               float* dv, const unsigned char* mask, int B, int Sq, int Sk,
               int H, int KV, const Strides* st, float scale, int causal,
               cudaStream_t s) {
  const int Sq_pad = padded(Sq);
  const long rows = (long)B * H * Sq_pad;
  float* lse2 = scratch;
  float* dcap = scratch + rows;
  dcap_kernel<HD><<<(unsigned)((rows + 3) / 4), 128, 0, s>>>(
      o, dout, lse, lse2, dcap, rows, Sq, Sq_pad, H, st[3], st[4]);
  const int smem1 = DkdvSmem<HD>::kBytes;
  static int granted1[64], granted2[64];
  cudaError_t err = hop::allow_smem(dkdv_kernel<HD>, smem1, granted1);
  if (err != cudaSuccess) return (int)err;
  dim3 g1(B * KV, (Sk + kKN - 1) / kKN);
  dkdv_kernel<HD><<<g1, kThreads, smem1, s>>>(
      tm[0], tm[1], tm[2], tm[3], lse2, dcap, mask, dk, dv, Sq, Sk, H, KV,
      st[6], st[7], scale, causal);
  const int smem2 =
      DqSmem<HD>::bytes(mask != nullptr ? (Sk + kTN - 1) / kTN : 0);
  err = hop::allow_smem(dq_kernel<HD>, smem2, granted2);
  if (err != cudaSuccess) return (int)err;
  dim3 g2(B * H, (Sq + kBM - 1) / kBM);
  dq_kernel<HD><<<g2, kThreads, smem2, s>>>(
      tm[0], tm[1], tm[2], tm[3], lse2, dcap, mask, dq, Sq, Sk, H, KV, st[5],
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out f32; the arguments of flash_fwd.cu's flash_fwd_bf16
// (`maps`: 21 int64, the tensor-map values of
// kernels/flash_attention.py::tma_dims for q, k and v; `out_strides`: the
// batch, sequence and head element strides of out; `lse` and `key_mask`
// may be null). Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue when a tensor map is refused or hd is not 64, 72
// or 128).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* key_mask, int B,
                             int Sq, int Sk, int H, int KV, int hd,
                             const long long* maps,
                             const long long* out_strides, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm[3];
  const void* bases[3] = {q, k, v};
  if (!encode_maps(tm, bases, 3, maps, kFwdBox))
    return (int)cudaErrorInvalidValue;
  Strides os{out_strides[0], out_strides[1], out_strides[2]};
  float* out = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  const unsigned char* m = static_cast<const unsigned char*>(key_mask);
  if (hd == 128)
    return launch_fwd<128>(tm, out, l, m, B, Sq, Sk, H, KV, os, scale,
                           causal, s);
  if (hd == 72)
    return launch_fwd<72>(tm, out, l, m, B, Sq, Sk, H, KV, os, scale,
                          causal, s);
  if (hd == 64)
    return launch_fwd<64>(tm, out, l, m, B, Sq, Sk, H, KV, os, scale,
                          causal, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out, dout, dq, dk and dv f32; the arguments of flash_bwd.cu's
// flash_bwd_bf16 (`scratch`: 2 * B * H * Sq_pad f32, Sq_pad = Sq rounded
// up to 128; `maps`: 28 int64 for q, k, v and dout; `strides`: 24 int64,
// the batch, sequence and head element strides of q, k, v, out, dout, dq,
// dk and dv). Returns the launches' cudaError_t (0 on success).
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* scratch, void* dq,
                             void* dk, void* dv, const void* key_mask, int B,
                             int Sq, int Sk, int H, int KV, int hd,
                             const long long* maps,
                             const long long* strides, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm[4];
  const void* bases[4] = {q, k, v, dout};
  if (!encode_maps(tm, bases, 4, maps)) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
#define PTT_ARGS                                                          \
  tm, static_cast<const float*>(o), static_cast<const float*>(dout),      \
      static_cast<const float*>(lse), static_cast<float*>(scratch),       \
      static_cast<float*>(dq), static_cast<float*>(dk),                   \
      static_cast<float*>(dv),                                            \
      static_cast<const unsigned char*>(key_mask), B, Sq, Sk, H, KV, st,  \
      scale, causal, s
  if (hd == 128) return launch_bwd<128>(PTT_ARGS);
  if (hd == 72) return launch_bwd<72>(PTT_ARGS);
  if (hd == 64) return launch_bwd<64>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}
