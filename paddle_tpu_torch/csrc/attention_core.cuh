// mma.sync m16n8k16 on bf16 or f16 with f32 accumulation, and the
// fragment packing around it, for ragged_paged_attention.cu (Q K^T and P V
// of the decode and prefill tiles). `Mma<T>` names both by element type:
// the two 16-bit types share every fragment layout and ldmatrix (b16),
// and differ only in the instruction's input type and the rounding of P.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8):       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// so the C fragments of two n8 tiles are the A fragment of one k16 step:
// scores re-pack into P without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;
typedef __half f16;

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

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_f16(float c[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k16 product and the packing of two f32 values (round to
// nearest even) into an operand register, by element type
template <class T>
struct Mma;
template <>
struct Mma<bf16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};
template <>
struct Mma<f16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
};

}  // namespace ptt
