// 3xTF32 tensor-core products in float32 precision (sm_80 and later;
// built here for sm_90a).
//
// A float32 x splits as x = big + small + r, big = tf32(x) and
// small = tf32(x - big), both rounded to nearest with ties away (as
// cvt.rna rounds), so |x - big| <= 2^-11 |x| and |r| <= 2^-22 |x|.  A
// product a.b is then a_small.b_big + a_big.b_small + a_big.b_big, each term exact
// in the tensor core (11 x 11 significant bits); what it leaves out,
// a_small.b_small and the two residues, is at most about 3 * 2^-22 |a||b|
// = 12 u |a||b| (u = 2^-24).  `mma3` issues the three products into one
// float32 accumulator, the small terms first (CUTLASS's 3xTF32 order).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"; CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, column):      b0 (k = t, n = g)       b1 (k = t+4, n = g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once

#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (10 explicit significand bits), to nearest with ties
// away from zero; the low 13 bits of the result are 0.  For finite x this
// is cvt.rna.tf32.f32's result, in two integer operations: 0x1000 added to
// the bits (the magnitude, whatever the sign), the low 13 cleared.
// cvt.rna itself compiles to four on sm_90 (its NaN test and select).
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small to within 2^-22 |x|; x - big is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna(x);
  small = rna(x - __uint_as_float(big));
}

// c += a b on one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in float32 precision: small.big, then big.small, then big.big.
__device__ __forceinline__ void mma3(float (&c)[4],
                                     const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  mma(c, a_small, b_big);
  mma(c, a_big, b_small);
  mma(c, a_big, b_big);
}

}  // namespace tf32
