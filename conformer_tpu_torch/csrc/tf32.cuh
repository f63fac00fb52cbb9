// TF32 tensor-core helpers for fp32 accuracy on mma.sync (3xTF32), shared
// by the log-mel frontend (mel_frontend.cu, K3) and the general attention
// kernels (attention_general.cuh, K1/K2): a . b ~ a_hi.b_hi + a_hi.b_lo +
// a_lo.b_hi, where x_hi is x rounded to TF32 and x_lo the rest rounded to
// TF32 (the dropped a_lo.b_lo is ~2^-22 of a.b).
//
// mma.sync m16n8k8 TF32 fragments, with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (k t, n g), b1 (k t+4, n g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once

#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) of x: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (hi, lo) of x by truncation, two instructions instead of two cvt: hi =
// x with its low 13 bits cleared, lo = x - hi (exact) passed whole, of
// which the tensor cores read the top 19 bits. |lo| < 2^-10 |x| and lo
// loses under 2^-10 of itself, so hi + lo holds x to 2^-20 of it (the
// rounded split: 2^-21).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// d += a . b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b with a zero accumulator.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a . b in 3xTF32 from split operands, the small terms first.
__device__ __forceinline__ void mma3x(float (&d)[4], const uint32_t (&a_hi)[4],
                                      const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                      uint32_t b1_hi, uint32_t b0_lo,
                                      uint32_t b1_lo) {
  mma(d, a_lo, b0_hi, b1_hi);
  mma(d, a_hi, b0_lo, b1_lo);
  mma(d, a_hi, b0_hi, b1_hi);
}

}  // namespace tf32
