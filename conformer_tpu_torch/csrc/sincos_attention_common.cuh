// Pieces shared by the fused attention's forward (sincos_attention.cu, K1)
// and backward (sincos_attention_bwd.cu, K2): the masking rule, the
// dropout hash and the bf16 mma.sync fragment helpers. The general kernels'
// shared pieces are in attention_general.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int DH = 64;        // head width of the wgmma kernels
constexpr float NEG_INF = -FLT_MAX;  // float32.min, the JAX mask sentinel

// Masked score of key `key`: -inf past L, float32.min past the length.
__device__ __forceinline__ float mask_score(float s, int key, int len, int L) {
  return key >= L ? -INFINITY : (key < len ? s : NEG_INF);
}

// ---------------------------------------------------------------------------
// Dropout: conformer_tpu/ops/pallas/sincos_attention.py::_dropout_keep, bit
// for bit. The JAX kernel hashes (seed, batch, head, q-tile index qi, row in
// the tile, column) for its own q-tile rows tq; here tq is an argument and
// every query row q maps to qi = q / tq and row = q % tq, whatever tiling
// these kernels use. row_hash folds everything but the column.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t row_hash(uint32_t seed, int b, int h,
                                             int q, int tq) {
  const uint32_t qi = (uint32_t)(q / tq), r = (uint32_t)(q % tq);
  return seed * 0x9E3779B9u + (uint32_t)b * 0x85EBCA6Bu +
         (uint32_t)h * 0xC2B2AE35u + qi * 0x27D4EB2Fu + r * 0x01000193u;
}

// True where the element of (row hash, key) is kept: P = 1 - rate.
__device__ __forceinline__ bool keep(uint32_t row, int key, uint32_t thresh) {
  uint32_t x = row + (uint32_t)key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// ---------------------------------------------------------------------------
// bfloat16 mma.sync m16n8k16 (fp32 accumulators). Fragment layout, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8):             c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace attn
