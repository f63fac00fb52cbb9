// Pieces shared by the fused attention's forward (sincos_attention.cu, K1)
// and backward (sincos_attention_bwd.cu, K2): the masking rule, the
// dropout hash, the bf16 mma.sync fragment helpers, and the parts of the
// general kernels (any head width up to 128, any D, fp32 or bf16) that
// both use: element loads and stores, the score depth's operands, and the
// alpha | beta pass.
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

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment at rows r0.., cols k0.. of a row-major tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A fragment of X^T, where X is stored [k][m] with row stride ld: rows
// m0.., depth k0.. of the transposed tile.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0, int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * ld + m0 + g;
  a[0] = pack_raw(p[0], p[ld]);
  a[1] = pack_raw(p[8], p[ld + 8]);
  a[2] = pack_raw(p[8 * ld], p[9 * ld]);
  a[3] = pack_raw(p[8 * ld + 8], p[9 * ld + 8]);
}

// B fragment from a tile stored [n][k] with row stride ld.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment from a tile stored [k][n] with row stride ld.
__device__ __forceinline__ void load_b_t(uint32_t& b0, uint32_t& b1,
                                         const bf16* s, int ld, int n0, int k0,
                                         int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b0 = pack_raw(p[0], p[ld]);
  b1 = pack_raw(p[8 * ld], p[9 * ld]);
}

// Store the 8 values of a 16-byte vector as column `col` of rows r0..r0+7
// of a [row][ld] tile (a transposing store).
__device__ __forceinline__ void store_column(bf16* s, int ld, int r0, int col,
                                             const uint4& x) {
  const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[(r0 + i) * ld + col] = e[i];
}

// ---------------------------------------------------------------------------
// The general kernels (namespace general in both sources, their shared
// pieces here in fma_tiles): CUDA-core FMAs on 64 x 64 tiles, 16 x 16
// threads with 4 x 4 outputs each. The head
// width dh is a runtime value; the forward's value tile and its
// accumulators are sized by DHP, dh rounded up to 16, 32, 64 or 128 (a dh
// below DHP is masked). Operands are loaded as T (float or bf16) and
// widened; sums, softmax and statistics are fp32; a value the plain version
// rounds to T (alpha, beta, the probabilities before P.V, ds, p_drop, da)
// is rounded to T here too, and outputs are rounded to T once.
//
// The score of query i and key j is one dot product over a virtual depth
// of E = dh + D: [qu_i | alpha_i | beta_i] . [k_j | cos_j | sin_j], taken in
// chunks of 64 whatever dh and D/2 are (the last chunk zero-filled), so no
// head width or table width needs a chunk of its own.
// ---------------------------------------------------------------------------

namespace fma_tiles {

constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TQ = 64;        // query rows per tile
constexpr int TK = 64;        // keys per tile
constexpr int SP = 65;        // padded stride of the 64-wide staging tiles

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void st(bf16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the plain version's .to(dtype).float().
template <class T>
__device__ __forceinline__ float rnd(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element e of query row q's score operand [qu | alpha | beta]: `qrow`
// points at qu[b, q, h*dh], `abq` at row q of this head's alpha | beta.
template <class T>
__device__ __forceinline__ float query_elem(const T* qrow, const float* abq,
                                            int e, int dh) {
  return e < dh ? ld(qrow, e) : abq[e - dh];
}

// Element e of key `key`'s score operand [k | cos | sin]: `krow` points at
// k[b, key, h*dh].
template <class T>
__device__ __forceinline__ float key_elem(const T* krow, const T* cos_t,
                                          const T* sin_t, int key, int e,
                                          int dh, int D2) {
  if (e < dh) return ld(krow, e);
  e -= dh;
  const size_t row = (size_t)key * D2;
  return e < D2 ? ld(cos_t, row + e) : ld(sin_t, row + e - D2);
}

// acc[r][c] += sum_d s_a[d][ty + 16r] * s_b[d][tx + 16c] over a 64-deep
// chunk of two [depth][64] tiles.
__device__ __forceinline__ void chunk_fma(float (&acc)[4][4], const float* s_a,
                                          const float* s_b, int ty, int tx) {
  for (int d = 0; d < 64; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) qa[r] = s_a[d * SP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = s_b[d * SP + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qa[r], kb[c], acc[r][c]);
  }
}

constexpr size_t PREP_SMEM = sizeof(float) * 3 * 64 * SP;

// alpha | beta of one 64-row query tile of head h (grid (L/64, H, B)):
//   a = qv_h . wh[h] (fp32), alpha = T(a_s sin_q + a_c cos_q),
//   beta = T(-a_s cos_q + a_c sin_q),
// to ab[(b*H + h), q, 0:D] in fp32 (PREP_SMEM bytes of dynamic shared
// memory).
template <class T>
__global__ void __launch_bounds__(THREADS)
prep(const T* __restrict__ qv, const T* __restrict__ wh,
     const T* __restrict__ sin_t, const T* __restrict__ cos_t,
     float* __restrict__ ab, int L, int H, int dh) {
  const int D = H * dh, D2 = D / 2;
  extern __shared__ float smem_prep[];
  float* s_qv = smem_prep;        // [depth][row]
  float* s_w0 = s_qv + 64 * SP;   // [depth][column], sin half of wh[h]
  float* s_w1 = s_w0 + 64 * SP;   // cos half
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qvh = qv + (size_t)b * L * D + (size_t)h * dh;
  const T* whh = wh + (size_t)h * dh * D;
  float* abh = ab + ((size_t)b * H + h) * L * D;
  for (int c0 = 0; c0 < D2; c0 += 64) {
    float as[4][4], ac[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) as[r][c] = ac[r][c] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += 64) {
      __syncthreads();
      for (int i = tid; i < 64 * 64; i += THREADS) {
        const int j = i / 64, x = i % 64, q = q0 + j, d = d0 + x;
        s_qv[x * SP + j] = q < L && d < dh ? ld(qvh, (size_t)q * D + d) : 0.f;
        const int dw = d0 + j, col = c0 + x;
        const bool in = dw < dh && col < D2;
        s_w0[j * SP + x] = in ? ld(whh, (size_t)dw * D + col) : 0.f;
        s_w1[j * SP + x] = in ? ld(whh, (size_t)dw * D + D2 + col) : 0.f;
      }
      __syncthreads();
      chunk_fma(as, s_qv, s_w0, ty, tx);
      chunk_fma(ac, s_qv, s_w1, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + ty + 16 * r;
      if (q >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c0 + tx + 16 * c;
        if (x >= D2) continue;
        const float sq = ld(sin_t, (size_t)q * D2 + x);
        const float cq = ld(cos_t, (size_t)q * D2 + x);
        abh[(size_t)q * D + x] = rnd<T>(as[r][c] * sq + ac[r][c] * cq);
        abh[(size_t)q * D + D2 + x] = rnd<T>(-as[r][c] * cq + ac[r][c] * sq);
      }
    }
  }
}

// The accumulator width of the forward's value product: dh rounded up to
// 16, 32, 64 or 128; 0 past 128.
inline int padded_head(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 0;
}

}  // namespace fma_tiles

}  // namespace attn
