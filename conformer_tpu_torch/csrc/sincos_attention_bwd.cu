// Fused shift-free relative-position attention, backward (K2), for Hopper
// (sm_90a).
//
// Replaces: conformer_tpu/ops/pallas/sincos_attention.py::_bwd_kernel,
// reached through _bwd_call and the custom VJP _fused. Packed (B, L, D)
// layout, head h in columns [h*64, (h+1)*64); the caller has folded the
// score scale into qu and qv. With s the scores of the forward
// (sincos_attention.cu), m and l each row's softmax max and sum from K1's
// `stats`, and keep the forward's dropout mask, regenerated from the hash:
//   p     = exp(s - m) / max(l, 1e-9)                  fp32
//   dp    = keep . (dO . v^T) / (1 - rate)
//   delta = sum_j p . dp                               (per row)
//   ds    = T(p . (dp - delta))
//   dv    = T(p_drop)^T . dO,  p_drop = keep . p / (1 - rate)
//   dqu   = ds . k,  dk = ds^T . qu
//   dalpha = ds . cos, dbeta = ds . sin
//   da_s  = T(dalpha . sin_q - dbeta . cos_q), da_c = T(dalpha . cos_q + dbeta . sin_q)
//   dqv   = da . wh^T,  dwh = sum over batch rows of qv^T . da
// T is the input dtype. dqu/dqv come out in T; dk, dv and dwh are summed in
// fp32 and cast once at the end, as the JAX kernel keeps them in fp32 refs.
// delta is summed as the JAX kernel sums it, not taken as dO . O with K1's
// output: that O carries p_drop rounded to bf16 and every O a summation
// order of its own, and where p piles onto one key (a row of length 1)
// the true ds is exactly 0 and dO . O leaves a residue in it.
//
// What bounds it on the H100: operations. Per (batch, head) the backward
// recomputes the score product (depth 64 + D over L x L pairs) and adds the
// products dO . v^T, ds . k, ds^T . qu, p^T . dO (depth 64 each) and
// ds . [cos | sin] (depth L, D wide): FLOPs ~ 2*B*H*L^2*(2*D + 5*64), against
// ~11*B*L*D inputs and outputs; at L = 599 that is ~1500 FLOP/byte, far above
// the bf16 machine balance, so the products belong on the tensor cores.
//
// Design (bfloat16, the training dtype): three kernels on one stream, every
// product on mma.sync m16n8k16 with fp32 accumulators.
// - q_pass, one CTA per (64-row query tile, head, batch row): builds
//   [qu | alpha | beta] as K1 does (and writes alpha | beta to scratch for
//   k_pass), walks the keys 64 at a time recomputing scores and the mask,
//   once for delta (written to scratch for k_pass) and once for ds, and
//   keeps the tile's ds for all keys in shared memory (L <= 768 at H = 8:
//   sincos_attention_bwd_max_len). dqu accumulates in registers during the
//   second sweep; then dalpha/dbeta = ds . [cos | sin] 64 columns at a time,
//   da, dqv = da . wh^T, and the CTA's dwh partial qv^T . da, written in
//   fp32 to scratch.
// - k_pass, one CTA per (64-key tile, head, batch row): holds [k | cos |
//   sin] of its keys in shared memory and walks the query tiles, computing
//   the transposed scores s^T = [k | cos | sin] . [qu | alpha | beta]^T,
//   the mask, p and ds again, and accumulates dk and dv in registers: no
//   atomics, each key row is written once.
// - reduce_dwh sums the dwh partials over batch rows and query tiles in a
//   fixed order and casts.
// Masking follows the forward: keys past the length take float32.min, keys
// past L are -inf, so a row of length 0 has uniform weights in the
// backward too. Rows past L of the ragged last query tile are zero in every
// operand and their p is forced to 0 before any contraction over queries.
//
// float32 (the reference dtype) stays on CUDA-core FMAs, so fp32 inputs keep
// fp32 products, in a simpler design that materialises ds and p_drop (B, H,
// L, L) in scratch: prep (alpha | beta), scores (p and dp per 64 x 64 tile),
// rows (delta per row, then ds and p_drop in place), then every contraction
// as a launch of one strided batched fp32 GEMM, and combine (da).

#include <limits.h>

#include "sincos_attention_common.cuh"

namespace {

using namespace attn;
constexpr int TQ = 64;  // query rows per tile
constexpr int TK = 64;  // keys per tile

struct BwdArgs {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t;
  const int* lengths;
  const float* stats;  // (B, H, L, 2): K1's row max and row sum
  const void* dout;
  void *dqu, *dqv, *dk, *dv, *dwh;
  int B, L, H;
  uint32_t seed, thresh;  // dropout: keep where hash >= thresh (0: none)
  float inv_keep;         // 1 / (1 - rate)
  int tq;                 // the JAX kernel's q-tile rows, for the hash
};

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync).
// ---------------------------------------------------------------------------

namespace tensor_core {

constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int KS = 72;        // padded row stride (bf16) of 64-wide tiles

inline size_t q_pass_smem(int L, int H) {
  const int D = H * DH, LK = (L + TK - 1) / TK * TK;
  return sizeof(bf16) * ((size_t)TQ * (DH + D + 8) + (size_t)TQ * (LK + 8) +
                         6 * 64 * KS);
}

// q_pass's key tile j0: the scores s = [qu | alpha | beta] . [k | cos | sin]^T
// (s_q, row stride DH + D + 8) and dov = dO . v^T of the warp's 16 query
// rows, unmasked; leaves the tile's v in s_v and its k transposed in s_kt.
__device__ __forceinline__ void score_tile(const BwdArgs& a, const bf16* s_q,
                                           bf16* s_a, bf16* s_v, bf16* s_kt,
                                           const uint32_t (&dof)[4][4], int j0,
                                           int b, int h, float (&s)[8][4],
                                           float (&dov)[8][4]) {
  const int L = a.L, D = a.H * DH, D2 = D / 2, QS = DH + D + 8;
  const int n_chunks = 1 + D / 64, cos_chunks = D2 / 64;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
  const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (tid / 32) * 16;
  const size_t row0 = (size_t)b * L;
  const int col_h = h * DH;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dov[n][e] = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();
    for (int i = tid; i < TK * 8; i += THREADS) {
      const int j = i / 8, c = (i % 8) * 8, key = j0 + j;
      uint4 x = zero, xv = zero;
      if (key < L) {
        if (ch == 0) {
          const size_t off = (row0 + key) * D + col_h + c;
          x = *reinterpret_cast<const uint4*>(k + off);
          xv = *reinterpret_cast<const uint4*>(v + off);
        } else if (ch <= cos_chunks) {
          x = *reinterpret_cast<const uint4*>(
              cos_t + (size_t)key * D2 + (ch - 1) * 64 + c);
        } else {
          x = *reinterpret_cast<const uint4*>(
              sin_t + (size_t)key * D2 + (ch - 1 - cos_chunks) * 64 + c);
        }
      }
      *reinterpret_cast<uint4*>(s_a + j * KS + c) = x;
      if (ch == 0) {
        *reinterpret_cast<uint4*>(s_v + j * KS + c) = xv;
        store_column(s_kt, KS, c, j, x);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      load_a(af, s_q, QS, wr, ch * 64 + kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_a, KS, n * 8, kk * 16, g, t);
        mma(s[n], af, b0, b1);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b0, b1;
      load_b(b0, b1, s_v, KS, n * 8, kk * 16, g, t);
      mma(dov[n], dof[kk], b0, b1);
    }
}

inline size_t k_pass_smem(int H) {
  const int D = H * DH;
  return sizeof(bf16) * ((size_t)TK * (DH + D + 8) + 3 * 64 * KS) +
         sizeof(float) * 3 * TQ + sizeof(uint32_t) * TQ;
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
q_pass(BwdArgs a, bf16* __restrict__ ab, float* __restrict__ delta_buf,
       float* __restrict__ part) {
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2, QS = DH + D + 8;
  const int LK = (L + TK - 1) / TK * TK, DSS = LK + 8;
  extern __shared__ uint4 smem_q[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_q);  // TQ x QS [qu|alpha|beta], later [qu|da]
  bf16* s_ds = s_q + TQ * QS;                   // TQ x DSS: ds for every key
  bf16* s_a = s_ds + TQ * DSS;                  // staging
  bf16* s_b = s_a + 64 * KS;                    // staging
  bf16* s_qv = s_b + 64 * KS;                   // qv tile [row][d]
  bf16* s_do = s_qv + 64 * KS;                  // dO tile [row][d]
  bf16* s_kt = s_do + 64 * KS;                  // key tile transposed [d][key]
  bf16* s_v = s_kt + 64 * KS;                   // value tile [key][d]

  const bf16* qu = static_cast<const bf16*>(a.qu);
  const bf16* qv = static_cast<const bf16*>(a.qv);
  const bf16* wh = static_cast<const bf16*>(a.wh);
  const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
  const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (tid / 32) * 16;
  const size_t row0 = (size_t)b * L;
  const size_t bh = (size_t)b * H + h;
  const int col_h = h * DH;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // 1. qu, qv, dO tiles (zeros past L).
  for (int i = tid; i < TQ * DH / 8; i += THREADS) {
    const int r = i / 8, c = (i % 8) * 8, q = q0 + r;
    uint4 xu = zero, xv = zero, xd = zero;
    if (q < L) {
      const size_t off = (row0 + q) * D + col_h + c;
      xu = *reinterpret_cast<const uint4*>(qu + off);
      xv = *reinterpret_cast<const uint4*>(qv + off);
      xd = *reinterpret_cast<const uint4*>(dout + off);
    }
    *reinterpret_cast<uint4*>(s_q + r * QS + c) = xu;
    *reinterpret_cast<uint4*>(s_qv + r * KS + c) = xv;
    *reinterpret_cast<uint4*>(s_do + r * KS + c) = xd;
  }
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], s_qv, KS, wr, kk * 16, g, t);

  // 2. alpha and beta into s_q, as K1 computes them.
  const bf16* whh = wh + (size_t)h * DH * D;
  for (int c0 = 0; c0 < D2; c0 += 64) {
    __syncthreads();
    for (int i = tid; i < DH * 8; i += THREADS) {
      const int d = i / 8, x = (i % 8) * 8;
      const bf16* w = whh + (size_t)d * D + c0 + x;
      store_column(s_a, KS, x, d, *reinterpret_cast<const uint4*>(w));
      store_column(s_b, KS, x, d, *reinterpret_cast<const uint4*>(w + D2));
    }
    __syncthreads();
    float as[8][4], ac[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) as[n][e] = ac[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_a, KS, n * 8, kk * 16, g, t);
        mma(as[n], qa[kk], b0, b1);
        load_b(b0, b1, s_b, KS, n * 8, kk * 16, g, t);
        mma(ac[n], qa[kk], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wr + g + 8 * (e / 2), q = q0 + row;
        const int x = c0 + n * 8 + 2 * t + (e % 2);
        float sq = 0.f, cq = 0.f;
        if (q < L) {
          sq = __bfloat162float(sin_t[(size_t)q * D2 + x]);
          cq = __bfloat162float(cos_t[(size_t)q * D2 + x]);
        }
        const float a_s = as[n][e], a_c = ac[n][e];
        s_q[row * QS + DH + x] = __float2bfloat16_rn(a_s * sq + a_c * cq);
        s_q[row * QS + DH + D2 + x] = __float2bfloat16_rn(-a_s * cq + a_c * sq);
      }
  }
  __syncthreads();
  bf16* abh = ab + bh * L * D;
  for (int i = tid; i < TQ * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, q = q0 + r;
    if (q < L)
      *reinterpret_cast<uint4*>(abh + (size_t)q * D + c) =
          *reinterpret_cast<const uint4*>(s_q + r * QS + DH + c);
  }

  // 3. Two sweeps over the keys. The first sums delta = sum_j p . dp per row,
  // as the JAX kernel does; dO . O would take K1's bf16-rounded p_drop (at
  // rate 0.1 a lone p = 1 becomes 1.109375, not 1.1111) and bias delta
  // wherever p piles onto a few keys. The second forms ds (kept in s_ds) and
  // dqu += ds . k.
  uint32_t dof[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(dof[kk], s_do, KS, wr, kk * 16, g, t);
  float m_r[2], l_r[2], dl_r[2] = {0.f, 0.f};
  bool ok_r[2];
  uint32_t rh[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r, q = q0 + row;
    ok_r[r] = q < L;
    m_r[r] = ok_r[r] ? a.stats[(bh * L + q) * 2] : 0.f;
    l_r[r] = ok_r[r] ? fmaxf(a.stats[(bh * L + q) * 2 + 1], 1e-9f) : 1.f;
    if (DROP) rh[r] = row_hash(a.seed, b, h, q, a.tq);
  }
  const int len = min(a.lengths[b], L);
  float s[8][4], dov[8][4];
  for (int j0 = 0; j0 < L; j0 += TK) {
    score_tile(a, s_q, s_a, s_v, s_kt, dof, j0, b, h, s, dov);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, key = j0 + n * 8 + 2 * t + (e % 2);
        const float sc = mask_score(s[n][e], key, len, L);
        const float p = ok_r[r] ? expf(sc - m_r[r]) / l_r[r] : 0.f;
        float dp = dov[n][e];
        if (DROP) dp = keep(rh[r], key, a.thresh) ? dp * a.inv_keep : 0.f;
        dl_r[r] += p * dp;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a row hold its partials
    dl_r[r] += __shfl_xor_sync(0xffffffffu, dl_r[r], 1);
    dl_r[r] += __shfl_xor_sync(0xffffffffu, dl_r[r], 2);
    const int q = q0 + wr + g + 8 * r;
    if (t == 0 && q < L) delta_buf[bh * L + q] = dl_r[r];
  }
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j0 = 0; j0 < L; j0 += TK) {
    score_tile(a, s_q, s_a, s_v, s_kt, dof, j0, b, h, s, dov);
    uint32_t pds[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, key = j0 + n * 8 + 2 * t + (e % 2);
        const float sc = mask_score(s[n][e], key, len, L);
        const float p = ok_r[r] ? expf(sc - m_r[r]) / l_r[r] : 0.f;
        float dp = dov[n][e];
        if (DROP) dp = keep(rh[r], key, a.thresh) ? dp * a.inv_keep : 0.f;
        ds[e] = p * (dp - dl_r[r]);
      }
      pds[n / 2][2 * (n % 2)] = pack(ds[0], ds[1]);
      pds[n / 2][2 * (n % 2) + 1] = pack(ds[2], ds[3]);
      *reinterpret_cast<uint32_t*>(s_ds + (wr + g) * DSS + j0 + n * 8 + 2 * t) =
          pds[n / 2][2 * (n % 2)];
      *reinterpret_cast<uint32_t*>(s_ds + (wr + g + 8) * DSS + j0 + n * 8 +
                                   2 * t) = pds[n / 2][2 * (n % 2) + 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_kt, KS, n * 8, kk * 16, g, t);
        mma(dq[n], pds[kk], b0, b1);
      }
  }
  bf16* dqu = static_cast<bf16*>(a.dqu);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + wr + g + 8 * r;
    if (q >= L) continue;
    bf16* dst = dqu + (row0 + q) * D + col_h + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack(dq[n][2 * r], dq[n][2 * r + 1]);
  }

  // 4. dalpha, dbeta = ds . [cos | sin], 64 columns at a time -> da in s_q.
  for (int c0 = 0; c0 < D2; c0 += 64) {
    float da[8][4], db[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) da[n][e] = db[n][e] = 0.f;
    for (int j0 = 0; j0 < LK; j0 += TK) {
      __syncthreads();
      for (int i = tid; i < TK * 8; i += THREADS) {
        const int j = i / 8, x = (i % 8) * 8, key = j0 + j;
        uint4 xc = zero, xs = zero;
        if (key < L) {
          xc = *reinterpret_cast<const uint4*>(cos_t + (size_t)key * D2 + c0 + x);
          xs = *reinterpret_cast<const uint4*>(sin_t + (size_t)key * D2 + c0 + x);
        }
        store_column(s_a, KS, x, j, xc);   // [column][key]
        store_column(s_b, KS, x, j, xs);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        load_a(af, s_ds, DSS, wr, j0 + kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, s_a, KS, n * 8, kk * 16, g, t);
          mma(da[n], af, b0, b1);
          load_b(b0, b1, s_b, KS, n * 8, kk * 16, g, t);
          mma(db[n], af, b0, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wr + g + 8 * (e / 2), q = q0 + row;
        const int x = c0 + n * 8 + 2 * t + (e % 2);
        float sq = 0.f, cq = 0.f;
        if (q < L) {
          sq = __bfloat162float(sin_t[(size_t)q * D2 + x]);
          cq = __bfloat162float(cos_t[(size_t)q * D2 + x]);
        }
        s_q[row * QS + DH + x] = __float2bfloat16_rn(da[n][e] * sq - db[n][e] * cq);
        s_q[row * QS + DH + D2 + x] =
            __float2bfloat16_rn(da[n][e] * cq + db[n][e] * sq);
      }
  }

  // 5. dqv = da . wh^T (wh[h] is stored [d][x]: the B operand as it is).
  float dqv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqv[n][e] = 0.f;
  for (int x0 = 0; x0 < D; x0 += 64) {
    __syncthreads();
    for (int i = tid; i < DH * 8; i += THREADS) {
      const int d = i / 8, c = (i % 8) * 8;
      *reinterpret_cast<uint4*>(s_a + d * KS + c) =
          *reinterpret_cast<const uint4*>(whh + (size_t)d * D + x0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      load_a(af, s_q, QS, wr, DH + x0 + kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_a, KS, n * 8, kk * 16, g, t);
        mma(dqv[n], af, b0, b1);
      }
    }
  }
  bf16* dqv_out = static_cast<bf16*>(a.dqv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + wr + g + 8 * r;
    if (q >= L) continue;
    bf16* dst = dqv_out + (row0 + q) * D + col_h + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(dqv[n][2 * r], dqv[n][2 * r + 1]);
  }

  // 6. This CTA's dwh partial qv^T . da (64 x D), fp32, to scratch. Warp w
  // owns d rows 16w..16w+15; both operands are read transposed.
  float* pt = part + (bh * gridDim.x + blockIdx.x) * (size_t)DH * D;
  for (int x0 = 0; x0 < D; x0 += 64) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      load_a_t(af, s_qv, KS, wr, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b_t(b0, b1, s_q + DH, QS, x0 + n * 8, kk * 16, g, t);
        mma(acc[n], af, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = wr + g + 8 * r, x = x0 + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(pt + (size_t)d * D + x) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
  }
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
k_pass(BwdArgs a, const bf16* __restrict__ ab,
       const float* __restrict__ delta_buf) {
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2, QS = DH + D + 8;
  extern __shared__ uint4 smem_k[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_k);  // TK x QS [k | cos | sin]
  bf16* s_a = s_k + TK * QS;                    // query-side chunk [q][64]
  bf16* s_qu = s_a + 64 * KS;                   // qu tile [q][d]
  bf16* s_do = s_qu + 64 * KS;                  // dO tile [q][d]
  float* s_st = reinterpret_cast<float*>(s_do + 64 * KS);  // TQ x (m, l, delta)
  uint32_t* s_rh = reinterpret_cast<uint32_t*>(s_st + 3 * TQ);

  const bf16* qu = static_cast<const bf16*>(a.qu);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
  const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (tid / 32) * 16;
  const size_t row0 = (size_t)b * L;
  const size_t bh = (size_t)b * H + h;
  const int col_h = h * DH;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // 1. This tile's keys: [k | cos | sin] in s_k, v fragments in registers.
  const int w8 = (DH + D) / 8;
  for (int i = tid; i < TK * w8; i += THREADS) {
    const int j = i / w8, c = (i % w8) * 8, key = k0 + j;
    uint4 x = zero;
    if (key < L) {
      if (c < DH)
        x = *reinterpret_cast<const uint4*>(k + (row0 + key) * D + col_h + c);
      else if (c < DH + D2)
        x = *reinterpret_cast<const uint4*>(cos_t + (size_t)key * D2 + c - DH);
      else
        x = *reinterpret_cast<const uint4*>(sin_t + (size_t)key * D2 + c - DH - D2);
    }
    *reinterpret_cast<uint4*>(s_k + j * QS + c) = x;
  }
  for (int i = tid; i < TK * DH / 8; i += THREADS) {
    const int j = i / 8, c = (i % 8) * 8, key = k0 + j;
    uint4 x = zero;
    if (key < L)
      x = *reinterpret_cast<const uint4*>(v + (row0 + key) * D + col_h + c);
    *reinterpret_cast<uint4*>(s_a + j * KS + c) = x;
  }
  __syncthreads();
  uint32_t va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(va[kk], s_a, KS, wr, kk * 16, g, t);

  const int len = min(a.lengths[b], L);
  int kj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kj[r] = k0 + wr + g + 8 * r;
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const bf16* abh = ab + bh * L * D;
  const int n_chunks = 1 + D / 64;

  // 2. Query tiles.
  for (int q0 = 0; q0 < L; q0 += TQ) {
    __syncthreads();
    for (int i = tid; i < TQ * DH / 8; i += THREADS) {
      const int r = i / 8, c = (i % 8) * 8, q = q0 + r;
      uint4 xu = zero, xd = zero;
      if (q < L) {
        const size_t off = (row0 + q) * D + col_h + c;
        xu = *reinterpret_cast<const uint4*>(qu + off);
        xd = *reinterpret_cast<const uint4*>(dout + off);
      }
      *reinterpret_cast<uint4*>(s_qu + r * KS + c) = xu;
      *reinterpret_cast<uint4*>(s_do + r * KS + c) = xd;
    }
    if (tid < TQ) {
      const int q = q0 + tid;
      const bool ok = q < L;
      s_st[3 * tid] = ok ? a.stats[(bh * L + q) * 2] : 0.f;
      s_st[3 * tid + 1] = ok ? fmaxf(a.stats[(bh * L + q) * 2 + 1], 1e-9f) : 1.f;
      s_st[3 * tid + 2] = ok ? delta_buf[bh * L + q] : 0.f;
      s_rh[tid] = DROP ? row_hash(a.seed, b, h, q, a.tq) : 0u;
    }
    // s^T = [k | cos | sin] . [qu | alpha | beta]^T (keys x queries)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch > 0) {
        __syncthreads();
        for (int i = tid; i < TQ * 8; i += THREADS) {
          const int r = i / 8, c = (i % 8) * 8, q = q0 + r;
          uint4 x = zero;
          if (q < L)
            x = *reinterpret_cast<const uint4*>(abh + (size_t)q * D + (ch - 1) * 64 + c);
          *reinterpret_cast<uint4*>(s_a + r * KS + c) = x;
        }
      }
      __syncthreads();
      const bf16* bsrc = ch == 0 ? s_qu : s_a;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        load_a(af, s_k, QS, wr, ch * 64 + kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, bsrc, KS, n * 8, kk * 16, g, t);
          mma(s[n], af, b0, b1);
        }
      }
    }
    // (dO . v^T)^T = v . dO^T
    float dov[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dov[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_do, KS, n * 8, kk * 16, g, t);
        mma(dov[n], va[kk], b0, b1);
      }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kj[e / 2], il = n * 8 + 2 * t + (e % 2), q = q0 + il;
        const float sc = mask_score(s[n][e], key, len, L);
        const float p = q < L ? expf(sc - s_st[3 * il]) / s_st[3 * il + 1] : 0.f;
        float dp = dov[n][e], pd = p;
        if (DROP) {
          const bool kp = keep(s_rh[il], key, a.thresh);
          dp = kp ? dp * a.inv_keep : 0.f;
          pd = kp ? p * a.inv_keep : 0.f;
        }
        dsv[e] = p * (dp - s_st[3 * il + 2]);
        pv[e] = pd;
      }
      pa[n / 2][2 * (n % 2)] = pack(pv[0], pv[1]);
      pa[n / 2][2 * (n % 2) + 1] = pack(pv[2], pv[3]);
      dsa[n / 2][2 * (n % 2)] = pack(dsv[0], dsv[1]);
      dsa[n / 2][2 * (n % 2) + 1] = pack(dsv[2], dsv[3]);
    }
    // dv += p_drop^T . dO, dk += ds^T . qu (dO, qu read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b_t(b0, b1, s_do, KS, n * 8, kk * 16, g, t);
        mma(dv[n], pa[kk], b0, b1);
        load_b_t(b0, b1, s_qu, KS, n * 8, kk * 16, g, t);
        mma(dk[n], dsa[kk], b0, b1);
      }
  }
  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= L) continue;
    const size_t off = (row0 + kj[r]) * D + col_h + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk_out + off + n * 8) =
          pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + off + n * 8) =
          pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dwh[h] = sum over (batch row, query tile) of the partials, in fixed order.
__global__ void reduce_dwh(const float* __restrict__ part, bf16* __restrict__ dwh,
                           int B, int H, int nq, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y;
  if (idx >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int qt = 0; qt < nq; ++qt)
      acc += part[(((size_t)b * H + h) * nq + qt) * n + idx];
  dwh[(size_t)h * n + idx] = __float2bfloat16_rn(acc);
}

struct Scratch {
  bf16* ab;
  float* delta;
  float* part;
};

inline size_t scratch_layout(int B, int L, int H, char* base, Scratch* s) {
  const size_t D = (size_t)H * DH, nq = (L + TQ - 1) / TQ;
  const size_t n_ab = align256(sizeof(bf16) * B * H * L * D);
  const size_t n_delta = align256(sizeof(float) * B * H * L);
  const size_t n_part = align256(sizeof(float) * B * H * nq * DH * D);
  if (s != nullptr) {
    s->ab = reinterpret_cast<bf16*>(base);
    s->delta = reinterpret_cast<float*>(base + n_ab);
    s->part = reinterpret_cast<float*>(base + n_ab + n_delta);
  }
  return n_ab + n_delta + n_part;
}

template <bool DROP>
int launch(const BwdArgs& a, void* scratch, cudaStream_t stream) {
  Scratch s;
  scratch_layout(a.B, a.L, a.H, static_cast<char*>(scratch), &s);
  const int nq = (a.L + TQ - 1) / TQ, nk = (a.L + TK - 1) / TK;
  const size_t smem_q = q_pass_smem(a.L, a.H), smem_k = k_pass_smem(a.H);
  cudaError_t err = cudaFuncSetAttribute(
      q_pass<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      k_pass<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return err;
  q_pass<DROP><<<dim3(nq, a.H, a.B), THREADS, smem_q, stream>>>(a, s.ab, s.delta,
                                                                s.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_pass<DROP><<<dim3(nk, a.H, a.B), THREADS, smem_k, stream>>>(a, s.ab, s.delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = DH * a.H * DH;
  reduce_dwh<<<dim3((n + 255) / 256, a.H), 256, 0, stream>>>(
      s.part, static_cast<bf16*>(a.dwh), a.B, a.H, nq, n);
  return cudaGetLastError();
}

}  // namespace tensor_core

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, ds and p_drop materialised.
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int SP = 65;        // padded stride of 64-wide staging tiles

// alpha | beta of one 64-row query tile to `ab`.
__global__ void __launch_bounds__(THREADS)
prep(BwdArgs a, float* __restrict__ ab) {
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2;
  extern __shared__ float smem_p[];
  float* s_qv = smem_p;          // 64 x SP each
  float* s_w0 = s_qv + 64 * SP;
  float* s_w1 = s_w0 + 64 * SP;
  const float* qv = static_cast<const float*>(a.qv);
  const float* wh = static_cast<const float*>(a.wh);
  const float* sin_t = static_cast<const float*>(a.sin_t);
  const float* cos_t = static_cast<const float*>(a.cos_t);
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * L, bh = (size_t)b * H + h;
  const int col_h = h * DH;

  for (int i = tid; i < TQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    s_qv[r * SP + d] = q < L ? qv[(row0 + q) * D + col_h + d] : 0.f;
  }
  const float* whh = wh + (size_t)h * DH * D;
  float* abh = ab + bh * L * D;
  for (int c0 = 0; c0 < D2; c0 += 64) {
    __syncthreads();
    for (int i = tid; i < DH * 64; i += THREADS) {
      const int d = i / 64, x = i % 64;
      s_w0[d * SP + x] = whh[(size_t)d * D + c0 + x];
      s_w1[d * SP + x] = whh[(size_t)d * D + D2 + c0 + x];
    }
    __syncthreads();
    float as[4][4], ac[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) as[r][c] = ac[r][c] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qa[4], ws[4], wc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = s_qv[(ty + 16 * r) * SP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ws[c] = s_w0[d * SP + tx + 16 * c];
        wc[c] = s_w1[d * SP + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          as[r][c] = fmaf(qa[r], ws[c], as[r][c]);
          ac[r][c] = fmaf(qa[r], wc[c], ac[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + ty + 16 * r;
      if (q >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c0 + tx + 16 * c;
        const float sq = sin_t[(size_t)q * D2 + x], cq = cos_t[(size_t)q * D2 + x];
        abh[(size_t)q * D + x] = as[r][c] * sq + ac[r][c] * cq;
        abh[(size_t)q * D + D2 + x] = -as[r][c] * cq + ac[r][c] * sq;
      }
    }
  }
}

// acc[r][c] += sum_d s_q[d][ty + 16r] * s_k[d][tx + 16c] over a 64-deep chunk.
__device__ __forceinline__ void chunk_fma(float (&acc)[4][4], const float* s_q,
                                          const float* s_k, int ty, int tx) {
  for (int d = 0; d < 64; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) qa[r] = s_q[d * SP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = s_k[d * SP + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qa[r], kb[c], acc[r][c]);
  }
}

// One 64 x 64 (query, key) tile: scores -> p (to p_out) and dp (to dp_out).
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
scores(BwdArgs a, const float* __restrict__ ab, float* __restrict__ dp_out,
       float* __restrict__ p_out) {
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2;
  __shared__ float s_q[64 * SP], s_k[64 * SP];
  const float* qu = static_cast<const float*>(a.qu);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* sin_t = static_cast<const float*>(a.sin_t);
  const float* cos_t = static_cast<const float*>(a.cos_t);
  const float* dout = static_cast<const float*>(a.dout);
  const int k0 = blockIdx.x * TK, q0 = blockIdx.y * TQ;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * L, bh = (size_t)b * H + h;
  const int col_h = h * DH, cos_chunks = D2 / 64;
  const float* abh = ab + bh * L * D;

  float s[4][4], dov[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dov[r][c] = 0.f;
  // chunks 0..D/64 build the scores; the last one is dO . v^T
  for (int ch = 0; ch <= 1 + D / 64; ++ch) {
    __syncthreads();
    for (int i = tid; i < 64 * 64; i += THREADS) {
      const int j = i / 64, d = i % 64, q = q0 + j, key = k0 + j;
      float xq = 0.f, xk = 0.f;
      if (q < L) {
        if (ch == 0) xq = qu[(row0 + q) * D + col_h + d];
        else if (ch <= D / 64) xq = abh[(size_t)q * D + (ch - 1) * 64 + d];
        else xq = dout[(row0 + q) * D + col_h + d];
      }
      if (key < L) {
        if (ch == 0) xk = k[(row0 + key) * D + col_h + d];
        else if (ch <= cos_chunks) xk = cos_t[(size_t)key * D2 + (ch - 1) * 64 + d];
        else if (ch <= D / 64) xk = sin_t[(size_t)key * D2 + (ch - 1 - cos_chunks) * 64 + d];
        else xk = v[(row0 + key) * D + col_h + d];
      }
      s_q[d * SP + j] = xq;
      s_k[d * SP + j] = xk;
    }
    __syncthreads();
    if (ch <= D / 64)
      chunk_fma(s, s_q, s_k, ty, tx);
    else
      chunk_fma(dov, s_q, s_k, ty, tx);
  }
  const int len = min(a.lengths[b], L);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty + 16 * r;
    if (q >= L) continue;
    const float m = a.stats[(bh * L + q) * 2];
    const float l = fmaxf(a.stats[(bh * L + q) * 2 + 1], 1e-9f);
    const uint32_t rh = DROP ? row_hash(a.seed, b, h, q, a.tq) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tx + 16 * c;
      if (key >= L) continue;
      float dp = dov[r][c];
      if (DROP) dp = keep(rh, key, a.thresh) ? dp * a.inv_keep : 0.f;
      const size_t off = (bh * L + q) * L + key;
      dp_out[off] = dp;
      p_out[off] = expf(mask_score(s[r][c], key, len, L) - m) / l;
    }
  }
}

// One warp per row (b, h, q) of the (B, H, L, L) scratch: delta = sum_j p .
// dp in a fixed order, then in place ds = p . (dp - delta) over dp and
// p_drop over p.
template <bool DROP>
__global__ void rows(BwdArgs a, float* __restrict__ ds, float* __restrict__ pd) {
  const int L = a.L, H = a.H, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= (size_t)a.B * H * L) return;  // whole warps only
  const int q = row % L, h = (row / L) % H, b = row / ((size_t)L * H);
  float* dsr = ds + row * L;
  float* pdr = pd + row * L;
  float delta = 0.f;
  for (int j = lane; j < L; j += 32) delta += pdr[j] * dsr[j];
  for (int o = 16; o > 0; o >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, o);
  const uint32_t rh = DROP ? row_hash(a.seed, b, h, q, a.tq) : 0u;
  for (int j = lane; j < L; j += 32) {
    const float p = pdr[j];
    dsr[j] = p * (dsr[j] - delta);
    if (DROP) pdr[j] = keep(rh, j, a.thresh) ? p * a.inv_keep : 0.f;
  }
}

// C[z] (M x N) = A[z] (M x K) . B[z] (K x N), any strides; batch z has the
// offset (z / zdiv) * s0 + (z % zdiv) * s1 in each operand.
struct Gemm {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, zdiv;
  long long a_m, a_k, a_z0, a_z1, b_k, b_n, b_z0, b_z1, c_m, c_n, c_z0, c_z1;
};

__global__ void __launch_bounds__(THREADS) gemm(Gemm g) {
  __shared__ float As[16][65], Bs[16][65];
  const int z = blockIdx.z, zb = z / g.zdiv, zh = z % g.zdiv;
  const float* A = g.A + zb * g.a_z0 + zh * g.a_z1;
  const float* B = g.B + zb * g.b_z0 + zh * g.b_z1;
  float* C = g.C + zb * g.c_z0 + zh * g.c_z1;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += 16) {
    for (int i = tid; i < 16 * 64; i += THREADS) {
      const int kk = i / 64, mm = i % 64, kg = k0 + kk;
      As[kk][mm] = (m0 + mm < g.M && kg < g.K)
                       ? A[(m0 + mm) * g.a_m + kg * g.a_k] : 0.f;
      Bs[kk][mm] = (n0 + mm < g.N && kg < g.K)
                       ? B[kg * g.b_k + (n0 + mm) * g.b_n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= g.M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < g.N) C[m * g.c_m + n * g.c_n] = acc[r][c];
    }
  }
}

int run_gemm(const Gemm& g, int Z, cudaStream_t stream) {
  gemm<<<dim3((g.N + 63) / 64, (g.M + 63) / 64, Z), THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

// da (H, B, L, D) = [dalpha . sin_q - dbeta . cos_q | dalpha . cos_q + dbeta . sin_q]
__global__ void combine(const float* __restrict__ dab, const float* __restrict__ sin_t,
                        const float* __restrict__ cos_t, float* __restrict__ da,
                        int B, int H, int L, int D2) {
  const size_t n = (size_t)B * H * L * D2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = idx % D2;
  const size_t row = idx / D2;  // (b * H + h) * L + i
  const int i = row % L, h = (row / L) % H, b = row / ((size_t)L * H);
  const float dal = dab[row * 2 * D2 + c], dbe = dab[row * 2 * D2 + D2 + c];
  const float sq = sin_t[(size_t)i * D2 + c], cq = cos_t[(size_t)i * D2 + c];
  float* dst = da + (((size_t)h * B + b) * L + i) * 2 * D2;
  dst[c] = dal * sq - dbe * cq;
  dst[D2 + c] = dal * cq + dbe * sq;
}

struct Scratch {
  float *ab, *ds, *pd, *dab, *da;
};

inline size_t scratch_layout(int B, int L, int H, char* base, Scratch* s) {
  const size_t D = (size_t)H * DH, rows = (size_t)B * H * L;
  const size_t sizes[5] = {align256(4 * rows * D), align256(4 * rows * L),
                           align256(4 * rows * L), align256(4 * rows * D),
                           align256(4 * rows * D)};
  size_t off = 0;
  for (int i = 0; i < 5; ++i) {
    if (s != nullptr) {
      float** ptrs[5] = {&s->ab, &s->ds, &s->pd, &s->dab, &s->da};
      *ptrs[i] = reinterpret_cast<float*>(base + off);
    }
    off += sizes[i];
  }
  return off;
}

template <bool DROP>
int launch(const BwdArgs& a, void* scratch, cudaStream_t stream) {
  Scratch s;
  scratch_layout(a.B, a.L, a.H, static_cast<char*>(scratch), &s);
  const int B = a.B, L = a.L, H = a.H, D = H * DH, D2 = D / 2;
  const int nq = (L + TQ - 1) / TQ, nk = (L + TK - 1) / TK;
  const long long LD = (long long)L * D, LL = (long long)L * L;
  const int smem_prep = (int)(sizeof(float) * 3 * 64 * SP);
  int err = cudaFuncSetAttribute(
      prep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_prep);
  if (err) return err;
  prep<<<dim3(nq, H, B), THREADS, smem_prep, stream>>>(a, s.ab);
  if ((err = cudaGetLastError())) return err;
  scores<DROP><<<dim3(nk, nq, B * H), THREADS, 0, stream>>>(a, s.ab, s.ds, s.pd);
  if ((err = cudaGetLastError())) return err;
  const size_t n_rows = (size_t)B * H * L;
  rows<DROP><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(a, s.ds, s.pd);
  if ((err = cudaGetLastError())) return err;
  const float* qu = static_cast<const float*>(a.qu);
  const float* qv = static_cast<const float*>(a.qv);
  const float* k = static_cast<const float*>(a.k);
  const float* dout = static_cast<const float*>(a.dout);
  const float* wh = static_cast<const float*>(a.wh);
  const float* sin_t = static_cast<const float*>(a.sin_t);
  const float* cos_t = static_cast<const float*>(a.cos_t);
  // batch z = b * H + h over (B, H, L, L) scratch and packed (B, L, D) operands
  const long long HLL = H * LL;
  // dqu = ds . k
  if ((err = run_gemm({s.ds, k, static_cast<float*>(a.dqu), L, DH, L, H,
                       L, 1, HLL, LL, D, 1, LD, DH, D, 1, LD, DH}, B * H, stream)))
    return err;
  // dk = ds^T . qu
  if ((err = run_gemm({s.ds, qu, static_cast<float*>(a.dk), L, DH, L, H,
                       1, L, HLL, LL, D, 1, LD, DH, D, 1, LD, DH}, B * H, stream)))
    return err;
  // dv = p_drop^T . dO
  if ((err = run_gemm({s.pd, dout, static_cast<float*>(a.dv), L, DH, L, H,
                       1, L, HLL, LL, D, 1, LD, DH, D, 1, LD, DH}, B * H, stream)))
    return err;
  // [dalpha | dbeta] (B, H, L, D) = ds . cos | ds . sin
  if ((err = run_gemm({s.ds, cos_t, s.dab, L, D2, L, H,
                       L, 1, HLL, LL, D2, 1, 0, 0, D, 1, H * LD, LD}, B * H, stream)))
    return err;
  if ((err = run_gemm({s.ds, sin_t, s.dab + D2, L, D2, L, H,
                       L, 1, HLL, LL, D2, 1, 0, 0, D, 1, H * LD, LD}, B * H, stream)))
    return err;
  const size_t n = (size_t)B * H * L * D2;
  combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(s.dab, sin_t, cos_t,
                                                           s.da, B, H, L, D2);
  if ((err = cudaGetLastError())) return err;
  // dqv = da . wh^T  (da is (H, B, L, D))
  if ((err = run_gemm({s.da, wh, static_cast<float*>(a.dqv), L, DH, D, H,
                       D, 1, LD, B * LD, 1, D, 0, (long long)DH * D,
                       D, 1, LD, DH}, B * H, stream)))
    return err;
  // dwh[h] = qv^T . da[h], the sum over (batch row, query row) as one depth
  return run_gemm({qv, s.da, static_cast<float*>(a.dwh), DH, D, B * L, 1,
                   1, D, DH, 0, D, 1, B * LD, 0, D, 1, (long long)DH * D, 0},
                  H, stream);
}

}  // namespace cuda_core

}  // namespace

extern "C" const char* sincos_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The longest L sincos_attention_bwd takes at H heads on the current device:
// bfloat16's query pass keeps ds for every key in shared memory. -1 when
// the device cannot be queried.
extern "C" int sincos_attention_bwd_max_len(int H, int dtype) {
  if (dtype == 0) return INT_MAX;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  if (tensor_core::k_pass_smem(H) > (size_t)optin) return 0;
  int L = 0;
  while (tensor_core::q_pass_smem(L + TK, H) <= (size_t)optin) L += TK;
  return L;
}

// Bytes of device scratch sincos_attention_bwd needs for these shapes.
extern "C" long long sincos_attention_bwd_scratch_bytes(int B, int L, int H,
                                                        int dtype) {
  if (dtype == 0) return (long long)cuda_core::scratch_layout(B, L, H, nullptr, nullptr);
  return (long long)tensor_core::scratch_layout(B, L, H, nullptr, nullptr);
}

// qu, qv, k, v, dout, dqu, dqv, dk, dv: (B, L, H*64); wh, dwh:
// (H, 64, H*64); sin_t, cos_t: (L, H*32); all of one dtype (0 = float32,
// 1 = bfloat16), contiguous, 16-byte aligned, on the current device.
// lengths: (B,) int32; stats: (B, H, L, 2) float32 from the forward;
// scratch: sincos_attention_bwd_scratch_bytes bytes. Dropout as in the
// forward (thresh 0: none). L at most sincos_attention_bwd_max_len(H,
// dtype). Returns a cudaError_t.
extern "C" int sincos_attention_bwd(
    const void* qu, const void* qv, const void* k, const void* v,
    const void* wh, const void* sin_t, const void* cos_t, const void* lengths,
    const void* stats, const void* dout, void* dqu,
    void* dqv, void* dk, void* dv, void* dwh, void* scratch, int B, int L,
    int H, int dtype, uint32_t seed, uint32_t thresh, float inv_keep, int tq,
    void* stream) {
  const BwdArgs a{qu, qv, k, v, wh, sin_t, cos_t,
                  static_cast<const int*>(lengths),
                  static_cast<const float*>(stats), dout, dqu, dqv, dk, dv,
                  dwh, B, L, H, seed, thresh, inv_keep, tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  if (dtype == 0)
    return drop ? cuda_core::launch<true>(a, scratch, s)
                : cuda_core::launch<false>(a, scratch, s);
  if (dtype == 1)
    return drop ? tensor_core::launch<true>(a, scratch, s)
                : tensor_core::launch<false>(a, scratch, s);
  return cudaErrorInvalidValue;
}
