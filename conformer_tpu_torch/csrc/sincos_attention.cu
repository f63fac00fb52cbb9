// Fused shift-free relative-position attention, forward, for Hopper (sm_90a).
//
// Replaces: conformer_tpu/ops/pallas/sincos_attention.py::_fwd_kernel (with
// _scores and, at a dropout rate above 0, _dropout_keep: K1-drop), reached
// through _fwd_call and rel_attention_sincos_packed. Same function, packed
// (B, L, D) layout with head h in columns [h*64, (h+1)*64):
//   a      = qv_h . wh[h]                        (TQ, D), fp32 sums
//   alpha  = T(a_s * sin_q + a_c * cos_q)        (TQ, D/2), rounded to T
//   beta   = T(-a_s * cos_q + a_c * sin_q)
//   s[i,j] = qu_i . k_j + alpha_i . cos_j + beta_i . sin_j   (fp32)
//   s      = s where j < min(len_b, L) else float32.min      (a select)
//   e      = exp(s - rowmax), l = sum e
//   e'     = keep(i, j) ? e / (1 - rate) : 0        (dropout; e' = e at rate 0)
//   out    = (T(e') . v) / max(l, 1e-9)
// The caller has folded the 1/sqrt(dh) scale into qu and qv. When the
// caller asks for them (training), each row's max and sum l go to `stats`
// for the backward (sincos_attention_bwd.cu). The keep mask is the JAX
// kernel's hash (sincos_attention_common.cuh), computed per element from the
// fragment's (row, column) and never stored; at rate 0 the kernel is
// instantiated without it.
//
// What bounds it on the H100: operations. Per (batch, head) the score
// product has depth 64 + D (576 at D = 512) over L x L pairs, and the value
// product depth L; 2*B*H*L^2*(64 + D + 64) FLOPs against ~5*B*L*D inputs and
// outputs: ~1000 FLOP/byte at L = 599, far above the bf16 machine balance
// (~295 FLOP/byte). So the products belong on the tensor cores.
//
// Design. The TPU kernel ran all heads and several batch rows per program
// to amortise grid-step dispatch; on the GPU the CTAs run in parallel, so
// the grid is one CTA per (64-row query tile, head, batch row): B*H*L/64
// CTAs, 640 at B = 8, L = 599. Each CTA builds its augmented query tile
// [qu | alpha | beta] (64 x 576) once in shared memory, then walks the keys
// 64 at a time with an online softmax. A key tile's scores are the single
// product of that tile with [k_j | cos_j | sin_j], streamed through shared
// memory in 64-deep chunks; the cos/sin rows are the same for every batch
// row and head, so they stay in L2. No L x L score or probability tensor
// ever reaches device memory.
//
// Two kernels share that design:
// - bfloat16 (serving and training): four warps, 16 query rows each, run every
//   product (a = qv . wh, the scores, e . v) as mma.sync m16n8k16 with fp32
//   accumulators; the probabilities go from the score accumulators straight
//   into the A operand of the value product, in registers.
// - float32: CUDA-core FMAs (16 x 16 threads, 4 x 4 outputs each), so fp32
//   inputs keep fp32 products (TF32 would not hold the fp32 tolerance).
//
// Masking follows the JAX kernel exactly: masked keys take the finite
// float32.min through a select, so a row of length 0 has every score equal
// and gets uniform weights over all L keys. Keys past L (the ragged last
// tile) are -inf and carry no weight. The ragged last query tile is
// bounds-checked on load and store.

#include "sincos_attention_common.cuh"

namespace {

using namespace attn;
constexpr int TQ = 64;        // query rows per CTA
constexpr int TK = 64;        // keys per tile

struct FwdArgs {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t;
  const int* lengths;
  void* out;
  float* stats;  // (B, H, L, 2) [row max, row sum], or null
  int B, L, H;
  uint32_t seed, thresh;  // dropout: keep where hash >= thresh
  float inv_keep;         // 1 / (1 - rate)
  int tq;                 // the JAX kernel's q-tile rows, for the hash
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync).
// ---------------------------------------------------------------------------

namespace tensor_core {

constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int KS = 72;        // padded row stride (bf16) of 64-wide tiles

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
           const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ wh, const bf16* __restrict__ sin_t,
           const bf16* __restrict__ cos_t, const int* __restrict__ lengths,
           bf16* __restrict__ out, float* __restrict__ stats, int L, int H,
           uint32_t seed, uint32_t thresh, float inv_keep, int tq) {
  const int D = H * DH, D2 = D / 2, QS = DH + D + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);  // TQ x QS: [qu|alpha|beta]
  bf16* s_a = s_q + TQ * QS;  // 64 x KS: qv | wh sin half^T | key chunk
  bf16* s_b = s_a + 64 * KS;  // 64 x KS: wh cos half^T | v^T

  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (tid / 32) * 16;  // this warp's first row in the tile
  const size_t row0 = (size_t)b * L;
  const int col_h = h * DH;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // 1. qu into s_q[:, 0:64], qv into s_a; zeros past L.
  for (int i = tid; i < TQ * DH / 8; i += THREADS) {
    const int r = i / 8, c = (i % 8) * 8, q = q0 + r;
    uint4 xu = zero, xv = zero;
    if (q < L) {
      const size_t off = (row0 + q) * D + col_h + c;
      xu = *reinterpret_cast<const uint4*>(qu + off);
      xv = *reinterpret_cast<const uint4*>(qv + off);
    }
    *reinterpret_cast<uint4*>(s_q + r * QS + c) = xu;
    *reinterpret_cast<uint4*>(s_a + r * KS + c) = xv;
  }
  __syncthreads();
  uint32_t qa[4][4];  // qv A fragments of this warp's rows, depth 0..63
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], s_a, KS, wr, kk * 16, g, t);

  // 2. alpha and beta, 64 coefficient columns of each half at a time.
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

  // 3. Key tiles with an online softmax. Rows g and g + 8 of the warp's 16
  // are this thread's; m, l are per row, l summed over the quad at the end.
  const int len = min(lengths[b], L);
  const int n_chunks = 1 + D / 64;  // [k | cos (D2/64) | sin (D2/64)]
  const int cos_chunks = D2 / 64;
  float o[8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t rh[2] = {0u, 0u};  // dropout hash of this thread's two rows
  if (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) rh[r] = row_hash(seed, b, h, q0 + wr + g + 8 * r, tq);
  }

  for (int j0 = 0; j0 < L; j0 += TK) {
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

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
        if (ch == 0) store_column(s_b, KS, c, j, xv);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        load_a(a, s_q, QS, wr, ch * 64 + kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, s_a, KS, n * 8, kk * 16, g, t);
          mma(s[n], a, b0, b1);
        }
      }
    }

    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = mask_score(s[n][e], j0 + n * 8 + 2 * t + (e % 2), len, L);
        tmax[e / 2] = fmaxf(tmax[e / 2], s[n][e]);
      }
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      m_new[r] = fmaxf(m_run[r], tmax[r]);
      const float corr = expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_run[r] *= corr;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
    // e = exp(s - m): fp32 into the row sums, then dropped and rescaled,
    // rounded to bf16 as the A fragments of the value product (n-tiles 2kk,
    // 2kk+1 = keys 16kk..).
    uint32_t p[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = expf(s[n][i] - m_new[i / 2]);
      l_run[0] += e[0] + e[1];
      l_run[1] += e[2] + e[3];
      if (DROP) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = keep(rh[i / 2], j0 + n * 8 + 2 * t + (i % 2), thresh)
                     ? e[i] * inv_keep : 0.f;
      }
      p[n / 2][2 * (n % 2)] = pack(e[0], e[1]);
      p[n / 2][2 * (n % 2) + 1] = pack(e[2], e[3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_b, KS, n * 8, kk * 16, g, t);
        mma(o[n], p[kk], b0, b1);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int q = q0 + wr + g + 8 * r;
    if (q >= L) continue;
    if (stats != nullptr && t == 0) {
      float* st = stats + (((size_t)b * H + h) * L + q) * 2;
      st[0] = m_run[r];
      st[1] = l;
    }
    const float inv = 1.f / fmaxf(l, 1e-9f);
    bf16* dst = out + (row0 + q) * D + col_h + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <bool DROP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const int D = a.H * DH;
  const size_t smem = sizeof(bf16) * ((size_t)TQ * (DH + D + 8) + 2 * 64 * KS);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + TQ - 1) / TQ, a.H, a.B);
  fwd_kernel<DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qv),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.wh), static_cast<const bf16*>(a.sin_t),
      static_cast<const bf16*>(a.cos_t), a.lengths, static_cast<bf16*>(a.out),
      a.stats, a.L, a.H, a.seed, a.thresh, a.inv_keep, a.tq);
  return cudaGetLastError();
}

}  // namespace tensor_core

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs.
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int SP = 65;        // padded stride of the 64-wide staging tiles

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
           const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ wh, const float* __restrict__ sin_t,
           const float* __restrict__ cos_t, const int* __restrict__ lengths,
           float* __restrict__ out, float* __restrict__ stats, int L, int H,
           uint32_t seed, uint32_t thresh, float inv_keep, int tq) {
  const int D = H * DH, D2 = D / 2, QS = DH + D + 1;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);  // TQ x QS: [qu|alpha|beta]
  float* s_t0 = s_q + TQ * QS;   // key chunk (transposed) | wh sin half
  float* s_t1 = s_t0 + 64 * SP;  // value tile              | wh cos half
  float* s_t2 = s_t1 + 64 * SP;  // probability tile        | qv tile

  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * L;
  const int col_h = h * DH;

  // 1. qu into s_q[:, 0:64], qv into s_t2.
  for (int i = tid; i < TQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    float xu = 0.f, xv = 0.f;
    if (q < L) {
      const size_t off = (row0 + q) * D + col_h + d;
      xu = qu[off];
      xv = qv[off];
    }
    s_q[r * QS + d] = xu;
    s_t2[r * SP + d] = xv;
  }

  // 2. alpha and beta, 64 coefficient columns at a time.
  const float* whh = wh + (size_t)h * DH * D;
  for (int c0 = 0; c0 < D2; c0 += 64) {
    __syncthreads();
    for (int i = tid; i < DH * 64; i += THREADS) {
      const int d = i / 64, x = i % 64;
      s_t0[d * SP + x] = whh[(size_t)d * D + c0 + x];
      s_t1[d * SP + x] = whh[(size_t)d * D + D2 + c0 + x];
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
      for (int r = 0; r < 4; ++r) qa[r] = s_t2[(ty + 16 * r) * SP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ws[c] = s_t0[d * SP + tx + 16 * c];
        wc[c] = s_t1[d * SP + tx + 16 * c];
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
      const int row = ty + 16 * r, q = q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c0 + tx + 16 * c;
        float sq = 0.f, cq = 0.f;
        if (q < L) {
          sq = sin_t[(size_t)q * D2 + x];
          cq = cos_t[(size_t)q * D2 + x];
        }
        s_q[row * QS + DH + x] = as[r][c] * sq + ac[r][c] * cq;
        s_q[row * QS + DH + D2 + x] = -as[r][c] * cq + ac[r][c] * sq;
      }
    }
  }

  // 3. Key tiles with an online softmax.
  const int len = min(lengths[b], L);
  const int n_chunks = 1 + D / 64;   // [k | cos (D2/64) | sin (D2/64)]
  const int cos_chunks = D2 / 64;
  float m_run[4], l_run[4], acc[4][4];
  uint32_t rh[4];  // dropout hash of this thread's four rows
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    rh[r] = DROP ? row_hash(seed, b, h, q0 + ty + 16 * r, tq) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < L; j0 += TK) {
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      __syncthreads();
      for (int i = tid; i < TK * 64; i += THREADS) {
        const int j = i / 64, d = i % 64, key = j0 + j;
        float x = 0.f, xv = 0.f;
        if (key < L) {
          if (ch == 0) {
            const size_t off = (row0 + key) * D + col_h + d;
            x = k[off];
            xv = v[off];
          } else if (ch <= cos_chunks) {
            x = cos_t[(size_t)key * D2 + (ch - 1) * 64 + d];
          } else {
            x = sin_t[(size_t)key * D2 + (ch - 1 - cos_chunks) * 64 + d];
          }
        }
        s_t0[d * SP + j] = x;
        if (ch == 0) s_t1[j * SP + d] = xv;
      }
      __syncthreads();
      const float* qa_base = s_q + ch * 64;
      for (int d = 0; d < 64; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qa_base[(ty + 16 * r) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kb[c] = s_t0[d * SP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = mask_score(s[r][c], j0 + tx + 16 * c, len, L);
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], max16(tmax));
      const float corr = expf(m_run[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float e = expf(s[r][c] - m_new);
        psum += e;
        if (DROP)
          e = keep(rh[r], j0 + tx + 16 * c, thresh) ? e * inv_keep : 0.f;
        s_t2[(ty + 16 * r) * SP + tx + 16 * c] = e;
        acc[r][c] *= corr;
      }
      l_run[r] = l_run[r] * corr + sum16(psum);
      m_run[r] = m_new;
    }
    __syncthreads();
    for (int j = 0; j < TK; ++j) {
      float p[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = s_t2[(ty + 16 * r) * SP + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = s_t1[j * SP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty + 16 * r;
    if (q >= L) continue;
    if (stats != nullptr && tx == 0) {
      float* st = stats + (((size_t)b * H + h) * L + q) * 2;
      st[0] = m_run[r];
      st[1] = l_run[r];
    }
    const float inv = 1.f / fmaxf(l_run[r], 1e-9f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(row0 + q) * D + col_h + tx + 16 * c] = acc[r][c] * inv;
  }
}

template <bool DROP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const int D = a.H * DH;
  const size_t smem = sizeof(float) * ((size_t)TQ * (DH + D + 1) + 3 * 64 * SP);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + TQ - 1) / TQ, a.H, a.B);
  fwd_kernel<DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.qu), static_cast<const float*>(a.qv),
      static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.wh), static_cast<const float*>(a.sin_t),
      static_cast<const float*>(a.cos_t), a.lengths,
      static_cast<float*>(a.out), a.stats, a.L, a.H, a.seed, a.thresh,
      a.inv_keep, a.tq);
  return cudaGetLastError();
}

}  // namespace cuda_core

}  // namespace

extern "C" const char* sincos_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qu, qv, k, v, out: (B, L, H*64); wh: (H, 64, H*64); sin_t, cos_t:
// (L, H*32); all of one dtype (0 = float32, 1 = bfloat16), contiguous and
// 16-byte aligned, on the current device. lengths: (B,) int32. stats: null,
// or (B, H, L, 2) float32 for each row's max and sum. Dropout keeps an
// element where its hash is >= thresh (0: no dropout, and no hash work),
// scaled by inv_keep; seed and tq as the JAX kernel hashes them. H*32 must
// be a multiple of 64. Returns a cudaError_t.
extern "C" int sincos_attention_fwd(const void* qu, const void* qv,
                                    const void* k, const void* v,
                                    const void* wh, const void* sin_t,
                                    const void* cos_t, const void* lengths,
                                    void* out, void* stats, int B, int L, int H,
                                    int dtype, uint32_t seed, uint32_t thresh,
                                    float inv_keep, int tq, void* stream) {
  const FwdArgs a{qu, qv, k, v, wh, sin_t, cos_t,
                  static_cast<const int*>(lengths), out,
                  static_cast<float*>(stats), B, L, H, seed, thresh, inv_keep,
                  tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  if (dtype == 0)
    return drop ? cuda_core::launch<true>(a, s) : cuda_core::launch<false>(a, s);
  if (dtype == 1)
    return drop ? tensor_core::launch<true>(a, s)
                : tensor_core::launch<false>(a, s);
  return cudaErrorInvalidValue;
}
