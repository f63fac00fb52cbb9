// Fused shift-free relative-position attention, forward, for Hopper (sm_90a).
//
// Replaces: conformer_tpu/ops/pallas/sincos_attention.py::_fwd_kernel (with
// _scores and, at a dropout rate above 0, _dropout_keep: K1-drop), reached
// through _fwd_call and rel_attention_sincos_packed. Same function, packed
// (B, L, D) layout with head h in columns [h*dh, (h+1)*dh), D = H * dh, and
// a position side Dp wide (wh (H, dh, Dp), sin/cos (L, Dp/2)): Dp = D on
// one device, the whole model's width on a rank that a mesh gives H/tp
// heads (the JAX shard_map body's shapes):
//   a      = qv_h . wh[h]                        (TQ, Dp), fp32 sums
//   alpha  = T(a_s * sin_q + a_c * cos_q)        (TQ, Dp/2), rounded to T
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
// What it replaces on the card: the earlier bf16 kernel (one CTA per 64
// query rows, four warps on mma.sync, every 64 x 64 chunk loaded by the
// warps themselves between two __syncthreads, V transposed by scalar
// stores), 13x its bound at B 8, L 599.
//
// What bounds it on the H100. Operations: per (batch, head) the score
// product has depth 64 + D (576 at D = 512) over L x L pairs, and the value
// product depth L: 2*B*H*L^2*(64 + D + 64) + 2*B*H*L*64*D FLOPs, 31.9 GFLOP
// at B = 8, L = 599, H = 8, or 32 us at 989 TFLOP/s. Device memory is far
// below that (~5*B*L*D inputs and outputs, ~1000 FLOP/byte). Next come
// L2 and shared memory. 512 of the 576 score columns are the
// [cos_j | sin_j] rows, the same for every batch row and head, so every CTA
// streams them (and its k and v) from L2 once per key: 1.25 KB per key,
// 0.26 GB per call at L 599 with 128-row query tiles (0.51 GB with 64-row
// ones). And a wgmma with both operands in shared memory reads A and B for
// every product: at m64n64k16 that is 4 KB per 32 tensor-core cycles, the
// SM's whole 128 B per cycle, so two warpgroups could not both run at
// the tensor-core rate.
//
// Design (bfloat16, the serving and training path), one CTA per (128 query
// rows, head, batch row), 384 threads in three warpgroups:
// - 128 query rows per CTA, two consumer warpgroups of 64 rows each (one
//   wgmma M tile), so each key streamed from L2 serves 128 rows. The
//   augmented query tile [qu | alpha | beta] (128 x 576 bf16, 144 KB) stays
//   in shared memory for the whole key walk, in 64-column panels in
//   wgmma's 128-byte-swizzled K-major layout.
// - 128 keys per tile: the score product is m64n128k16, which reads 6 KB
//   per 64 cycles (96 B per cycle), and a query panel is read once per 128
//   keys instead of once per 64.
// - A TMA ring of STAGES stages of 128 rows x 64 bf16 (16 KB each, 80 KB),
//   fed by one producer thread through full/empty mbarrier pairs, so copies
//   overlap the products. The producer streams qv (stage 0, a 64-row box
//   per consumer), the per-head position weights wh[h] (a sin and a cos
//   64-column chunk per stage), then for every key tile k, the cos chunks,
//   the sin chunks and v. qu arrives by TMA straight into the query tile.
//   k, v, qu and qv have 3-D maps over (B, L, D), so TMA fills zeros past
//   each batch row's L instead of reading the next row; cos, sin (L, D/2)
//   and wh (H*64, D) have 2-D maps. Scores of keys >= L still go through
//   mask_score. The maps come from cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda. These TMA,
//   mbarrier, ring and wgmma helpers live in hopper.cuh, shared with K2.
// - wgmma for every product: a = qv . wh (SS, m64n64k16, wh MN-major), the
//   scores (SS, 36 steps per key tile from the query panels and the
//   streamed chunks), and e' . v (RS: the probabilities go from the score
//   accumulators into A fragments in registers; v is read MN-major, so no
//   transposing copy). Each chunk's wgmma group is committed as it is
//   issued and its ring stage released once the next group is in flight.
// - setmaxnreg moves registers from the producer warpgroup to the consumers.
// - The softmax runs on ex2.approx, log2 e folded in after the subtraction:
//   2^((s - m) * log2 e). A row of length 0 has m = float32.min and every
//   s - m = 0; keys past L give -inf and weight 0.
// tools/probe_attention_fwd.py times the kernel beside variants without the
// products, without the copies, and with 64-row query tiles. On the H100
// the products and the softmax bound it (without the copies it keeps ~95 %
// of its time, without the products ~70 %): the two warpgroups take the same
// stages and run in step, so the tensor cores idle through their softmax.
//
// Shared memory per CTA: (1 + D/64) * 16 KB of query tile + 80 KB of ring
// + 1 KB of alignment: 225 KB at D = 512, one CTA per SM. The wgmma kernel
// takes bf16 at dh 64 with D/2 a multiple of 64 and D <= 512 (H <= 8): a
// wider query tile does not fit beside the ring, and the launch returns
// cudaErrorInvalidValue.
//
// Every other shape and dtype (fp32 at any width; bf16 at any dh up to
// 128, odd H, D/2 not a multiple of 64, D > 512) takes the general kernel
// (namespace general; shared pieces in attention_general.cuh), one launch
// and no scratch. It replaces PR 6's CUDA-core kernel, which ran every
// product as FMAs bound by shared-memory load issue, wrote alpha | beta
// for all of (B, H, L, D) to fp32 scratch in a launch of its own and
// re-staged the query side from it for every 64-key tile with scalar loads.
// - Every product on the tensor cores through mma.sync: bf16 m16n8k16
//   (ldmatrix from padded tiles), fp32 3xTF32 on m16n8k8 from operands
//   split by truncation, each 64-deep tile summed from zero and added in
//   fp32 (the tensor cores truncate a running sum: summing the whole depth
//   in it gave 2.2e-5 against 3.3e-6).
// - One CTA per (64, 32 or 16 query rows, head, batch row): the most rows
//   whose tile fits in shared memory, fewer while the grid has fewer CTAs
//   than SMs. The query tile [qu | alpha | beta] is built in a prologue
//   (a = qv . wh[h] on the tensor cores, 32 coefficient columns a step,
//   the weights double-buffered, alpha | beta rounded to T) and kept for
//   the whole key walk; each segment of the score depth is padded to 16 on
//   its own (dh 36 -> 48, D/2 72 -> 80).
// - The key side [k | cos | sin] in 64-column chunks, then v, through a
//   3- or 4-stage cp.async ring (16-, 8- or 4-byte copies by the head's
//   alignment, 2-byte ones through registers where none divides), the
//   copies of the next stages in flight behind the products.
// - Two warps per 16 rows, each on one half (32 keys) of every key tile
//   with its own online softmax (masked keys float32.min, keys past L
//   -inf, a row of length 0 uniform), P . V from the score registers as A
//   fragments; the halves' max, sum and output are combined at the end.
//   The dropout keep bit is the hash of each fragment element's own
//   (query row, key).
// What bounds it on the H100 (80GB HBM3, 700 W;
// tools/probe_attention_general.py): in fp32 at production width (B 8,
// L 599, H 8, dh 64) the 64-row tile (147 KB) leaves one CTA per SM, and
// every CTA reads the whole key side from L2: 1.1 GB a call, which the
// variant without products takes 0.71 ms to stream (~1.5 TB/s), and the
// products with the split alone ~1.1 ms; the kernel overlaps them only in
// part. bf16 at ModelConfig.tiny's width is bound by the copies and the
// per-tile softmax of its small products. Measured there (device ms;
// PR 6's kernel, SDPA on the augmented operands): fp32 (8, 64), B 8,
// L 599, rate 0: 1.333 (2.955, 0.753); bf16 (2, 32), B 8, L 599, rate 0.1:
// 0.072 (0.283, 0.049); bf16 (12, 64), B 3, L 199, rate 0.1: 0.213 (0.688,
// 0.044). Faster than the plain version at each, slower than SDPA.

// Masking follows the JAX kernel exactly: masked keys take the finite
// float32.min through a select, so a row of length 0 has every score equal
// and gets uniform weights over all L keys. Keys past L (the ragged last
// tile) are -inf and carry no weight. The ragged last query tile is
// bounds-checked on store.

#include "attention_general.cuh"
#include "hopper.cuh"
#include "sincos_attention_common.cuh"

namespace {

using namespace attn;

struct FwdArgs {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t;
  const int* lengths;
  void* out;
  float* stats;  // (B, H, L, 2) [row max, row sum], or null
  int B, L, H, dh, Dp;    // Dp: the position width (wh's last axis)
  uint32_t seed, thresh;  // dropout: keep where hash >= thresh
  float inv_keep;         // 1 / (1 - rate)
  int tq;                 // the JAX kernel's q-tile rows, for the hash
};

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, wgmma, 128-row query tiles.
// ---------------------------------------------------------------------------

namespace hopper {

using namespace sm90;

constexpr int CONSUMERS = 2;          // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * CONSUMERS;    // query rows per CTA
constexpr int BN = 128;               // keys per tile
constexpr int BOX = 64 * 64 * 2;      // bytes of a 64-row box of 64 bf16 columns
constexpr int STAGE = BN * 64 * 2;    // bytes of one ring stage: 128 rows
constexpr int STAGES = 5;             // ring stages (80 KB)
constexpr int PANEL = BM * 128;       // bytes of one 64-column query panel
constexpr int THREADS = 128 * (CONSUMERS + 1);  // the last warpgroup produces

struct Maps {
  CUtensorMap qu, qv;         // (B, L, D), 64-row boxes
  CUtensorMap k, v;           // (B, L, D), BN-row boxes
  CUtensorMap wh;             // (H*64, Dp), 64-row boxes
  CUtensorMap cos_t, sin_t;   // (L, Dp/2), BN-row boxes
};

using Ring = RingOf<STAGES, STAGE>;

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ sin_t,
           const bf16* __restrict__ cos_t, const int* __restrict__ lengths,
           bf16* __restrict__ out, float* __restrict__ stats, int L, int H,
           int Dp, uint32_t seed, uint32_t thresh, float inv_keep, int tq) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int D = H * DH, D2 = Dp / 2, n_half = D2 / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  // The query tile: 1 + Dp/64 panels of BM rows x 64 columns, [qu | alpha |
  // beta]; then the ring. Both 1024-byte aligned for the 128-byte swizzle.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_tile = (raw + 1023u) & ~1023u;
  uint8_t* q_ptr = smem_raw + (q_tile - raw);
  const uint32_t ring = q_tile + (1 + Dp / 64) * PANEL;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES,
                 q_full = full + 16 * STAGES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, 4 * CONSUMERS);  // every consumer warp
    }
    bar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread issues every copy, in the order the consumers
    // take them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      const int col_h = h * DH;
      bar_expect(q_full, CONSUMERS * BOX);
      for (int i = 0; i < CONSUMERS; ++i)
        tma_3d(q_tile + i * BOX, &maps.qu, q_full, col_h, q0 + 64 * i, b);
      Ring r;
      // stage 0: qv, a 64-row box per consumer warpgroup
      uint2 st = claim(r, full, empty, ring, CONSUMERS * BOX);
      for (int i = 0; i < CONSUMERS; ++i)
        tma_3d(st.x + i * BOX, &maps.qv, st.y, col_h, q0 + 64 * i, b);
      r.next();
      // wh[h], 64 coefficient columns of the sin half and of the cos half
      for (int c = 0; c < n_half; ++c) {
        st = claim(r, full, empty, ring, 2 * BOX);
        tma_2d(st.x, &maps.wh, st.y, c * 64, col_h);
        tma_2d(st.x + BOX, &maps.wh, st.y, D2 + c * 64, col_h);
        r.next();
      }
      // per key tile: k, the cos chunks, the sin chunks, v
      for (int j0 = 0; j0 < L; j0 += BN) {
        st = claim(r, full, empty, ring, STAGE);
        tma_3d(st.x, &maps.k, st.y, col_h, j0, b);
        r.next();
        for (int c = 0; c < 2 * n_half; ++c) {
          st = claim(r, full, empty, ring, STAGE);
          tma_2d(st.x, c < n_half ? &maps.cos_t : &maps.sin_t, st.y,
                 (c % n_half) * 64, j0);
          r.next();
        }
        st = claim(r, full, empty, ring, STAGE);
        tma_3d(st.x, &maps.v, st.y, col_h, j0, b);
        r.next();
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * ((tid % 128) / 32) + g;  // rows r_lo, r_lo + 8
    const int qw = q0 + wg * 64;  // this warpgroup's first query row
    const int wrow = wg * 64;     // ... and its first row in the panels
    Ring r;
    int st;

    // 1. a = qv . wh[h] on wgmma, 64 coefficient columns of each half at a
    // time; alpha and beta rounded into the query panels 1.. and
    // 1 + Dp/128.. . The ring's stage 0 holds qv, until every chunk is done.
    const uint32_t qv_tile = take(r, full, ring, st) + wg * BOX;
    for (int c = 0; c < n_half; ++c) {
      const uint32_t wh_sin = take(r, full, ring, st), wh_cos = wh_sin + BOX;
      float as[32], ac[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) as[i] = ac[i] = 0.f;
      fence_acc(as);
      fence_acc(ac);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1>(as, desc_k(qv_tile + 32 * kk), desc_mn(wh_sin + 2048 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1>(ac, desc_k(qv_tile + 32 * kk), desc_mn(wh_cos + 2048 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(as);
      fence_acc(ac);
      release(empty, st);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r_lo + 8 * hf, q = qw + row;
          const int x = c * 64 + j * 8 + 2 * t;
          float2 sq = make_float2(0.f, 0.f), cq = sq;
          if (q < L) {
            sq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                sin_t + (size_t)q * D2 + x));
            cq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                cos_t + (size_t)q * D2 + x));
          }
          const float s0 = as[4 * j + 2 * hf], s1 = as[4 * j + 2 * hf + 1];
          const float c0 = ac[4 * j + 2 * hf], c1 = ac[4 * j + 2 * hf + 1];
          const int off = (wrow + row) * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(q_ptr + (1 + c) * PANEL + off) =
              pack(s0 * sq.x + c0 * cq.x, s1 * sq.y + c1 * cq.y);
          *reinterpret_cast<uint32_t*>(q_ptr + (1 + n_half + c) * PANEL + off) =
              pack(-s0 * cq.x + c0 * sq.x, -s1 * cq.y + c1 * sq.y);
        }
    }
    release(empty, 0);
    // alpha/beta were written by this warpgroup's threads through the
    // generic proxy; wgmma reads them through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    bar_wait(q_full, 0);

    // 2. Key tiles with an online softmax. Rows r_lo and r_lo + 8 are this
    // thread's; m, l are per row, l summed over the quad at the end.
    const int len = min(lengths[b], L);
    const int n_chunks = 1 + Dp / 64;  // [k | cos (D2/64) | sin (D2/64)]
    const uint32_t q_rows = q_tile + wrow * 128;
    float o[32], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    uint32_t rh[2] = {0u, 0u};
    if (DROP) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        rh[i] = row_hash(seed, b, h, qw + r_lo + 8 * i, tq);
    }

    for (int j0 = 0; j0 < L; j0 += BN) {
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      fence_acc(s);
      int prev = -1;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const uint32_t a = q_rows + ch * PANEL, kt = take(r, full, ring, st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(s, desc_k(a + 32 * kk), desc_k(kt + 32 * kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();  // the previous chunk's products are done
          release(empty, prev);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_acc(s);
      release(empty, prev);

      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = mask_score(s[4 * j + i], j0 + 8 * j + 2 * t + (i % 2),
                                    len, L);
          tmax[i / 2] = fmaxf(tmax[i / 2], s[4 * j + i]);
        }
      float m_new[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 1));
        tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 2));
        m_new[hf] = fmaxf(m_run[hf], tmax[hf]);
        // key 0 is in the first tile, so m_new is finite and this is
        // exp2(-inf) = 0 there
        const float corr = exp2_approx((m_run[hf] - m_new[hf]) * LOG2E);
        m_run[hf] = m_new[hf];
        l_run[hf] *= corr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j + 2 * hf] *= corr;
          o[4 * j + 2 * hf + 1] *= corr;
        }
      }
      // e = exp(s - m): fp32 into the row sums, then dropped and rescaled,
      // rounded to bf16 as the A fragments of the value product (keys
      // 16kk.. are column groups 2kk and 2kk + 1).
      uint32_t p[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = exp2_approx((s[4 * j + i] - m_new[i / 2]) * LOG2E);
        l_run[0] += e[0] + e[1];
        l_run[1] += e[2] + e[3];
        if (DROP) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            e[i] = keep(rh[i / 2], j0 + 8 * j + 2 * t + (i % 2), thresh)
                       ? e[i] * inv_keep : 0.f;
        }
        p[j / 2][2 * (j % 2)] = pack(e[0], e[1]);
        p[j / 2][2 * (j % 2) + 1] = pack(e[2], e[3]);
      }
      const uint32_t vt = take(r, full, ring, st);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<1>(o, p[kk], desc_mn(vt + 2048 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      release(empty, st);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int q = qw + r_lo + 8 * hf;
      if (q >= L) continue;
      if (stats != nullptr && t == 0) {
        float* sp = stats + (((size_t)b * H + h) * L + q) * 2;
        sp[0] = m_run[hf];
        sp[1] = l;
      }
      const float inv = 1.f / fmaxf(l, 1e-9f);
      bf16* dst = out + ((size_t)b * L + q) * D + h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    }
  }
}

template <bool DROP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const int D = a.H * DH, Dp = a.Dp, D2 = Dp / 2;
  // qv (stage 0) and every wh chunk pair are in the ring before stage 0 is
  // released: 1 + Dp/128 <= STAGES.
  if (1 + Dp / 128 > STAGES || D2 % 64 != 0) return cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps m;
  const cuuint64_t packed[3] = {(cuuint64_t)D, (cuuint64_t)a.L, (cuuint64_t)a.B};
  const cuuint64_t packed_strides[2] = {(cuuint64_t)D * 2,
                                        (cuuint64_t)a.L * D * 2};
  const cuuint64_t wh_dims[2] = {(cuuint64_t)Dp, (cuuint64_t)a.H * DH};
  const cuuint64_t wh_strides[1] = {(cuuint64_t)Dp * 2};
  const cuuint64_t tab[2] = {(cuuint64_t)D2, (cuuint64_t)a.L};
  const cuuint64_t tab_strides[1] = {(cuuint64_t)D2 * 2};
  if (!(encode(fn, &m.qu, a.qu, 3, packed, packed_strides, 64) &&
        encode(fn, &m.qv, a.qv, 3, packed, packed_strides, 64) &&
        encode(fn, &m.k, a.k, 3, packed, packed_strides, BN) &&
        encode(fn, &m.v, a.v, 3, packed, packed_strides, BN) &&
        encode(fn, &m.wh, a.wh, 2, wh_dims, wh_strides, 64) &&
        encode(fn, &m.cos_t, a.cos_t, 2, tab, tab_strides, BN) &&
        encode(fn, &m.sin_t, a.sin_t, 2, tab, tab_strides, BN)))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)(1 + Dp / 64) * PANEL + (size_t)STAGES * STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + BM - 1) / BM, a.H, a.B);
  fwd_kernel<DROP><<<grid, THREADS, smem, stream>>>(
      m, static_cast<const bf16*>(a.sin_t), static_cast<const bf16*>(a.cos_t),
      a.lengths, static_cast<bf16*>(a.out), a.stats, a.L, a.H, Dp, a.seed,
      a.thresh, a.inv_keep, a.tq);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// The general kernel: every (H, dh, D) and both dtypes, on mma.sync.
// ---------------------------------------------------------------------------

namespace general {

using namespace attn::gen;

struct Params {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t;
  const int* lengths;
  void* out;
  float* stats;
  Geo g;
  uint32_t seed, thresh;
  float inv_keep;
  int tq;
};

// One CTA per (g.rows query rows, head, batch row), a pair of warps per 16
// rows, each warp on one half (32 keys) of every 64-key tile with its own
// online softmax; the pair's two states are combined at the end. The
// query tile [qu | alpha | beta] is built once (build_query_tile) and kept
// for the whole key walk. Per 64-key tile the ring streams the g.nc score
// chunks of [k | cos | sin] and then v, g.stages - 1 items ahead of the
// products; the scores stay in registers, the online softmax runs on them
// and P . V takes P from them as A fragments.
template <class T, int DVP, bool DROP>
__global__ void __launch_bounds__(QTHREADS)
fwd_kernel(const __grid_constant__ Params p) {
  constexpr int NV = DVP / 8;  // value n-tiles
  const Geo& g = p.g;
  extern __shared__ float4 smem4[];
  T* qt = reinterpret_cast<T*>(smem4);
  T* ring = qt + g.rows * g.qs;
  const int slot_elems = TK * g.ss, stages = g.stages;
  const int q0 = blockIdx.x * g.rows, h = blockIdx.y, b = blockIdx.z;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* sin_t = static_cast<const T*>(p.sin_t);
  const T* cos_t = static_cast<const T*>(p.cos_t);
  build_query_tile<T>(g, qt, ring, static_cast<const T*>(p.qu),
                      static_cast<const T*>(p.qv), static_cast<const T*>(p.wh),
                      sin_t, cos_t, b, h, q0, g.rows);

  const int warp = threadIdx.x / 32, wrow = 16 * (warp >> 1);
  const int kn0 = 32 * (warp & 1);  // this warp's half of each key tile
  const int l = lane_id(), gq = l >> 2, t = l & 3;
  const int len = min(p.lengths[b], g.L);
  const int ni = g.nc + 1, n_items = ((g.L + TK - 1) / TK) * ni;
  auto issue = [&](int i) {
    if (i < n_items) {
      T* slot = ring + (i % stages) * slot_elems;
      const int j0 = (i / ni) * TK, sub = i % ni;
      if (sub < g.nc)
        load_key_chunk(g, slot, k, cos_t, sin_t, b, h, j0, sub);
      else
        load_head_rows(g, slot, g.ss, v, b, h, j0, TK);
    }
    cp_commit();
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);

  float s[4][4], o[NV][4], m_run[2] = {-INFINITY, -INFINITY},
                           l_run[2] = {0.f, 0.f};
  zero(o);
  uint32_t rh[2] = {0u, 0u};
  if (DROP)
    for (int i = 0; i < 2; ++i)
      rh[i] = row_hash(p.seed, b, h, q0 + wrow + gq + 8 * i, p.tq);

  for (int i = 0; i < n_items; ++i) {
    cp_wait_n(stages - 2);
    __syncthreads();
    issue(i + stages - 1);
    const T* slot = ring + (i % stages) * slot_elems;
    const int j0 = (i / ni) * TK + kn0, sub = i % ni;
    if (sub == 0) zero(s);
    if (sub < g.nc) {
      score_chunk<T>(s, g, qt, slot, wrow, kn0, chunk_of(g, sub));
      continue;
    }
    // This half's scores are complete: mask, online softmax, P . V.
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = mask_score(s[nt][e], j0 + 8 * nt + 2 * t + (e & 1), len, g.L);
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
    float m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 1));
      tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 2));
      const float m_new = fmaxf(m_run[hf], tmax[hf]);
      // -inf until a key below L: the second half of a short row
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f((m_run[hf] - m_use[hf]) * LOG2E);
      m_run[hf] = m_new;
      l_run[hf] *= corr;
#pragma unroll
      for (int vn = 0; vn < NV; ++vn) {
        o[vn][2 * hf] *= corr;
        o[vn][2 * hf + 1] *= corr;
      }
    }
    // e = exp(s - m) into the row sums; then dropped, rescaled and (as A
    // fragments) rounded to T.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f((s[nt][e] - m_use[e >> 1]) * LOG2E);
        l_run[e >> 1] += x;
        if (DROP)
          x = keep(rh[e >> 1], j0 + 8 * nt + 2 * t + (e & 1), p.thresh)
                  ? x * p.inv_keep : 0.f;
        s[nt][e] = x;
      }
    c_times_kn<T, NV>(o, s, slot + kn0 * g.ss, g.ss);
  }

  // Combine the pair: the second half's m, l and o through shared memory
  // (the ring, free now), added to the first's in that order.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
  }
  float* comb = reinterpret_cast<float*>(ring) + ((warp >> 1) * 32 + l) * (4 + 4 * NV);
  __syncthreads();
  if (warp & 1) {
    comb[0] = m_run[0];
    comb[1] = m_run[1];
    comb[2] = l_run[0];
    comb[3] = l_run[1];
#pragma unroll
    for (int vn = 0; vn < NV; ++vn)
#pragma unroll
      for (int e = 0; e < 4; ++e) comb[4 + 4 * vn + e] = o[vn][e];
  }
  __syncthreads();
  if (warp & 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float m1 = comb[hf], m = fmaxf(m_run[hf], m1);
    c0[hf] = exp2f((m_run[hf] - m) * LOG2E);
    c1[hf] = exp2f((m1 - m) * LOG2E);
    m_run[hf] = m;
    l_run[hf] = l_run[hf] * c0[hf] + comb[2 + hf] * c1[hf];
  }
#pragma unroll
  for (int vn = 0; vn < NV; ++vn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[vn][e] = o[vn][e] * c0[e >> 1] + comb[4 + 4 * vn + e] * c1[e >> 1];

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float lsum = l_run[hf];
    const int q = q0 + wrow + gq + 8 * hf;
    if (q >= g.L) continue;
    if (p.stats != nullptr && t == 0) {
      float* sp = p.stats + (((size_t)b * g.H + h) * g.L + q) * 2;
      sp[0] = m_run[hf];
      sp[1] = lsum;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-9f);
    T* dst = static_cast<T*>(p.out) + ((size_t)b * g.L + q) * g.D + h * g.dh;
#pragma unroll
    for (int vn = 0; vn < NV; ++vn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * vn + 2 * t + e;
        if (d < g.dh) dst[d] = from_f<T>(o[vn][2 * hf + e] * inv);
      }
  }
}

// The geometry the forward launches with: rows 0 when no query tile fits.
inline Geo plan(int B, int L, int H, int dh, int Dp, int esz) {
  Geo g = make_geo(B, L, H, dh, Dp, esz);
  g.rows = query_rows(g, false);
  g.stages = g.rows ? query_stages(g, g.rows, false) : 0;
  return g;
}

template <class T, int DVP, bool DROP>
int run(const FwdArgs& a, const Geo& g, cudaStream_t stream) {
  const size_t smem = query_smem(g, g.rows, g.stages, false);
  int err = cudaFuncSetAttribute(fwd_kernel<T, DVP, DROP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (err) return err;
  const Params p{a.qu, a.qv, a.k, a.v, a.wh, a.sin_t, a.cos_t, a.lengths,
                 a.out, a.stats, g, a.seed, a.thresh, a.inv_keep, a.tq};
  const dim3 grid((a.L + g.rows - 1) / g.rows, a.H, a.B);
  fwd_kernel<T, DVP, DROP><<<grid, g.rows * 4, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T, bool DROP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const Geo g = plan(a.B, a.L, a.H, a.dh, a.Dp, sizeof(T));
  if (g.rows == 0) return cudaErrorInvalidValue;
  switch (g.dvp) {
    case 16: return run<T, 16, DROP>(a, g, stream);
    case 32: return run<T, 32, DROP>(a, g, stream);
    case 64: return run<T, 64, DROP>(a, g, stream);
    case 128: return run<T, 128, DROP>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace general

}  // namespace

extern "C" const char* sincos_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernels of sincos_attention_fwd: 0 the bf16 wgmma kernel (namespace
// hopper; dh 64, Dp/2 a multiple of 64, Dp <= 512), 1 the general one.
enum Variant { WGMMA = 0, GENERAL = 1 };

// The general kernels' geometry for these shapes (dtype 0 float32, 1
// bfloat16), as both sources compute it, into out[0..9]: dh and D/2 padded,
// the copy width in bytes, the forward's query rows, ring stages and shared
// memory, the backward query pass's, and the score chunks.
extern "C" void sincos_attention_general_geometry(int B, int L, int H, int dh,
                                                  int Dp, int dtype,
                                                  long long* out) {
  using namespace attn::gen;
  const Geo g = make_geo(B, L, H, dh, Dp, dtype == 0 ? 4 : 2);
  const int fr = query_rows(g, false), br = query_rows(g, true);
  const int fs = fr ? query_stages(g, fr, false) : 0;
  const int bs = br ? query_stages(g, br, true) : 0;
  const long long v[10] = {g.dhp, g.d2p, g.vb, fr, fs,
                           fr ? (long long)query_smem(g, fr, fs, false) : 0,
                           br, bs,
                           br ? (long long)query_smem(g, br, bs, true) : 0,
                           g.nc};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// qu, qv, k, v, out: (B, L, H*dh); wh: (H, dh, Dp); sin_t, cos_t:
// (L, Dp/2) (Dp = H*dh on one device); all of one dtype (0 = float32, 1 = bfloat16), contiguous and
// 16-byte aligned, on the current device. lengths: (B,) int32. stats: null,
// or (B, H, L, 2) float32 for each row's max and sum. scratch: unused
// (neither kernel needs any; null). Dropout keeps an element where
// its hash is >= thresh (0: no dropout, and no hash work), scaled by
// inv_keep; seed and tq as the JAX kernel hashes them. variant: WGMMA
// (bfloat16 only) or GENERAL (dh <= 128). Returns a cudaError_t.
extern "C" int sincos_attention_fwd(const void* qu, const void* qv,
                                    const void* k, const void* v,
                                    const void* wh, const void* sin_t,
                                    const void* cos_t, const void* lengths,
                                    void* out, void* stats, void* scratch,
                                    int B, int L, int H, int dh, int Dp,
                                    int dtype, int variant, uint32_t seed,
                                    uint32_t thresh, float inv_keep, int tq,
                                    void* stream) {
  const FwdArgs a{qu, qv, k, v, wh, sin_t, cos_t,
                  static_cast<const int*>(lengths), out,
                  static_cast<float*>(stats), B, L, H, dh, Dp, seed, thresh,
                  inv_keep, tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  if (variant == WGMMA) {
    if (dtype != 1 || dh != DH) return cudaErrorInvalidValue;
    return drop ? hopper::launch<true>(a, s) : hopper::launch<false>(a, s);
  }
  if (variant != GENERAL) return cudaErrorInvalidValue;
  (void)scratch;
  if (dtype == 0)
    return drop ? general::launch<float, true>(a, s)
                : general::launch<float, false>(a, s);
  if (dtype == 1)
    return drop ? general::launch<bf16, true>(a, s)
                : general::launch<bf16, false>(a, s);
  return cudaErrorInvalidValue;
}
