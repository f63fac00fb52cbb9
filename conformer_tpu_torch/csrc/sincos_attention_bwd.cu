// Fused shift-free relative-position attention, backward (K2), for Hopper
// (sm_90a).
//
// Replaces: conformer_tpu/ops/pallas/sincos_attention.py::_bwd_kernel,
// reached through _bwd_call and the custom VJP _fused. The position side
// is Dp wide (wh and dwh (H, dh, Dp), sin/cos (L, Dp/2), da (B*H, L, Dp)):
// Dp = D on one device, the whole model's width on a rank that a mesh gives
// H/tp heads (sincos_attention.cu). Packed (B, L, D)
// layout, head h in columns [h*dh, (h+1)*dh); the caller has folded the
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
// Design (bfloat16, the training dtype): four kernels on one stream, every
// product on wgmma, every tile brought by TMA (the helpers of hopper.cuh)
// into a ring of 16 KB stages that one producer thread fills and the
// consumer warps release through full/empty mbarrier pairs. ds and p_drop
// go through device memory, so nothing grows with L in shared memory and
// any L runs.
// - q_pass, one CTA per (128 query rows, head, batch row), two consumer
//   warpgroups of 64 rows and a producer warpgroup, as K1: the query tile
//   [qu | alpha | beta] in swizzled panels, the keys' k, cos, sin, v
//   streamed per 128-key tile; scores on m64n128k16 (SS), dO . v^T on
//   m64n128k16 with dO's fragments in registers (RS). Two sweeps over the
//   keys recompute both: the first sums delta, the second writes ds and
//   p_drop rounded to bf16 to a (B*H, L, LP) scratch each (LP = L rounded
//   up to 8) and accumulates dqu += ds . k (RS, k streamed again, MN-major).
// - k_pass, one CTA per (128 keys, head, batch row): dk = ds^T . qu and
//   dv = p_drop^T . dO over 64-query tiles of the scratch; the boxes of ds
//   and p_drop are read MN-major as a transposed A, so no copy transposes
//   them, and the scores are not recomputed.
// - da_pass, one CTA per (128 query rows, head, batch row): per 64
//   coefficient columns, dalpha | dbeta = ds . [cos | sin] over 64-key
//   tiles (ds K-major, the tables MN-major), the rotation into da rounded
//   to bf16 (to a (B*H, L, D) scratch), and dqv += da . wh^T from da's
//   fragments in registers.
// - dwh_pass, one CTA per (64 columns, head): dwh = qv^T . da over every
//   batch row and 64-query tile in a fixed order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits. 3-D tensor maps over (B, L, D) and (B*H, L, L) give zeros past each
// row's L, so the ragged last tiles need no masking in the products; rows
// past L get p = 0 and are never stored. Masking follows the forward: keys
// past the length take float32.min, keys past L are -inf, so a row of
// length 0 has uniform weights in the backward too. p uses ex2.approx with
// log2 e folded in after s - m, as K1 does. Scratch: 2 * B*H*L*LP + B*H*L*D
// bf16 (sincos_attention_bwd_scratch_bytes). These wgmma kernels take
// bf16 at dh 64, D/2 a multiple of 64 and D <= 512 (q_pass keeps K1's
// query tile), like K1's.
// tools/probe_attention_bwd.py times the four launches one by one and the
// whole beside variants without the products, without the copies and
// without q_pass's stores. On the H100 at B 8, L 599 no one of them bounds
// it (each variant keeps 84-91 % of the time): q_pass takes ~58 % (K1's
// softmax-bound key loop twice, both warpgroups in step, plus the hash and
// the stores), da_pass ~27 % (ds four times and the tables once per CTA
// from L2). A key pass that recomputes the scores instead of reading ds and
// p_drop (the probe's recompute_k) takes ~5x k_pass's time.
//
// Every other shape and dtype (fp32 at any width, the reference dtype;
// bf16 at any dh up to 128, odd H, D/2 not a multiple of 64, D > 512)
// takes the general kernels (namespace general; the forward's tiles, ring
// and fragments from attention_general.cuh). They replace PR 6's eleven
// CUDA-core launches (prep, scores, rows, seven strided GEMMs with scalar
// stride-L reads of the transposed operands, combine), which kept
// alpha | beta, ds, p_drop and three (B*H, L, D) buffers in fp32 scratch
// (420 MB at the fp32 production shape) and reduced dwh over B*L rows in H
// CTAs. Five launches now, every product on mma.sync (bf16 m16n8k16, fp32
// 3xTF32 summed per tile), no atomics, every sum in a fixed order:
// - q_pass, one CTA per (64/32/16 query rows, head, batch row), K1's query
//   tile and its key-half warp pairs, with dO's tile beside it: the first
//   sweep recomputes p and dp and sums delta; the second writes ds and
//   p_drop rounded to T to a (B*H, L, lp) scratch in T (lp = L rounded up
//   to 8, zeros past L) and accumulates dqu = ds . k. In bf16 the second
//   sweep recomputes the scores; in fp32 the first stores p and dp in that
//   fp32 scratch (each thread its own elements) and the second reads them
//   back and streams only k.
// - k_pass, one CTA per (64 keys, head, batch row): dk = ds^T . qu and
//   dv = p_drop^T . dO over 64-row tiles, the scratch read k-major
//   (ldmatrix.trans in bf16), coalesced cp.async copies.
// - da_pass, one CTA per (128 query rows, head, batch row) where the grid
//   keeps a CTA per SM, else 64: per 64 coefficient columns,
//   dalpha | dbeta = ds . [cos | sin] over the key tiles, da rounded to T
//   (to a (B*H, L, D) scratch) and dqv += da . wh^T from da's fragments.
// - dwh_partial, one CTA per (64 columns, head, batch row x split): the
//   fixed-order partial qv^T . da over the split's row tiles, the splits
//   chosen to give two CTAs per SM (10 per batch row at ModelConfig.tiny,
//   not 2 CTAs in all); dwh_reduce sums the partials in order.
// Scratch: ds, p_drop and da in T, the partials in fp32
// (sincos_attention_bwd_scratch_bytes; 271 MB at the fp32 production
// shape, no fp32 (B*H, L, L) buffer in bf16).
// What bounds them on the H100 (80GB HBM3, 700 W): q_pass, as K1 (L2 reads
// of the key side, the 3xTF32 split, latency at small widths) twice in
// bf16, and da_pass's reads of the tables per 64 columns. Measured (device
// ms; PR 6's kernels, SDPA's backward on the augmented operands): fp32
// (8, 64), B 8, L 599, rate 0.1: 3.376 (5.382, 1.750), of it q_pass 2.04,
// da_pass 0.92, k_pass 0.34; bf16 (2, 32), B 8, L 599, rate 0.1: 0.333
// (1.312, 0.081), q_pass 0.26; bf16 (12, 64), B 3, L 199, rate 0.1: 0.611
// (1.013, 0.291). Faster than the plain version at each, slower than SDPA.

#include "attention_general.cuh"
#include "hopper.cuh"
#include "sincos_attention_common.cuh"

namespace {

using namespace attn;

struct BwdArgs {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t;
  const int* lengths;
  const float* stats;  // (B, H, L, 2): K1's row max and row sum
  const void* dout;
  void *dqu, *dqv, *dk, *dv, *dwh;
  int B, L, H, dh, Dp;    // Dp: the position width (wh's last axis)
  uint32_t seed, thresh;  // dropout: keep where hash >= thresh (0: none)
  float inv_keep;         // 1 / (1 - rate)
  int tq;                 // the JAX kernel's q-tile rows, for the hash
};

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

// ---------------------------------------------------------------------------
// bfloat16: TMA rings, wgmma, ds and p_drop through device memory.
// ---------------------------------------------------------------------------

namespace hopper {

using namespace sm90;

constexpr int CONSUMERS = 2;          // consumer warpgroups, 64 rows each
constexpr int BM = 64 * CONSUMERS;    // query rows (q_pass, da_pass) or keys (k_pass) per CTA
constexpr int BN = 128;               // keys per tile of q_pass
constexpr int BOX = 64 * 64 * 2;      // bytes of a 64-row box of 64 bf16 columns
constexpr int STAGE = 2 * BOX;        // bytes of one ring stage
constexpr int PANEL = BM * 128;       // bytes of one 64-column query panel
constexpr int THREADS = 128 * (CONSUMERS + 1);  // the last warpgroup produces
constexpr int Q_STAGES = 5;   // q_pass's ring, beside the query panels (80 KB)
constexpr int STAGES = 12;    // the other kernels' rings (192 KB)
using QRing = RingOf<Q_STAGES, STAGE>;
using Ring = RingOf<STAGES, STAGE>;

struct QMaps {                // q_pass: K1's operands
  CUtensorMap qu, qv;         // (B, L, D), 64-row boxes
  CUtensorMap k, v;           // (B, L, D), BN-row boxes
  CUtensorMap wh;             // (H*64, Dp), 64-row boxes
  CUtensorMap cos_t, sin_t;   // (L, Dp/2), BN-row boxes
};
struct KMaps {                // k_pass
  CUtensorMap ds, pd;         // (B*H, L, L) scratch, 64-row boxes
  CUtensorMap qu, dout;       // (B, L, D), 64-row boxes
};
struct AMaps {                // da_pass
  CUtensorMap ds;             // (B*H, L, L), 64-row boxes
  CUtensorMap cos_t, sin_t;   // (L, Dp/2), 64-row boxes
  CUtensorMap wh;             // (H*64, Dp), 64-row boxes
};
struct WMaps {                // dwh_pass
  CUtensorMap qv;             // (B, L, D), 64-row boxes
  CUtensorMap da;             // (B*H, L, Dp) scratch, 64-row boxes
};

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty,
                                          int stages, int releasers) {
  for (int i = 0; i < stages; ++i) {
    bar_init(full + 8 * i, 1);
    bar_init(empty + 8 * i, releasers);
  }
}

// q_pass's products for one key tile: the scores s = [qu | alpha | beta] .
// [k | cos | sin]^T (m64n128k16, the query panels against the streamed
// chunks, as K1) and dov = dO . v^T (dO's A fragments from registers, v
// K-major), both unmasked, each stage released once its products are done.
__device__ __forceinline__ void tile_products(QRing& r, uint32_t full,
                                              uint32_t empty, uint32_t ring,
                                              uint32_t q_rows, int n_chunks,
                                              const uint32_t (&dof)[4][4],
                                              float (&s)[64], float (&dov)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = dov[i] = 0.f;
  fence_acc(s);
  fence_acc(dov);
  int st, prev = -1;
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
  const uint32_t vt = take(r, full, ring, st);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(dov, dof[kk], desc_k(vt + 32 * kk));
  wgmma_commit();
  wgmma_wait<1>();
  release(empty, prev);
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dov);
  release(empty, st);
}

// One CTA per (128 query rows, head, batch row). Builds [qu | alpha |
// beta] as K1 does, then sweeps the keys twice, recomputing the scores and
// dO . v^T: the first sweep sums delta = sum_j p . dp per row, the second
// forms ds and p_drop, writes both rounded to bf16 to the (B*H, L, LP)
// scratch and accumulates dqu += ds . k (k streamed again after v, read
// MN-major).
template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
q_pass(const __grid_constant__ QMaps maps, const BwdArgs a,
       bf16* __restrict__ ds_out, bf16* __restrict__ pd_out, int LP) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int L = a.L, H = a.H, D = H * DH, D2 = a.Dp / 2, n_half = D2 / 64;
  const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
  const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * Q_STAGES + 1];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_tile = (raw + 1023u) & ~1023u;
  uint8_t* q_ptr = smem_raw + (q_tile - raw);
  const uint32_t ring = q_tile + (1 + a.Dp / 64) * PANEL;
  const uint32_t full = smem_u32(bars), empty = full + 8 * Q_STAGES,
                 q_full = full + 16 * Q_STAGES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    init_ring(full, empty, Q_STAGES, 4 * CONSUMERS);
    bar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      const int col_h = h * DH;
      bar_expect(q_full, CONSUMERS * BOX);
      for (int i = 0; i < CONSUMERS; ++i)
        tma_3d(q_tile + i * BOX, &maps.qu, q_full, col_h, q0 + 64 * i, b);
      QRing r;
      uint2 st = claim(r, full, empty, ring, CONSUMERS * BOX);
      for (int i = 0; i < CONSUMERS; ++i)
        tma_3d(st.x + i * BOX, &maps.qv, st.y, col_h, q0 + 64 * i, b);
      r.next();
      for (int c = 0; c < n_half; ++c) {
        st = claim(r, full, empty, ring, 2 * BOX);
        tma_2d(st.x, &maps.wh, st.y, c * 64, col_h);
        tma_2d(st.x + BOX, &maps.wh, st.y, D2 + c * 64, col_h);
        r.next();
      }
      // per key tile and sweep: k, the cos chunks, the sin chunks, v, and
      // in the second sweep k again
      for (int sweep = 0; sweep < 2; ++sweep)
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
          if (sweep == 1) {
            st = claim(r, full, empty, ring, STAGE);
            tma_3d(st.x, &maps.k, st.y, col_h, j0, b);
            r.next();
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * ((tid % 128) / 32) + g;  // rows r_lo, r_lo + 8
    const int qw = q0 + wg * 64;  // this warpgroup's first query row
    const int wrow = wg * 64;     // ... and its first row in the panels
    QRing r;
    int st;

    // 1. a = qv . wh[h] and alpha, beta into the query panels, as K1.
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
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    bar_wait(q_full, 0);

    // 2. Row statistics of this thread's rows r_lo, r_lo + 8 (K1's max and
    // sum; rows past L take p = 0), and dO of the warp's 16 rows as the A
    // fragments of dO . v^T.
    const int len = min(a.lengths[b], L);
    const int n_chunks = 1 + a.Dp / 64;
    const uint32_t q_rows = q_tile + wrow * 128;
    const size_t bh = (size_t)b * H + h;
    float m_r[2], il_r[2], dl[2] = {0.f, 0.f};
    bool ok[2];
    uint32_t rh[2] = {0u, 0u};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = qw + r_lo + 8 * hf;
      ok[hf] = q < L;
      m_r[hf] = ok[hf] ? a.stats[(bh * L + q) * 2] : 0.f;
      il_r[hf] = ok[hf] ? 1.f / fmaxf(a.stats[(bh * L + q) * 2 + 1], 1e-9f) : 0.f;
      if (DROP) rh[hf] = row_hash(a.seed, b, h, q, a.tq);
    }
    const bf16* dout = static_cast<const bf16*>(a.dout);
    uint32_t dof[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qw + r_lo + 8 * (i % 2);
        dof[kk][i] = q < L ? ld32(dout + ((size_t)b * L + q) * D + h * DH +
                                  16 * kk + 8 * (i / 2) + 2 * t)
                           : 0u;
      }

    // 3. First sweep: delta = sum_j p . dp in fp32, as the JAX kernel sums
    // it (dO . O would take K1's bf16-rounded p_drop and leave a residue
    // where ds is exactly 0, as in a row of length 1).
    float s[64], dov[64];
    for (int j0 = 0; j0 < L; j0 += BN) {
      tile_products(r, full, empty, ring, q_rows, n_chunks, dof, s, dov);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hf = i / 2, key = j0 + 8 * j + 2 * t + (i % 2);
          const float sc = mask_score(s[4 * j + i], key, len, L);
          const float p =
              ok[hf] ? exp2_approx((sc - m_r[hf]) * LOG2E) * il_r[hf] : 0.f;
          float dp = dov[4 * j + i];
          if (DROP) dp = keep(rh[hf], key, a.thresh) ? dp * a.inv_keep : 0.f;
          dl[hf] += p * dp;
        }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // the quad's four lanes hold a row
      dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 1);
      dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 2);
    }

    // 4. Second sweep: ds = T(p . (dp - delta)) and p_drop = T(keep . p /
    // (1 - rate)) to scratch; dqu += ds . k.
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    bf16* ds_row[2];
    bf16* pd_row[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const size_t off = (bh * L + qw + r_lo + 8 * hf) * (size_t)LP;
      ds_row[hf] = ds_out + off;
      pd_row[hf] = pd_out + off;
    }
    for (int j0 = 0; j0 < L; j0 += BN) {
      tile_products(r, full, empty, ring, q_rows, n_chunks, dof, s, dov);
      uint32_t dsa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float dsv[4], pdv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hf = i / 2, key = j0 + 8 * j + 2 * t + (i % 2);
          const float sc = mask_score(s[4 * j + i], key, len, L);
          const float p =
              ok[hf] ? exp2_approx((sc - m_r[hf]) * LOG2E) * il_r[hf] : 0.f;
          float dp = dov[4 * j + i], pd = p;
          if (DROP) {
            const bool kp = keep(rh[hf], key, a.thresh);
            dp = kp ? dp * a.inv_keep : 0.f;
            pd = kp ? p * a.inv_keep : 0.f;
          }
          dsv[i] = p * (dp - dl[hf]);
          pdv[i] = pd;
        }
        // keys 16kk.. are column groups 2kk and 2kk + 1 of the A fragments
        dsa[j / 2][2 * (j % 2)] = pack(dsv[0], dsv[1]);
        dsa[j / 2][2 * (j % 2) + 1] = pack(dsv[2], dsv[3]);
        const int key = j0 + 8 * j + 2 * t;  // even; LP > L when L is odd
        if (key < L) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (ok[hf]) {
              *reinterpret_cast<uint32_t*>(ds_row[hf] + key) =
                  dsa[j / 2][2 * (j % 2) + hf];
              *reinterpret_cast<uint32_t*>(pd_row[hf] + key) =
                  pack(pdv[2 * hf], pdv[2 * hf + 1]);
            }
        }
      }
      const uint32_t kt = take(r, full, ring, st);
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs<1>(dq, dsa[kk], desc_mn(kt + 2048 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      release(empty, st);
    }
    bf16* dqu = static_cast<bf16*>(a.dqu);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = qw + r_lo + 8 * hf;
      if (q >= L) continue;
      bf16* dst = dqu + ((size_t)b * L + q) * D + h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack(dq[4 * j + 2 * hf], dq[4 * j + 2 * hf + 1]);
    }
  }
}

// One CTA per (128 keys, head, batch row), 64 keys per consumer warpgroup:
// dk = ds^T . qu and dv = p_drop^T . dO over 64-query tiles of the scratch,
// the ds and p_drop boxes read MN-major as A (transposed), qu and dO
// MN-major as B. Query rows past L are zero in every box (TMA's fill).
__global__ void __launch_bounds__(THREADS, 1)
k_pass(const __grid_constant__ KMaps maps, const BwdArgs a) {
  const int L = a.L, D = a.H * DH;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h, tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    init_ring(full, empty, STAGES, 4 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    if (tid == CONSUMERS * 128) {
      Ring r;
      for (int q0 = 0; q0 < L; q0 += 64) {
        uint2 st = claim(r, full, empty, ring, STAGE);
        tma_3d(st.x, &maps.qu, st.y, h * DH, q0, b);
        tma_3d(st.x + BOX, &maps.dout, st.y, h * DH, q0, b);
        r.next();
        for (int m = 0; m < 2; ++m) {  // ds, then p_drop
          st = claim(r, full, empty, ring, STAGE);
          for (int i = 0; i < CONSUMERS; ++i)
            tma_3d(st.x + i * BOX, m == 0 ? &maps.ds : &maps.pd, st.y,
                   k0 + 64 * i, q0, bh);
          r.next();
        }
      }
    }
  } else {
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * ((tid % 128) / 32) + g;
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    fence_acc(dk);
    fence_acc(dv);
    Ring r;
    int prev[3] = {-1, -1, -1};
    for (int q0 = 0; q0 < L; q0 += 64) {
      int cur[3];
      const uint32_t ops = take(r, full, ring, cur[0]);  // [qu | dO]
      const uint32_t dst = take(r, full, ring, cur[1]) + wg * BOX;
      const uint32_t pdt = take(r, full, ring, cur[2]) + wg * BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(dk, desc_mn(dst + 2048 * kk), desc_mn(ops + 2048 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(dv, desc_mn(pdt + 2048 * kk),
                       desc_mn(ops + BOX + 2048 * kk));
      wgmma_commit();
      if (prev[0] >= 0) {
        wgmma_wait<1>();  // the previous tile's products are done
#pragma unroll
        for (int i = 0; i < 3; ++i) release(empty, prev[i]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) prev[i] = cur[i];
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 3; ++i) release(empty, prev[i]);
    fence_acc(dk);
    fence_acc(dv);
    bf16* dk_out = static_cast<bf16*>(a.dk);
    bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + wg * 64 + r_lo + 8 * hf;
      if (key >= L) continue;
      const size_t off = ((size_t)b * L + key) * D + h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk_out + off + j * 8) =
            pack(dk[4 * j + 2 * hf], dk[4 * j + 2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + off + j * 8) =
            pack(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// One CTA per (128 query rows, head, batch row). For each 64 coefficient
// columns c of the sin and cos halves: [dalpha | dbeta] = ds . [cos | sin]
// over 64-key tiles (ds K-major as A, the tables MN-major as B), the
// rotation into da rounded to bf16 (to scratch, for dwh_pass), and dqv +=
// da . wh^T with da's A fragments from registers and wh[h] K-major.
__global__ void __launch_bounds__(THREADS, 1)
da_pass(const __grid_constant__ AMaps maps, const BwdArgs a,
        bf16* __restrict__ da_out) {
  const int L = a.L, H = a.H, D = H * DH, Dp = a.Dp, D2 = Dp / 2,
            n_half = D2 / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    init_ring(full, empty, STAGES, 4 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    if (tid == CONSUMERS * 128) {
      Ring r;
      // per 64 columns: the key tiles' ds and [cos | sin], then wh[h]'s
      // sin and cos chunks (no stage is held across the key loop)
      for (int c = 0; c < n_half; ++c) {
        uint2 st;
        for (int j0 = 0; j0 < L; j0 += 64) {
          st = claim(r, full, empty, ring, STAGE);
          for (int i = 0; i < CONSUMERS; ++i)
            tma_3d(st.x + i * BOX, &maps.ds, st.y, j0, q0 + 64 * i, bh);
          r.next();
          st = claim(r, full, empty, ring, STAGE);
          tma_2d(st.x, &maps.cos_t, st.y, c * 64, j0);
          tma_2d(st.x + BOX, &maps.sin_t, st.y, c * 64, j0);
          r.next();
        }
        st = claim(r, full, empty, ring, STAGE);
        tma_2d(st.x, &maps.wh, st.y, c * 64, h * DH);
        tma_2d(st.x + BOX, &maps.wh, st.y, D2 + c * 64, h * DH);
        r.next();
      }
    }
  } else {
    const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
    const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * ((tid % 128) / 32) + g;
    const int qw = q0 + wg * 64;
    float dqv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqv[i] = 0.f;
    fence_acc(dqv);
    Ring r;
    int s_w;
    for (int c = 0; c < n_half; ++c) {
      float dal[32], dbe[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dal[i] = dbe[i] = 0.f;
      fence_acc(dal);
      fence_acc(dbe);
      int prev_a = -1, prev_t = -1;
      for (int j0 = 0; j0 < L; j0 += 64) {
        int s_a, s_t;
        const uint32_t at = take(r, full, ring, s_a) + wg * BOX;
        const uint32_t tt = take(r, full, ring, s_t);  // cos | sin
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1>(dal, desc_k(at + 32 * kk), desc_mn(tt + 2048 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1>(dbe, desc_k(at + 32 * kk), desc_mn(tt + BOX + 2048 * kk));
        wgmma_commit();
        if (prev_a >= 0) {
          wgmma_wait<1>();  // the previous tile's products are done
          release(empty, prev_a);
          release(empty, prev_t);
        }
        prev_a = s_a;
        prev_t = s_t;
      }
      wgmma_wait<0>();
      release(empty, prev_a);
      release(empty, prev_t);
      fence_acc(dal);
      fence_acc(dbe);
      // da_s = T(dalpha . sin_q - dbeta . cos_q), da_c = T(dalpha . cos_q +
      // dbeta . sin_q), as A fragments (columns 16kk.. are groups 2kk and
      // 2kk + 1) and to scratch
      uint32_t fs[4][4], fc[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = qw + r_lo + 8 * hf, x = c * 64 + 8 * j + 2 * t;
          float2 sq = make_float2(0.f, 0.f), cq = sq;
          if (q < L) {
            sq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                sin_t + (size_t)q * D2 + x));
            cq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                cos_t + (size_t)q * D2 + x));
          }
          const float a0 = dal[4 * j + 2 * hf], a1 = dal[4 * j + 2 * hf + 1];
          const float b0 = dbe[4 * j + 2 * hf], b1 = dbe[4 * j + 2 * hf + 1];
          const uint32_t us = pack(a0 * sq.x - b0 * cq.x, a1 * sq.y - b1 * cq.y);
          const uint32_t uc = pack(a0 * cq.x + b0 * sq.x, a1 * cq.y + b1 * sq.y);
          fs[j / 2][2 * (j % 2) + hf] = us;
          fc[j / 2][2 * (j % 2) + hf] = uc;
          if (q < L) {
            bf16* dst = da_out + ((size_t)bh * L + q) * Dp + x;
            *reinterpret_cast<uint32_t*>(dst) = us;
            *reinterpret_cast<uint32_t*>(dst + D2) = uc;
          }
        }
      const uint32_t wt = take(r, full, ring, s_w);  // wh[h] sin | cos chunk
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(dqv, fs[kk], desc_k(wt + 32 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(dqv, fc[kk], desc_k(wt + BOX + 32 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      release(empty, s_w);
    }
    fence_acc(dqv);
    bf16* dqv_out = static_cast<bf16*>(a.dqv);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = qw + r_lo + 8 * hf;
      if (q >= L) continue;
      bf16* dst = dqv_out + ((size_t)b * L + q) * D + h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack(dqv[4 * j + 2 * hf], dqv[4 * j + 2 * hf + 1]);
    }
  }
}

// One CTA per (64 columns of Dp, head): dwh[h][:, cols] = sum over batch
// rows and 64-query tiles, in that fixed order, of qv_h^T . da (qv read
// MN-major as A, da MN-major as B), one consumer warpgroup.
constexpr int W_THREADS = 256;

__global__ void __launch_bounds__(W_THREADS, 1)
dwh_pass(const __grid_constant__ WMaps maps, const BwdArgs a) {
  const int L = a.L, H = a.H, Dp = a.Dp;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int x0 = blockIdx.x * 64, h = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) {
    init_ring(full, empty, STAGES, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      Ring r;
      for (int b = 0; b < a.B; ++b)
        for (int q0 = 0; q0 < L; q0 += 64) {
          const uint2 st = claim(r, full, empty, ring, STAGE);
          tma_3d(st.x, &maps.qv, st.y, h * DH, q0, b);
          tma_3d(st.x + BOX, &maps.da, st.y, x0, q0, b * H + h);
          r.next();
        }
    }
  } else {
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * (tid / 32) + g;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_acc(acc);
    Ring r;
    int st, prev = -1;
    for (int b = 0; b < a.B; ++b)
      for (int q0 = 0; q0 < L; q0 += 64) {
        const uint32_t tile = take(r, full, ring, st);  // [qv | da]
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(acc, desc_mn(tile + 2048 * kk),
                         desc_mn(tile + BOX + 2048 * kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();  // the previous tile's product is done
          release(empty, prev);
        }
        prev = st;
      }
    wgmma_wait<0>();
    release(empty, prev);
    fence_acc(acc);
    bf16* dwh = static_cast<bf16*>(a.dwh);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      bf16* dst = dwh + ((size_t)h * DH + r_lo + 8 * hf) * Dp + x0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
}

inline int padded_len(int L) { return (L + 7) / 8 * 8; }

struct Scratch {
  bf16 *ds, *pd, *da;
};

// ds and p_drop (B*H, L, LP) with rows padded to LP (16-byte TMA strides),
// da (B*H, L, Dp).
inline size_t scratch_layout(int B, int L, int H, int Dp, char* base,
                             Scratch* s) {
  const size_t rows = (size_t)B * H * L;
  const size_t n_sq = align256(sizeof(bf16) * rows * padded_len(L));
  const size_t n_da = align256(sizeof(bf16) * rows * Dp);
  if (s != nullptr) {
    s->ds = reinterpret_cast<bf16*>(base);
    s->pd = reinterpret_cast<bf16*>(base + n_sq);
    s->da = reinterpret_cast<bf16*>(base + 2 * n_sq);
  }
  return 2 * n_sq + n_da;
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool DROP>
int launch(const BwdArgs& a, void* scratch, cudaStream_t stream) {
  const int B = a.B, L = a.L, H = a.H, D = H * DH, Dp = a.Dp, D2 = Dp / 2,
            LP = padded_len(L);
  // qv (stage 0) and every wh chunk pair are in q_pass's ring before stage
  // 0 is released: 1 + Dp/128 <= Q_STAGES.
  if (1 + Dp / 128 > Q_STAGES || D2 % 64 != 0) return cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Scratch s;
  scratch_layout(B, L, H, Dp, static_cast<char*>(scratch), &s);
  const cuuint64_t packed[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t packed_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint64_t wh_dims[2] = {(cuuint64_t)Dp, (cuuint64_t)H * DH};
  const cuuint64_t wh_strides[1] = {(cuuint64_t)Dp * 2};
  const cuuint64_t tab[2] = {(cuuint64_t)D2, (cuuint64_t)L};
  const cuuint64_t tab_strides[1] = {(cuuint64_t)D2 * 2};
  const cuuint64_t sq[3] = {(cuuint64_t)L, (cuuint64_t)L, (cuuint64_t)B * H};
  const cuuint64_t sq_strides[2] = {(cuuint64_t)LP * 2, (cuuint64_t)L * LP * 2};
  const cuuint64_t da_dims[3] = {(cuuint64_t)Dp, (cuuint64_t)L, (cuuint64_t)B * H};
  const cuuint64_t da_strides[2] = {(cuuint64_t)Dp * 2, (cuuint64_t)L * Dp * 2};
  QMaps qm;
  KMaps km;
  AMaps am;
  WMaps wm;
  if (!(encode(fn, &qm.qu, a.qu, 3, packed, packed_strides, 64) &&
        encode(fn, &qm.qv, a.qv, 3, packed, packed_strides, 64) &&
        encode(fn, &qm.k, a.k, 3, packed, packed_strides, BN) &&
        encode(fn, &qm.v, a.v, 3, packed, packed_strides, BN) &&
        encode(fn, &qm.wh, a.wh, 2, wh_dims, wh_strides, 64) &&
        encode(fn, &qm.cos_t, a.cos_t, 2, tab, tab_strides, BN) &&
        encode(fn, &qm.sin_t, a.sin_t, 2, tab, tab_strides, BN) &&
        encode(fn, &km.ds, s.ds, 3, sq, sq_strides, 64) &&
        encode(fn, &km.pd, s.pd, 3, sq, sq_strides, 64) &&
        encode(fn, &km.qu, a.qu, 3, packed, packed_strides, 64) &&
        encode(fn, &km.dout, a.dout, 3, packed, packed_strides, 64) &&
        encode(fn, &am.cos_t, a.cos_t, 2, tab, tab_strides, 64) &&
        encode(fn, &am.sin_t, a.sin_t, 2, tab, tab_strides, 64) &&
        encode(fn, &wm.da, s.da, 3, da_dims, da_strides, 64)))
    return cudaErrorInvalidValue;
  am.ds = km.ds;
  am.wh = qm.wh;
  wm.qv = qm.qv;
  const size_t smem_q = 1024 + (size_t)(1 + Dp / 64) * PANEL + (size_t)Q_STAGES * STAGE;
  const size_t smem_r = 1024 + (size_t)STAGES * STAGE;
  int err;
  if ((err = set_smem(q_pass<DROP>, smem_q)) || (err = set_smem(k_pass, smem_r)) ||
      (err = set_smem(da_pass, smem_r)) || (err = set_smem(dwh_pass, smem_r)))
    return err;
  const dim3 rows((L + BM - 1) / BM, H, B);
  q_pass<DROP><<<rows, THREADS, smem_q, stream>>>(qm, a, s.ds, s.pd, LP);
  if ((err = cudaGetLastError())) return err;
  k_pass<<<rows, THREADS, smem_r, stream>>>(km, a);
  if ((err = cudaGetLastError())) return err;
  da_pass<<<rows, THREADS, smem_r, stream>>>(am, a, s.da);
  if ((err = cudaGetLastError())) return err;
  dwh_pass<<<dim3(Dp / 64, H), W_THREADS, smem_r, stream>>>(wm, a);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// The general kernels: every (H, dh, D) and both dtypes, on mma.sync; ds
// and p_drop through device memory in T.
// ---------------------------------------------------------------------------

namespace general {

using namespace attn::gen;

// Scratch: ds and p_drop (B*H, L, lp) in T, da (B*H, L, Dp) in T, and the
// dwh partials (B * splits, H, dh, Dp) in fp32.
struct Scratch {
  void *ds, *pd, *da;
  float* part;
};

// Row stride of ds and p_drop: L rounded up to 8 (16-byte rows in both
// dtypes); q_pass writes zeros past L so that every copy reads written
// values.
__host__ __device__ inline int ds_stride(int L) { return round_up(L, 8); }

// Row-tile splits of each batch row in the dwh pass: enough CTAs for two
// per SM, at most one split per 64-row tile.
inline int dwh_splits(const Geo& g) {
  const int base = ((g.Dp + 63) / 64) * g.H * g.B, nqt = (g.L + TK - 1) / TK;
  const int want = (2 * SMS + base - 1) / base;
  return want < 1 ? 1 : (want > nqt ? nqt : want);
}

inline size_t scratch_layout(const Geo& g, char* base, Scratch* s) {
  const size_t bh = (size_t)g.B * g.H;
  const size_t sizes[4] = {
      align256(bh * g.L * ds_stride(g.L) * g.esz),
      align256(bh * g.L * ds_stride(g.L) * g.esz),
      align256(bh * g.L * g.Dp * g.esz),
      align256((size_t)g.B * dwh_splits(g) * g.H * g.dh * g.Dp * 4)};
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    if (s != nullptr) {
      void* p = base + off;
      if (i == 0) s->ds = p;
      if (i == 1) s->pd = p;
      if (i == 2) s->da = p;
      if (i == 3) s->part = static_cast<float*>(p);
    }
    off += sizes[i];
  }
  return off;
}

template <class T>
__device__ __forceinline__ void store2(T* p, float x0, float x1, bool both) {
  p[0] = from_f<T>(x0);
  if (both) p[1] = from_f<T>(x1);
}

struct QParams {
  const void *qu, *qv, *k, *v, *wh, *sin_t, *cos_t, *dout;
  const int* lengths;
  const float* stats;
  void *dqu, *ds, *pd;
  Geo g;
  uint32_t seed, thresh;
  float inv_keep;
  int tq;
};

// q_pass: one CTA per (g.rows query rows, head, batch row), a pair of
// warps per 16 rows, each on one half (32 keys) of every key tile; K1's
// query tile plus dO's tile in shared memory. Two sweeps over the key
// tiles. The first streams the score chunks and v, recomputes p and
// dp = keep . dO v^T / (1 - rate) and sums delta = sum p dp per row in a
// fixed order (each half, then the two halves through shared memory). The
// second writes ds = T(p (dp - delta)) and p_drop = T(keep . p / (1 - rate))
// and accumulates dqu = ds . k (the halves' sums added at the end): in
// bf16 it streams the score chunks, v and k again and recomputes p and dp;
// in fp32 the first sweep has stored p and dp in the fp32 ds and p_drop
// scratch, each thread its own elements, and the second reads them back
// and streams only k.
template <class T, int DVP, bool DROP>
__global__ void __launch_bounds__(QTHREADS)
q_pass(const __grid_constant__ QParams p) {
  using M = Mma<T>;
  constexpr int NV = DVP / 8;
  const Geo& g = p.g;
  extern __shared__ float4 smem4[];
  const int dos = g.dvp + g.pa;
  T* qt = reinterpret_cast<T*>(smem4);
  T* dot = qt + g.rows * g.qs;
  float* dsum = reinterpret_cast<float*>(dot + g.rows * dos);  // [half][row]
  T* ring = reinterpret_cast<T*>(dsum + 2 * g.rows);
  const int slot_elems = TK * g.ss, stages = g.stages;
  const int q0 = blockIdx.x * g.rows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* sin_t = static_cast<const T*>(p.sin_t);
  const T* cos_t = static_cast<const T*>(p.cos_t);
  // dO's tile joins the prologue's first copy group
  load_tile(dot, dos,
            static_cast<const T*>(p.dout) + ((size_t)b * g.L + q0) * g.D +
                h * g.dh,
            g.D, g.rows, g.L - q0, g.dvp, g.dh, g.vb);
  build_query_tile<T>(g, qt, ring, static_cast<const T*>(p.qu),
                      static_cast<const T*>(p.qv), static_cast<const T*>(p.wh),
                      sin_t, cos_t, b, h, q0, g.rows);

  constexpr bool KEEP_P = sizeof(T) == 4;  // p and dp kept in scratch
  const int warp = threadIdx.x / 32, wrow = 16 * (warp >> 1);
  const int half = warp & 1, kn0 = 32 * half;
  const int l = lane_id(), gq = l >> 2, t = l & 3;
  const int len = min(p.lengths[b], g.L), lp = ds_stride(g.L);
  const int nkt = (g.L + TK - 1) / TK, ni0 = g.nc + 1;
  const int ni1 = KEEP_P ? 1 : g.nc + 2;
  const int n0 = nkt * ni0, n_items = n0 + nkt * ni1;
  auto decode = [&](int i, int& sweep, int& j0, int& sub) {
    sweep = i >= n0;
    const int r = sweep ? i - n0 : i, ni = sweep ? ni1 : ni0;
    j0 = (r / ni) * TK;
    sub = sweep && KEEP_P ? g.nc + 1 : r % ni;
  };
  T* ds_rows = static_cast<T*>(p.ds) + bh * g.L * lp;
  T* pd_rows = static_cast<T*>(p.pd) + bh * g.L * lp;
  auto issue = [&](int i) {
    if (i < n_items) {
      int sweep, j0, sub;
      decode(i, sweep, j0, sub);
      T* slot = ring + (i % stages) * slot_elems;
      if (sub < g.nc)
        load_key_chunk(g, slot, k, cos_t, sin_t, b, h, j0, sub);
      else
        load_head_rows(g, slot, g.ss, sub == g.nc ? v : k, b, h, j0, TK);
    }
    cp_commit();
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);

  float m[2], lden[2], delta[2] = {0.f, 0.f};
  uint32_t rh[2] = {0u, 0u};
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + wrow + gq + 8 * hf;
    m[hf] = q < g.L ? p.stats[(bh * g.L + q) * 2] : 0.f;
    lden[hf] = q < g.L ? fmaxf(p.stats[(bh * g.L + q) * 2 + 1], 1e-9f) : 1.f;
    if (DROP) rh[hf] = row_hash(p.seed, b, h, q, p.tq);
  }
  float s[4][4], dq[NV][4];
  zero(dq);

  for (int i = 0; i < n_items; ++i) {
    cp_wait_n(stages - 2);
    __syncthreads();
    issue(i + stages - 1);
    const T* slot = ring + (i % stages) * slot_elems;
    int sweep, j0, sub;
    decode(i, sweep, j0, sub);
    j0 += kn0;
    if (sub == 0) zero(s);
    if (sub < g.nc) {
      score_chunk<T>(s, g, qt, slot, wrow, kn0, chunk_of(g, sub));
      continue;
    }
    if (sub == g.nc + 1) {  // k: dqu += ds . k
      if constexpr (KEEP_P) {
        // p and dp of this thread's elements, as the first sweep stored
        // them: ds and p_drop over them
        float dtot[2];
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wrow + gq + 8 * hf;
          dtot[hf] = dsum[r] + dsum[g.rows + r];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int key = j0 + 8 * nt + 2 * t, q = q0 + wrow + gq + 8 * hf;
            float2 pv = make_float2(0.f, 0.f), dp = pv;
            const size_t off = (size_t)q * lp + key;
            if (q < g.L && key < lp) {
              pv = *reinterpret_cast<const float2*>(pd_rows + off);
              dp = *reinterpret_cast<const float2*>(ds_rows + off);
            }
            const float pe[2] = {pv.x, pv.y}, de[2] = {dp.x, dp.y};
            float dsv[2], pdv[2];
            for (int e = 0; e < 2; ++e) {
              const bool kept = !DROP || keep(rh[hf], key + e, p.thresh);
              dsv[e] = pe[e] * (de[e] - dtot[hf]);
              pdv[e] = DROP ? (kept ? pe[e] * p.inv_keep : 0.f) : pe[e];
              s[nt][2 * hf + e] = dsv[e];
            }
            if (q < g.L && key < lp) {
              *reinterpret_cast<float2*>(ds_rows + off) = make_float2(dsv[0], dsv[1]);
              *reinterpret_cast<float2*>(pd_rows + off) = make_float2(pdv[0], pdv[1]);
            }
          }
      }
      c_times_kn<T, NV>(dq, s, slot + kn0 * g.ss, g.ss);
      continue;
    }
    // v: dO . v^T over the head width, then p, dp and delta or ds, p_drop.
    float dov[4][4];
    zero(dov);
    for (int kk = 0; kk < g.dvp; kk += M::K) {
      if constexpr (sizeof(T) == 2) {
        uint32_t a[4], bb[4];
        M::a_mk(a, dot, dos, wrow, kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          M::b_nk(bb, slot, g.ss, kn0 + 16 * np, kk);
          M::mma2(dov[2 * np], dov[2 * np + 1], a, bb);
        }
      } else {
        SplitA a;
        M::a_mk(a, dot, dos, wrow, kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          float bb[4];
          M::b_nk(bb, slot, g.ss, kn0 + 16 * np, kk);
          mma3(dov[2 * np], a, bb[0], bb[1]);
          mma3(dov[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    float dtot[2] = {0.f, 0.f};
    if (sweep == 1)
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wrow + gq + 8 * hf;
        dtot[hf] = dsum[r] + dsum[g.rows + r];
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * nt + 2 * t + (e & 1), hf = e >> 1;
        const int q = q0 + wrow + gq + 8 * hf;
        const float pv =
            q < g.L ? exp2f((mask_score(s[nt][e], key, len, g.L) - m[hf]) *
                            LOG2E) / lden[hf]
                    : 0.f;
        const bool kept = !DROP || keep(rh[hf], key, p.thresh);
        const float dp = DROP ? (kept ? dov[nt][e] * p.inv_keep : 0.f)
                              : dov[nt][e];
        if (sweep == 0) {
          delta[hf] += pv * dp;
          if (KEEP_P) {  // dp to the ds scratch, p to the p_drop one
            s[nt][e] = key < g.L ? dp : 0.f;
            dov[nt][e] = key < g.L ? pv : 0.f;
          }
        } else {
          s[nt][e] = rnd<T>(pv * (dp - dtot[hf]));
          dov[nt][e] = DROP ? (kept ? pv * p.inv_keep : 0.f) : pv;
        }
      }
    if (sweep == 0) {
      if (j0 - kn0 + TK >= g.L) {  // the last key tile: this half's sums
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          delta[hf] += __shfl_xor_sync(0xffffffffu, delta[hf], 1);
          delta[hf] += __shfl_xor_sync(0xffffffffu, delta[hf], 2);
          if (t == 0) dsum[half * g.rows + wrow + gq + 8 * hf] = delta[hf];
        }
      }
      if (!KEEP_P) continue;
    }
    // ds and p_drop (fp32's first sweep: p and dp) to scratch; keys in
    // [L, lp) get zeros
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = j0 + 8 * nt + 2 * t, q = q0 + wrow + gq + 8 * hf;
        if (q >= g.L || key >= lp) continue;
        const size_t off = (bh * g.L + q) * lp + key;
        const bool in0 = key < g.L, in1 = key + 1 < g.L;
        store2(static_cast<T*>(p.ds) + off, in0 ? s[nt][2 * hf] : 0.f,
               in1 ? s[nt][2 * hf + 1] : 0.f, true);
        store2(static_cast<T*>(p.pd) + off, in0 ? dov[nt][2 * hf] : 0.f,
               in1 ? dov[nt][2 * hf + 1] : 0.f, true);
      }
  }

  // dqu: the second half's sums through shared memory (the ring, free
  // now), added to the first's.
  float* comb = reinterpret_cast<float*>(ring) + ((warp >> 1) * 32 + l) * 4 * NV;
  __syncthreads();
  if (half) {
#pragma unroll
    for (int vn = 0; vn < NV; ++vn)
#pragma unroll
      for (int e = 0; e < 4; ++e) comb[4 * vn + e] = dq[vn][e];
  }
  __syncthreads();
  if (half) return;
#pragma unroll
  for (int vn = 0; vn < NV; ++vn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[vn][e] += comb[4 * vn + e];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + wrow + gq + 8 * hf;
    if (q >= g.L) continue;
    T* dst = static_cast<T*>(p.dqu) + ((size_t)b * g.L + q) * g.D + h * g.dh;
#pragma unroll
    for (int vn = 0; vn < NV; ++vn) {
      const int d = 8 * vn + 2 * t;
      if (d < g.dh)
        store2(dst + d, dq[vn][2 * hf], dq[vn][2 * hf + 1], d + 1 < g.dh);
    }
  }
}

struct KParams {
  const void *qu, *dout, *ds, *pd;
  void *dk, *dv;
  Geo g;
};

// acc[16 keys from kw][NV n-tiles] += x^T . y over 64 query rows: x the
// [row][key] tile of ds or p_drop, y the [row][d] tile of qu or dO, both
// read k-major. fp32 sums the tile from zero and adds it.
template <class T, int NV>
__device__ __forceinline__ void kt_product(float (&acc)[NV][4], const T* x,
                                           int ts, const T* y, int rs,
                                           int kw) {
  using M = Mma<T>;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4];
      M::a_km(a, x, ts, kw, kk);
#pragma unroll
      for (int vp = 0; vp < NV / 2; ++vp) {
        uint32_t bb[4];
        M::b_kn(bb, y, rs, 16 * vp, kk);
        M::mma2(acc[2 * vp], acc[2 * vp + 1], a, bb);
      }
    }
  } else {
    float part[NV][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      SplitA a;
      M::a_km(a, x, ts, kw, kk);
#pragma unroll
      for (int vn = 0; vn < NV; ++vn) {
        float b0, b1;
        M::b_kn(b0, b1, y, rs, 8 * vn, kk);
        mma3(part[vn], a, b0, b1);
      }
    }
    add_to(acc, part);
  }
}

// k_pass: one CTA per (64 keys, head, batch row), a warp per 16 keys:
// dk = ds^T . qu and dv = p_drop^T . dO over 64-row query tiles, the
// scratch tiles read k-major (ldmatrix.trans in bf16).
template <class T, int DVP>
__global__ void __launch_bounds__(THREADS)
k_pass(const __grid_constant__ KParams p) {
  constexpr int NV = DVP / 8;
  const Geo& g = p.g;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int ts = TK + g.pa, rs = g.dvp + g.pa;
  const int slot_elems = TK * ts + TK * rs;
  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const int lp = ds_stride(g.L), n_items = 2 * ((g.L + TK - 1) / TK);
  auto issue = [&](int i) {
    if (i < n_items) {
      T* slot = ring + (i % STAGES) * slot_elems;
      const int q0 = (i / 2) * TK;
      const T* src = static_cast<const T*>(i % 2 ? p.pd : p.ds);
      load_tile(slot, ts, src + (bh * g.L + q0) * lp + k0, lp, TK, g.L - q0,
                TK, lp - k0, g.vb);
      load_head_rows(g, slot + TK * ts, rs,
                     static_cast<const T*>(i % 2 ? p.dout : p.qu), b, h, q0,
                     TK);
    }
    cp_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  const int kw = 16 * (threadIdx.x / 32);
  float dk[NV][4], dv[NV][4];
  zero(dk);
  zero(dv);
  for (int i = 0; i < n_items; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const T* x = ring + (i % STAGES) * slot_elems;
    if (i % 2)
      kt_product<T, NV>(dv, x, ts, x + TK * ts, rs, kw);
    else
      kt_product<T, NV>(dk, x, ts, x + TK * ts, rs, kw);
  }
  const int l = lane_id(), gq = l >> 2, t = l & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + kw + gq + 8 * hf;
    if (key >= g.L) continue;
    const size_t row = ((size_t)b * g.L + key) * g.D + h * g.dh;
#pragma unroll
    for (int vn = 0; vn < NV; ++vn) {
      const int d = 8 * vn + 2 * t;
      if (d >= g.dh) continue;
      store2(static_cast<T*>(p.dk) + row + d, dk[vn][2 * hf],
             dk[vn][2 * hf + 1], d + 1 < g.dh);
      store2(static_cast<T*>(p.dv) + row + d, dv[vn][2 * hf],
             dv[vn][2 * hf + 1], d + 1 < g.dh);
    }
  }
}

struct AParams {
  const void *ds, *sin_t, *cos_t, *wh;
  void *da, *dqv;
  Geo g;
};

// Shared memory of one da_pass ring slot (elements) at `rows` query rows:
// a ds tile and a cos and a sin tile, or the sin and cos halves of wh[h]'s
// 64 columns.
__host__ __device__ inline size_t da_slot(const Geo& g, int rows) {
  const size_t keys =
      (size_t)rows * (TK + g.pa) + 2 * (size_t)TK * (TK + PB);
  const size_t w = 2 * (size_t)g.dvp * (TK + PB);
  return keys > w ? keys : w;
}

// da_pass's query rows per CTA: 128 (each warp on 16 rows and all 64
// columns x of a step) where the grid still has a CTA per SM and the ring
// fits, which halves the reads of the tables; else 64 (a pair of warps per
// 16 rows, each on 32 of the columns).
inline int da_rows(const Geo& g) {
  const long long ctas = (long long)((g.L + 127) / 128) * g.H * g.B;
  return ctas >= SMS && STAGES * da_slot(g, 128) * g.esz <= SMEM_LIMIT ? 128
                                                                       : 64;
}

// da_pass: one CTA per (128 or 64 query rows, head, batch row), eight
// warps of 16 rows, each on XN n-tiles (8: all, 4: half) of every 64
// coefficient columns x: dalpha | dbeta = ds . [cos | sin] over the key
// tiles, then da = T(rotation by the query row's sin, cos) to scratch and
// dqv += da . wh^T with da's fragments in registers (a pair's two halves
// of dqv added at the end).
template <class T, int DVP, int XN>
__global__ void __launch_bounds__(QTHREADS)
da_pass(const __grid_constant__ AParams p) {
  using M = Mma<T>;
  constexpr int NV = DVP / 8, ROWS = XN == 8 ? 128 : 64;
  const Geo& g = p.g;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int ts = TK + g.pa, cs = TK + PB;
  const int slot_elems = (int)da_slot(g, ROWS);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * g.H + h;
  const T* sin_t = static_cast<const T*>(p.sin_t);
  const T* cos_t = static_cast<const T*>(p.cos_t);
  const T* whh = static_cast<const T*>(p.wh) + (size_t)h * g.dh * g.Dp;
  const int lp = ds_stride(g.L), nkt = (g.L + TK - 1) / TK;
  const int nx = (g.d2p + TK - 1) / TK, n_items = nx * (nkt + 1);
  auto issue = [&](int i) {
    if (i < n_items) {
      T* slot = ring + (i % STAGES) * slot_elems;
      const int x0 = (i / (nkt + 1)) * TK, sub = i % (nkt + 1);
      if (sub < nkt) {
        const int j0 = sub * TK;
        load_tile(slot, ts,
                  static_cast<const T*>(p.ds) + (bh * g.L + q0) * lp + j0, lp,
                  ROWS, g.L - q0, TK, lp - j0, g.vb);
        T* tab = slot + ROWS * ts;
        load_tile(tab, cs, cos_t + (size_t)j0 * g.D2 + x0, g.D2, TK,
                  g.L - j0, TK, g.D2 - x0, g.vb);
        load_tile(tab + TK * cs, cs, sin_t + (size_t)j0 * g.D2 + x0, g.D2,
                  TK, g.L - j0, TK, g.D2 - x0, g.vb);
      } else {
        load_tile(slot, cs, whh + x0, g.Dp, g.dvp, g.dh, TK, g.D2 - x0, g.vb);
        load_tile(slot + g.dvp * cs, cs, whh + g.D2 + x0, g.Dp, g.dvp, g.dh,
                  TK, g.D2 - x0, g.vb);
      }
    }
    cp_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  const int warp = threadIdx.x / 32;
  const int wrow = XN == 8 ? 16 * warp : 16 * (warp >> 1);
  const int xh = XN == 8 ? 0 : 32 * (warp & 1);  // this warp's x columns
  const int l = lane_id(), gq = l >> 2, t = l & 3;
  float dal[XN][4], dbe[XN][4], dq[NV][4];
  zero(dq);
  for (int i = 0; i < n_items; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const T* slot = ring + (i % STAGES) * slot_elems;
    const int x0 = (i / (nkt + 1)) * TK, sub = i % (nkt + 1);
    if (sub == 0) {
      zero(dal);
      zero(dbe);
    }
    if (sub < nkt) {
      const T* ct = slot + ROWS * ts;
      const T* st = ct + TK * cs;
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16) {
          uint32_t a[4], bb[4];
          M::a_mk(a, slot, ts, wrow, kk);
#pragma unroll
          for (int np = 0; np < XN / 2; ++np) {
            M::b_kn(bb, ct, cs, xh + 16 * np, kk);
            M::mma2(dal[2 * np], dal[2 * np + 1], a, bb);
            M::b_kn(bb, st, cs, xh + 16 * np, kk);
            M::mma2(dbe[2 * np], dbe[2 * np + 1], a, bb);
          }
        }
      } else {
        float pa_[XN][4], pb_[XN][4];
        zero(pa_);
        zero(pb_);
#pragma unroll 2
        for (int kk = 0; kk < TK; kk += 8) {
          SplitA a;
          M::a_mk(a, slot, ts, wrow, kk);
#pragma unroll
          for (int nt = 0; nt < XN; ++nt) {
            float b0, b1;
            M::b_kn_nat(b0, b1, ct, cs, xh + 8 * nt, kk);
            mma3(pa_[nt], a, b0, b1);
            M::b_kn_nat(b0, b1, st, cs, xh + 8 * nt, kk);
            mma3(pb_[nt], a, b0, b1);
          }
        }
        add_to(dal, pa_);
        add_to(dbe, pb_);
      }
      continue;
    }
    // da_s = T(dalpha sin_q - dbeta cos_q), da_c = T(dalpha cos_q + dbeta
    // sin_q), into dal / dbe and to scratch
#pragma unroll
    for (int nt = 0; nt < XN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + wrow + gq + 8 * (e >> 1);
        const int x = x0 + xh + 8 * nt + 2 * t + (e & 1);
        float sq = 0.f, cq = 0.f;
        const bool in = q < g.L && x < g.D2;
        if (in) {
          sq = to_f(sin_t[(size_t)q * g.D2 + x]);
          cq = to_f(cos_t[(size_t)q * g.D2 + x]);
        }
        const float a_ = dal[nt][e], b_ = dbe[nt][e];
        dal[nt][e] = rnd<T>(__fsub_rn(__fmul_rn(a_, sq), __fmul_rn(b_, cq)));
        dbe[nt][e] = rnd<T>(__fadd_rn(__fmul_rn(a_, cq), __fmul_rn(b_, sq)));
        if (in) {
          T* dst = static_cast<T*>(p.da) + (bh * g.L + q) * g.Dp + x;
          dst[0] = from_f<T>(dal[nt][e]);
          dst[g.D2] = from_f<T>(dbe[nt][e]);
        }
      }
    const T* w_s = slot;
    const T* w_c = slot + g.dvp * cs;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < XN / 2; ++kk) {
        uint32_t a[4], bb[4];
        M::a_c(a, dal[2 * kk], dal[2 * kk + 1]);
#pragma unroll
        for (int vp = 0; vp < NV / 2; ++vp) {
          M::b_nk(bb, w_s, cs, 16 * vp, xh + 16 * kk);
          M::mma2(dq[2 * vp], dq[2 * vp + 1], a, bb);
        }
        M::a_c(a, dbe[2 * kk], dbe[2 * kk + 1]);
#pragma unroll
        for (int vp = 0; vp < NV / 2; ++vp) {
          M::b_nk(bb, w_c, cs, 16 * vp, xh + 16 * kk);
          M::mma2(dq[2 * vp], dq[2 * vp + 1], a, bb);
        }
      }
    } else {
      float part[NV][4];
      zero(part);
#pragma unroll
      for (int nt = 0; nt < XN; ++nt) {
        SplitA a;
        M::a_c(a, dal[nt]);
#pragma unroll
        for (int vn = 0; vn < NV; ++vn) {
          float b0, b1;
          M::b_nk_perm(b0, b1, w_s, cs, 8 * vn, xh + 8 * nt);
          mma3(part[vn], a, b0, b1);
        }
        M::a_c(a, dbe[nt]);
#pragma unroll
        for (int vn = 0; vn < NV; ++vn) {
          float b0, b1;
          M::b_nk_perm(b0, b1, w_c, cs, 8 * vn, xh + 8 * nt);
          mma3(part[vn], a, b0, b1);
        }
      }
      add_to(dq, part);
    }
  }
  if (XN == 4) {
    // the second half's dqv through shared memory (the ring, free now)
    float* comb =
        reinterpret_cast<float*>(ring) + ((warp >> 1) * 32 + l) * 4 * NV;
    __syncthreads();
    if (xh) {
#pragma unroll
      for (int vn = 0; vn < NV; ++vn)
#pragma unroll
        for (int e = 0; e < 4; ++e) comb[4 * vn + e] = dq[vn][e];
    }
    __syncthreads();
    if (xh) return;
#pragma unroll
    for (int vn = 0; vn < NV; ++vn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[vn][e] += comb[4 * vn + e];
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + wrow + gq + 8 * hf;
    if (q >= g.L) continue;
    T* dst = static_cast<T*>(p.dqv) + ((size_t)b * g.L + q) * g.D + h * g.dh;
#pragma unroll
    for (int vn = 0; vn < NV; ++vn) {
      const int d = 8 * vn + 2 * t;
      if (d < g.dh)
        store2(dst + d, dq[vn][2 * hf], dq[vn][2 * hf + 1], d + 1 < g.dh);
    }
  }
}

struct WParams {
  const void *qv, *da;
  float* part;
  Geo g;
  int splits;
};

// dwh_partial: one CTA per (64 columns of Dp, head, batch row x split), a
// warp per 16 columns: the partial qv^T . da over the split's 64-row
// tiles, both read k-major, to part[(b * splits + split), h] in fp32.
template <class T, int DVP>
__global__ void __launch_bounds__(THREADS)
dwh_partial(const __grid_constant__ WParams p) {
  using M = Mma<T>;
  constexpr int MT = DVP / 16;
  const Geo& g = p.g;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int qs = g.dvp + g.pa, ts = TK + g.pa;
  const int slot_elems = TK * qs + TK * ts;
  const int x0 = blockIdx.x * TK, h = blockIdx.y, z = blockIdx.z;
  const int b = z / p.splits, split = z % p.splits;
  const size_t bh = (size_t)b * g.H + h;
  const int nqt = (g.L + TK - 1) / TK, per = (nqt + p.splits - 1) / p.splits;
  const int t0 = split * per, n_items = max(0, min(nqt, t0 + per) - t0);
  auto issue = [&](int i) {
    if (i < n_items) {
      T* slot = ring + (i % STAGES) * slot_elems;
      const int q0 = (t0 + i) * TK;
      load_head_rows(g, slot, qs, static_cast<const T*>(p.qv), b, h, q0, TK);
      load_tile(slot + TK * qs, ts,
                static_cast<const T*>(p.da) + (bh * g.L + q0) * g.Dp + x0, g.Dp,
                TK, g.L - q0, TK, g.Dp - x0, g.vb);
    }
    cp_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  const int n0 = 16 * (threadIdx.x / 32);
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(acc[mt]);
  for (int i = 0; i < n_items; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const T* qvt = ring + (i % STAGES) * slot_elems;
    const T* dat = qvt + TK * qs;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        uint32_t bb[4];
        M::b_kn(bb, dat, ts, n0, kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          M::a_km(a, qvt, qs, 16 * mt, kk);
          M::mma2(acc[mt][0], acc[mt][1], a, bb);
        }
      }
    } else {
      float part[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero(part[mt]);
#pragma unroll 2
      for (int kk = 0; kk < TK; kk += 8) {
        float b[4];
        M::b_kn(b[0], b[1], dat, ts, n0, kk);
        M::b_kn(b[2], b[3], dat, ts, n0 + 8, kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          SplitA a;
          M::a_km(a, qvt, qs, 16 * mt, kk);
          mma3(part[mt][0], a, b[0], b[1]);
          mma3(part[mt][1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) add_to(acc[mt], part[mt]);
    }
  }
  const int l = lane_id(), gq = l >> 2, t = l & 3;
  float* out = p.part + ((size_t)z * g.H + h) * g.dh * g.Dp;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * mt + gq + 8 * (e >> 1);
        const int x = x0 + n0 + 8 * j + 2 * t + (e & 1);
        if (d < g.dh && x < g.Dp) out[(size_t)d * g.Dp + x] = acc[mt][j][e];
      }
}

// dwh = T(sum of the partials in order), one thread per element.
template <class T>
__global__ void dwh_reduce(const float* __restrict__ part, T* __restrict__ dwh,
                           size_t n, int n_parts) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int z = 0; z < n_parts; ++z) acc += part[(size_t)z * n + i];
  dwh[i] = from_f<T>(acc);
}

inline Geo plan(int B, int L, int H, int dh, int Dp, int esz) {
  Geo g = make_geo(B, L, H, dh, Dp, esz);
  g.rows = query_rows(g, true);
  g.stages = g.rows ? query_stages(g, g.rows, true) : 0;
  return g;
}

template <class K>
int set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class T, int DVP, bool DROP>
int run(const BwdArgs& a, const Geo& g, void* scratch, cudaStream_t stream) {
  Scratch s;
  scratch_layout(g, static_cast<char*>(scratch), &s);
  const int nqt = (g.L + TK - 1) / TK;
  int err;
  const size_t q_smem = query_smem(g, g.rows, g.stages, true);
  if ((err = set_smem(q_pass<T, DVP, DROP>, q_smem))) return err;
  const QParams qp{a.qu, a.qv, a.k, a.v, a.wh, a.sin_t, a.cos_t, a.dout,
                   a.lengths, a.stats, a.dqu, s.ds, s.pd, g, a.seed, a.thresh,
                   a.inv_keep, a.tq};
  q_pass<T, DVP, DROP><<<dim3((g.L + g.rows - 1) / g.rows, g.H, g.B),
                         g.rows * 4, q_smem, stream>>>(qp);
  if ((err = cudaGetLastError())) return err;

  const size_t k_smem =
      (size_t)STAGES * (TK * (TK + g.pa) + TK * (g.dvp + g.pa)) * g.esz;
  if ((err = set_smem(k_pass<T, DVP>, k_smem))) return err;
  k_pass<T, DVP><<<dim3(nqt, g.H, g.B), THREADS, k_smem, stream>>>(
      KParams{a.qu, a.dout, s.ds, s.pd, a.dk, a.dv, g});
  if ((err = cudaGetLastError())) return err;

  const int arows = da_rows(g);
  const size_t a_smem = (size_t)STAGES * da_slot(g, arows) * g.esz;
  const AParams ap{s.ds, a.sin_t, a.cos_t, a.wh, s.da, a.dqv, g};
  const dim3 a_grid((g.L + arows - 1) / arows, g.H, g.B);
  if (arows == 128) {
    if ((err = set_smem(da_pass<T, DVP, 8>, a_smem))) return err;
    da_pass<T, DVP, 8><<<a_grid, QTHREADS, a_smem, stream>>>(ap);
  } else {
    if ((err = set_smem(da_pass<T, DVP, 4>, a_smem))) return err;
    da_pass<T, DVP, 4><<<a_grid, QTHREADS, a_smem, stream>>>(ap);
  }
  if ((err = cudaGetLastError())) return err;

  const int splits = dwh_splits(g);
  const size_t w_smem =
      (size_t)STAGES * (TK * (g.dvp + g.pa) + TK * (TK + g.pa)) * g.esz;
  if ((err = set_smem(dwh_partial<T, DVP>, w_smem))) return err;
  dwh_partial<T, DVP><<<dim3((g.Dp + TK - 1) / TK, g.H, g.B * splits), THREADS,
                        w_smem, stream>>>(
      WParams{a.qv, s.da, s.part, g, splits});
  if ((err = cudaGetLastError())) return err;

  const size_t n = (size_t)g.H * g.dh * g.Dp;
  dwh_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      s.part, static_cast<T*>(a.dwh), n, g.B * splits);
  return cudaGetLastError();
}

template <class T, bool DROP>
int launch(const BwdArgs& a, void* scratch, cudaStream_t stream) {
  const Geo g = plan(a.B, a.L, a.H, a.dh, a.Dp, sizeof(T));
  if (g.rows == 0) return cudaErrorInvalidValue;
  switch (g.dvp) {
    case 16: return run<T, 16, DROP>(a, g, scratch, stream);
    case 32: return run<T, 32, DROP>(a, g, scratch, stream);
    case 64: return run<T, 64, DROP>(a, g, scratch, stream);
    case 128: return run<T, 128, DROP>(a, g, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace general

}  // namespace

extern "C" const char* sincos_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernels of sincos_attention_bwd, as in the forward: 0 the bf16 wgmma
// kernels (namespace hopper; dh 64, Dp/2 a multiple of 64, Dp <= 512), 1
// the general ones.
enum Variant { WGMMA = 0, GENERAL = 1 };

// Bytes of device scratch sincos_attention_bwd needs for these shapes
// (dtype 0 float32, 1 bfloat16).
extern "C" long long sincos_attention_bwd_scratch_bytes(int B, int L, int H,
                                                        int dh, int Dp,
                                                        int dtype,
                                                        int variant) {
  if (variant == GENERAL)
    return (long long)general::scratch_layout(
        attn::gen::make_geo(B, L, H, dh, Dp, dtype == 0 ? 4 : 2), nullptr,
        nullptr);
  return (long long)hopper::scratch_layout(B, L, H, Dp, nullptr, nullptr);
}

// qu, qv, k, v, dout, dqu, dqv, dk, dv: (B, L, H*dh); wh, dwh:
// (H, dh, Dp); sin_t, cos_t: (L, Dp/2) (Dp = H*dh on one device); all of
// one dtype (0 = float32,
// 1 = bfloat16), contiguous, 16-byte aligned, on the current device.
// lengths: (B,) int32; stats: (B, H, L, 2) float32 from the forward;
// scratch: sincos_attention_bwd_scratch_bytes bytes. Dropout as in the
// forward (thresh 0: none). variant: WGMMA (bfloat16 only) or GENERAL
// (dh <= 128). Returns a cudaError_t.
extern "C" int sincos_attention_bwd(
    const void* qu, const void* qv, const void* k, const void* v,
    const void* wh, const void* sin_t, const void* cos_t, const void* lengths,
    const void* stats, const void* dout, void* dqu,
    void* dqv, void* dk, void* dv, void* dwh, void* scratch, int B, int L,
    int H, int dh, int Dp, int dtype, int variant, uint32_t seed,
    uint32_t thresh, float inv_keep, int tq, void* stream) {
  const BwdArgs a{qu, qv, k, v, wh, sin_t, cos_t,
                  static_cast<const int*>(lengths),
                  static_cast<const float*>(stats), dout, dqu, dqv, dk, dv,
                  dwh, B, L, H, dh, Dp, seed, thresh, inv_keep, tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  if (variant == WGMMA) {
    if (dtype != 1 || dh != DH) return cudaErrorInvalidValue;
    return drop ? hopper::launch<true>(a, scratch, s)
                : hopper::launch<false>(a, scratch, s);
  }
  if (variant != GENERAL || attn::gen::padded_head(dh) == 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return drop ? general::launch<float, true>(a, scratch, s)
                : general::launch<float, false>(a, scratch, s);
  if (dtype == 1)
    return drop ? general::launch<bf16, true>(a, scratch, s)
                : general::launch<bf16, false>(a, scratch, s);
  return cudaErrorInvalidValue;
}
