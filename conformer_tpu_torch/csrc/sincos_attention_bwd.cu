// Fused shift-free relative-position attention, backward (K2), for Hopper
// (sm_90a).
//
// Replaces: conformer_tpu/ops/pallas/sincos_attention.py::_bwd_kernel,
// reached through _bwd_call and the custom VJP _fused. Packed (B, L, D)
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
// takes the general kernels (namespace general): CUDA-core FMAs, so fp32
// inputs keep fp32 products, in a simpler design that materialises ds and
// p_drop (B, H, L, L) in fp32 scratch: prep (alpha | beta, shared with the
// forward), scores (p and dp per 64 x 64 tile over the virtual depth
// [qu | alpha | beta] . [k | cos | sin] and dO . v^T, both in 64-deep
// chunks whatever dh and D are), rows (delta per row, then ds and p_drop in
// place, rounded to T), then every contraction as a launch of one strided
// batched GEMM that reads T or fp32 operands and stores T or fp32, and
// combine (da, rounded to T). The scratch is fp32 in both dtypes and sized
// by the same layout function the host asks for
// (sincos_attention_bwd_scratch_bytes). At B 3, L 199, bf16, rate 0.1 it
// takes 0.224 ms at (H, dh) = (2, 32) and 1.009 ms at (12, 64) on an H100
// 80GB HBM3 at 700 W; fp32 at production width (B 8, L 599) 5.35 ms.

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
  int B, L, H, dh;
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
  CUtensorMap wh;             // (H*64, D), 64-row boxes
  CUtensorMap cos_t, sin_t;   // (L, D/2), BN-row boxes
};
struct KMaps {                // k_pass
  CUtensorMap ds, pd;         // (B*H, L, L) scratch, 64-row boxes
  CUtensorMap qu, dout;       // (B, L, D), 64-row boxes
};
struct AMaps {                // da_pass
  CUtensorMap ds;             // (B*H, L, L), 64-row boxes
  CUtensorMap cos_t, sin_t;   // (L, D/2), 64-row boxes
  CUtensorMap wh;             // (H*64, D), 64-row boxes
};
struct WMaps {                // dwh_pass
  CUtensorMap qv;             // (B, L, D), 64-row boxes
  CUtensorMap da;             // (B*H, L, D) scratch, 64-row boxes
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
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2, n_half = D2 / 64;
  const bf16* sin_t = static_cast<const bf16*>(a.sin_t);
  const bf16* cos_t = static_cast<const bf16*>(a.cos_t);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * Q_STAGES + 1];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_tile = (raw + 1023u) & ~1023u;
  uint8_t* q_ptr = smem_raw + (q_tile - raw);
  const uint32_t ring = q_tile + (1 + D / 64) * PANEL;
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
    const int n_chunks = 1 + D / 64;
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
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2, n_half = D2 / 64;
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
            bf16* dst = da_out + ((size_t)bh * L + q) * D + x;
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

// One CTA per (64 columns of D, head): dwh[h][:, cols] = sum over batch
// rows and 64-query tiles, in that fixed order, of qv_h^T . da (qv read
// MN-major as A, da MN-major as B), one consumer warpgroup.
constexpr int W_THREADS = 256;

__global__ void __launch_bounds__(W_THREADS, 1)
dwh_pass(const __grid_constant__ WMaps maps, const BwdArgs a) {
  const int L = a.L, H = a.H, D = H * DH;
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
      bf16* dst = dwh + ((size_t)h * DH + r_lo + 8 * hf) * D + x0 + 2 * t;
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
// da (B*H, L, D).
inline size_t scratch_layout(int B, int L, int H, char* base, Scratch* s) {
  const size_t rows = (size_t)B * H * L;
  const size_t n_sq = align256(sizeof(bf16) * rows * padded_len(L));
  const size_t n_da = align256(sizeof(bf16) * rows * H * DH);
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
  const int B = a.B, L = a.L, H = a.H, D = H * DH, D2 = D / 2, LP = padded_len(L);
  // qv (stage 0) and every wh chunk pair are in q_pass's ring before stage
  // 0 is released: 1 + D/128 <= Q_STAGES.
  if (1 + D / 128 > Q_STAGES || D2 % 64 != 0) return cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Scratch s;
  scratch_layout(B, L, H, static_cast<char*>(scratch), &s);
  const cuuint64_t packed[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t packed_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint64_t wh_dims[2] = {(cuuint64_t)D, (cuuint64_t)H * DH};
  const cuuint64_t wh_strides[1] = {(cuuint64_t)D * 2};
  const cuuint64_t tab[2] = {(cuuint64_t)D2, (cuuint64_t)L};
  const cuuint64_t tab_strides[1] = {(cuuint64_t)D2 * 2};
  const cuuint64_t sq[3] = {(cuuint64_t)L, (cuuint64_t)L, (cuuint64_t)B * H};
  const cuuint64_t sq_strides[2] = {(cuuint64_t)LP * 2, (cuuint64_t)L * LP * 2};
  const cuuint64_t da_dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B * H};
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
        encode(fn, &wm.da, s.da, 3, da_dims, packed_strides, 64)))
    return cudaErrorInvalidValue;
  am.ds = km.ds;
  am.wh = qm.wh;
  wm.qv = qm.qv;
  const size_t smem_q = 1024 + (size_t)(1 + D / 64) * PANEL + (size_t)Q_STAGES * STAGE;
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
  dwh_pass<<<dim3(D / 64, H), W_THREADS, smem_r, stream>>>(wm, a);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// The general kernels: every (H, dh, D) and both dtypes, CUDA-core FMAs,
// ds and p_drop materialised in fp32 scratch.
// ---------------------------------------------------------------------------

namespace general {

using namespace attn::fma_tiles;

// One 64 x 64 (query, key) tile: scores over the virtual depth -> p (to
// p_out) and dp (to dp_out); the chunks past the score depth take dO . v^T
// over dh.
template <class T, bool DROP>
__global__ void __launch_bounds__(THREADS)
scores(BwdArgs a, const float* __restrict__ ab, float* __restrict__ dp_out,
       float* __restrict__ p_out) {
  const int L = a.L, H = a.H, dh = a.dh, D = H * dh, D2 = D / 2, E = dh + D;
  __shared__ float s_q[64 * SP], s_k[64 * SP];
  const T* qu = static_cast<const T*>(a.qu);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* sin_t = static_cast<const T*>(a.sin_t);
  const T* cos_t = static_cast<const T*>(a.cos_t);
  const T* dout = static_cast<const T*>(a.dout);
  const int k0 = blockIdx.x * TK, q0 = blockIdx.y * TQ;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * L, bh = (size_t)b * H + h;
  const int col_h = h * dh;
  const float* abh = ab + bh * L * D;
  const int n_e = (E + 63) / 64, n_v = (dh + 63) / 64;

  float s[4][4], dov[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dov[r][c] = 0.f;
  for (int ch = 0; ch < n_e + n_v; ++ch) {
    __syncthreads();
    for (int i = tid; i < 64 * 64; i += THREADS) {
      const int j = i / 64, x = i % 64, q = q0 + j, key = k0 + j;
      float xq = 0.f, xk = 0.f;
      if (ch < n_e) {
        const int e = ch * 64 + x;
        if (q < L && e < E)
          xq = query_elem(qu + (row0 + q) * D + col_h, abh + (size_t)q * D, e,
                          dh);
        if (key < L && e < E)
          xk = key_elem(k + (row0 + key) * D + col_h, cos_t, sin_t, key, e, dh,
                        D2);
      } else {
        const int d = (ch - n_e) * 64 + x;
        if (q < L && d < dh) xq = ld(dout, (row0 + q) * D + col_h + d);
        if (key < L && d < dh) xk = ld(v, (row0 + key) * D + col_h + d);
      }
      s_q[x * SP + j] = xq;
      s_k[x * SP + j] = xk;
    }
    __syncthreads();
    if (ch < n_e)
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
// dp in a fixed order, then in place ds = T(p . (dp - delta)) over dp and
// p_drop = T(keep . p / (1 - rate)) over p.
template <class T, bool DROP>
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
    dsr[j] = rnd<T>(p * (dsr[j] - delta));
    pdr[j] = rnd<T>(DROP ? (keep(rh, j, a.thresh) ? p * a.inv_keep : 0.f) : p);
  }
}

// C[z] (M x N) = A[z] (M x K) . B[z] (K x N), any strides; batch z has the
// offset (z / zdiv) * s0 + (z % zdiv) * s1 in each operand. Operands are
// read as TA and TB, sums are fp32, C is stored as TC.
template <class TA, class TB, class TC>
struct Gemm {
  const TA* A;
  const TB* B;
  TC* C;
  int M, N, K, zdiv;
  long long a_m, a_k, a_z0, a_z1, b_k, b_n, b_z0, b_z1, c_m, c_n, c_z0, c_z1;
};

template <class TA, class TB, class TC>
__global__ void __launch_bounds__(THREADS) gemm(Gemm<TA, TB, TC> g) {
  __shared__ float As[16][65], Bs[16][65];
  const int z = blockIdx.z, zb = z / g.zdiv, zh = z % g.zdiv;
  const TA* A = g.A + zb * g.a_z0 + zh * g.a_z1;
  const TB* B = g.B + zb * g.b_z0 + zh * g.b_z1;
  TC* C = g.C + zb * g.c_z0 + zh * g.c_z1;
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
                       ? ld(A, (m0 + mm) * g.a_m + kg * g.a_k) : 0.f;
      Bs[kk][mm] = (n0 + mm < g.N && kg < g.K)
                       ? ld(B, kg * g.b_k + (n0 + mm) * g.b_n) : 0.f;
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
      if (n < g.N) st(C, m * g.c_m + n * g.c_n, acc[r][c]);
    }
  }
}

template <class TA, class TB, class TC>
int run_gemm(const Gemm<TA, TB, TC>& g, int Z, cudaStream_t stream) {
  gemm<TA, TB, TC><<<dim3((g.N + 63) / 64, (g.M + 63) / 64, Z), THREADS, 0,
                     stream>>>(g);
  return cudaGetLastError();
}

// da (H, B, L, D) = T([dalpha . sin_q - dbeta . cos_q | dalpha . cos_q +
// dbeta . sin_q]), fp32.
template <class T>
__global__ void combine(const float* __restrict__ dab, const T* __restrict__ sin_t,
                        const T* __restrict__ cos_t, float* __restrict__ da,
                        int B, int H, int L, int D2) {
  const size_t n = (size_t)B * H * L * D2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = idx % D2;
  const size_t row = idx / D2;  // (b * H + h) * L + i
  const int i = row % L, h = (row / L) % H, b = row / ((size_t)L * H);
  const float dal = dab[row * 2 * D2 + c], dbe = dab[row * 2 * D2 + D2 + c];
  const float sq = ld(sin_t, (size_t)i * D2 + c), cq = ld(cos_t, (size_t)i * D2 + c);
  float* dst = da + (((size_t)h * B + b) * L + i) * 2 * D2;
  dst[c] = rnd<T>(dal * sq - dbe * cq);
  dst[D2 + c] = rnd<T>(dal * cq + dbe * sq);
}

struct Scratch {
  float *ab, *ds, *pd, *dab, *da;
};

// alpha | beta, ds, p_drop, dalpha | dbeta and da, all fp32 whatever the
// input dtype: (B*H, L, D), (B*H, L, L) twice, (B*H, L, D) twice.
inline size_t scratch_layout(int B, int L, int H, int dh, char* base,
                             Scratch* s) {
  const size_t D = (size_t)H * dh, rows = (size_t)B * H * L;
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

template <class T, bool DROP>
int launch(const BwdArgs& a, void* scratch, cudaStream_t stream) {
  Scratch s;
  const int B = a.B, L = a.L, H = a.H, dh = a.dh, D = H * dh, D2 = D / 2;
  scratch_layout(B, L, H, dh, static_cast<char*>(scratch), &s);
  const int nq = (L + TQ - 1) / TQ, nk = (L + TK - 1) / TK;
  const long long LD = (long long)L * D, LL = (long long)L * L;
  const T* qu = static_cast<const T*>(a.qu);
  const T* qv = static_cast<const T*>(a.qv);
  const T* k = static_cast<const T*>(a.k);
  const T* dout = static_cast<const T*>(a.dout);
  const T* wh = static_cast<const T*>(a.wh);
  const T* sin_t = static_cast<const T*>(a.sin_t);
  const T* cos_t = static_cast<const T*>(a.cos_t);
  int err = cudaFuncSetAttribute(
      prep<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PREP_SMEM);
  if (err) return err;
  prep<T><<<dim3(nq, H, B), THREADS, PREP_SMEM, stream>>>(qv, wh, sin_t, cos_t,
                                                          s.ab, L, H, dh);
  if ((err = cudaGetLastError())) return err;
  scores<T, DROP><<<dim3(nk, nq, B * H), THREADS, 0, stream>>>(a, s.ab, s.ds,
                                                               s.pd);
  if ((err = cudaGetLastError())) return err;
  const size_t n_rows = (size_t)B * H * L;
  rows<T, DROP><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(a, s.ds, s.pd);
  if ((err = cudaGetLastError())) return err;
  using GT = Gemm<float, T, T>;
  // batch z = b * H + h over (B, H, L, L) scratch and packed (B, L, D) operands
  const long long HLL = H * LL;
  // dqu = ds . k
  if ((err = run_gemm(GT{s.ds, k, static_cast<T*>(a.dqu), L, dh, L, H,
                         L, 1, HLL, LL, D, 1, LD, dh, D, 1, LD, dh}, B * H, stream)))
    return err;
  // dk = ds^T . qu
  if ((err = run_gemm(GT{s.ds, qu, static_cast<T*>(a.dk), L, dh, L, H,
                         1, L, HLL, LL, D, 1, LD, dh, D, 1, LD, dh}, B * H, stream)))
    return err;
  // dv = p_drop^T . dO
  if ((err = run_gemm(GT{s.pd, dout, static_cast<T*>(a.dv), L, dh, L, H,
                         1, L, HLL, LL, D, 1, LD, dh, D, 1, LD, dh}, B * H, stream)))
    return err;
  // [dalpha | dbeta] (B, H, L, D) = ds . cos | ds . sin
  using GF = Gemm<float, T, float>;
  if ((err = run_gemm(GF{s.ds, cos_t, s.dab, L, D2, L, H,
                         L, 1, HLL, LL, D2, 1, 0, 0, D, 1, H * LD, LD}, B * H, stream)))
    return err;
  if ((err = run_gemm(GF{s.ds, sin_t, s.dab + D2, L, D2, L, H,
                         L, 1, HLL, LL, D2, 1, 0, 0, D, 1, H * LD, LD}, B * H, stream)))
    return err;
  const size_t n = (size_t)B * H * L * D2;
  combine<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(s.dab, sin_t, cos_t,
                                                              s.da, B, H, L, D2);
  if ((err = cudaGetLastError())) return err;
  // dqv = da . wh^T  (da is (H, B, L, D))
  if ((err = run_gemm(GT{s.da, wh, static_cast<T*>(a.dqv), L, dh, D, H,
                         D, 1, LD, B * LD, 1, D, 0, (long long)dh * D,
                         D, 1, LD, dh}, B * H, stream)))
    return err;
  // dwh[h] = qv^T . da[h], the sum over (batch row, query row) as one depth
  return run_gemm(Gemm<T, float, T>{qv, s.da, static_cast<T*>(a.dwh), dh, D,
                                    B * L, 1, 1, D, dh, 0, D, 1, B * LD, 0, D,
                                    1, (long long)dh * D, 0},
                  H, stream);
}

}  // namespace general

}  // namespace

extern "C" const char* sincos_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernels of sincos_attention_bwd, as in the forward: 0 the bf16 wgmma
// kernels (namespace hopper; dh 64, D/2 a multiple of 64, D <= 512), 1 the
// general ones.
enum Variant { WGMMA = 0, GENERAL = 1 };

// Bytes of device scratch sincos_attention_bwd needs for these shapes.
extern "C" long long sincos_attention_bwd_scratch_bytes(int B, int L, int H,
                                                        int dh, int variant) {
  if (variant == GENERAL)
    return (long long)general::scratch_layout(B, L, H, dh, nullptr, nullptr);
  return (long long)hopper::scratch_layout(B, L, H, nullptr, nullptr);
}

// qu, qv, k, v, dout, dqu, dqv, dk, dv: (B, L, H*dh); wh, dwh:
// (H, dh, H*dh); sin_t, cos_t: (L, H*dh/2); all of one dtype (0 = float32,
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
    int H, int dh, int dtype, int variant, uint32_t seed, uint32_t thresh,
    float inv_keep, int tq, void* stream) {
  const BwdArgs a{qu, qv, k, v, wh, sin_t, cos_t,
                  static_cast<const int*>(lengths),
                  static_cast<const float*>(stats), dout, dqu, dqv, dk, dv,
                  dwh, B, L, H, dh, seed, thresh, inv_keep, tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  if (variant == WGMMA) {
    if (dtype != 1 || dh != DH) return cudaErrorInvalidValue;
    return drop ? hopper::launch<true>(a, scratch, s)
                : hopper::launch<false>(a, scratch, s);
  }
  if (variant != GENERAL || general::padded_head(dh) == 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return drop ? general::launch<float, true>(a, scratch, s)
                : general::launch<float, false>(a, scratch, s);
  if (dtype == 1)
    return drop ? general::launch<bf16, true>(a, scratch, s)
                : general::launch<bf16, false>(a, scratch, s);
  return cudaErrorInvalidValue;
}
