// A key pass for K2 that recomputes the scores instead of reading the
// materialised ds and p_drop: the "recompute_k" variant of
// tools/probe_attention_bwd.py, which splices this text into a copy of
// csrc/sincos_attention_bwd.cu (namespace hopper) and launches it in place
// of k_pass. The port never builds it.
//
// One CTA per (128 keys, head, batch row), two consumer warpgroups of 64
// keys and a producer warpgroup, q_pass's layout transposed: the key tile
// [k | cos | sin] (128 x 576) stays in swizzled panels, and per 64-query
// tile the ring streams qu and alpha | beta (the query side of the scores,
// which q_pass keeps for this pass in the p_drop region of the scratch),
// then [qu | dO]. s^T = [k | cos | sin] . [qu | alpha | beta]^T and
// dov^T = v . dO^T (v's fragments in registers) give p^T, ds^T and
// p_drop^T with each query's K1 statistics and q_pass's delta (in the da
// region), and dk += ds^T . qu, dv += p_drop^T . dO from registers.

struct RMaps {
  CUtensorMap k, cos_t, sin_t;  // BN-row boxes, as q_pass's
  CUtensorMap qu, dout;         // (B, L, D), 64-row boxes
  CUtensorMap ab;               // (B*H, L, D) alpha | beta, 64-row boxes
};

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
k_pass_recompute(const __grid_constant__ RMaps maps, const BwdArgs a,
                 const float* __restrict__ delta) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int L = a.L, H = a.H, D = H * DH, D2 = D / 2, n_half = D2 / 64;
  const int n_chunks = 1 + D / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * Q_STAGES + 1];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_tile = (raw + 1023u) & ~1023u;
  const uint32_t ring = k_tile + n_chunks * PANEL;
  const uint32_t full = smem_u32(bars), empty = full + 8 * Q_STAGES,
                 k_full = full + 16 * Q_STAGES;
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  const size_t bh = (size_t)b * H + h;
  if (tid == 0) {
    init_ring(full, empty, Q_STAGES, 4 * CONSUMERS);
    bar_init(k_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      bar_expect(k_full, n_chunks * PANEL);
      tma_3d(k_tile, &maps.k, k_full, h * DH, k0, b);
      for (int c = 0; c < 2 * n_half; ++c)
        tma_2d(k_tile + (1 + c) * PANEL, c < n_half ? &maps.cos_t : &maps.sin_t,
               k_full, (c % n_half) * 64, k0);
      QRing r;
      for (int q0 = 0; q0 < L; q0 += 64) {
        uint2 st = claim(r, full, empty, ring, BOX);
        tma_3d(st.x, &maps.qu, st.y, h * DH, q0, b);
        r.next();
        for (int c = 0; c < D / 64; ++c) {
          st = claim(r, full, empty, ring, BOX);
          tma_3d(st.x, &maps.ab, st.y, c * 64, q0, (int)bh);
          r.next();
        }
        st = claim(r, full, empty, ring, STAGE);
        tma_3d(st.x, &maps.qu, st.y, h * DH, q0, b);
        tma_3d(st.x + BOX, &maps.dout, st.y, h * DH, q0, b);
        r.next();
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r_lo = 16 * ((tid % 128) / 32) + g;  // key rows r_lo, r_lo + 8
    const int kw = k0 + wg * 64;                   // this warpgroup's first key
    const bf16* v = static_cast<const bf16*>(a.v);
    uint32_t vf[4][4];  // v of the warp's 16 keys as A fragments (k = d)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kw + r_lo + 8 * (i % 2);
        vf[kk][i] = key < L ? ld32(v + ((size_t)b * L + key) * D + h * DH +
                                   16 * kk + 8 * (i / 2) + 2 * t)
                            : 0u;
      }
    const int len = min(a.lengths[b], L);
    const uint32_t k_rows = k_tile + wg * 64 * 128;
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    fence_acc(dk);
    fence_acc(dv);
    bar_wait(k_full, 0);
    QRing r;
    int st;
    for (int q0 = 0; q0 < L; q0 += 64) {
      float s[32], dov[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dov[i] = 0.f;
      fence_acc(s);
      fence_acc(dov);
      int prev = -1;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const uint32_t qt = take(r, full, ring, st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(s, desc_k(k_rows + ch * PANEL + 32 * kk), desc_k(qt + 32 * kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(empty, prev);
        }
        prev = st;
      }
      const uint32_t ot = take(r, full, ring, st);  // [qu | dO]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(dov, vf[kk], desc_k(ot + BOX + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      release(empty, prev);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dov);
      // rows are keys, columns queries: each column's statistics
      uint32_t dsa[4][4], pda[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float m[2], il[2], dl[2];
        uint32_t rh[2] = {0u, 0u};
        bool okq[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + 2 * t + e;
          okq[e] = q < L;
          m[e] = okq[e] ? a.stats[(bh * L + q) * 2] : 0.f;
          il[e] = okq[e] ? 1.f / fmaxf(a.stats[(bh * L + q) * 2 + 1], 1e-9f) : 0.f;
          dl[e] = okq[e] ? delta[bh * L + q] : 0.f;
          if (DROP) rh[e] = row_hash(a.seed, b, h, q, a.tq);
        }
        float dsv[4], pdv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i % 2, key = kw + r_lo + 8 * (i / 2);
          const float sc = mask_score(s[4 * j + i], key, len, L);
          const float p = okq[e] ? exp2_approx((sc - m[e]) * LOG2E) * il[e] : 0.f;
          float dp = dov[4 * j + i], pd = p;
          if (DROP) {
            const bool kp = keep(rh[e], key, a.thresh);
            dp = kp ? dp * a.inv_keep : 0.f;
            pd = kp ? p * a.inv_keep : 0.f;
          }
          dsv[i] = p * (dp - dl[e]);
          pdv[i] = pd;
        }
        dsa[j / 2][2 * (j % 2)] = pack(dsv[0], dsv[1]);
        dsa[j / 2][2 * (j % 2) + 1] = pack(dsv[2], dsv[3]);
        pda[j / 2][2 * (j % 2)] = pack(pdv[0], pdv[1]);
        pda[j / 2][2 * (j % 2) + 1] = pack(pdv[2], pdv[3]);
      }
      fence_acc(dk);
      fence_acc(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, dsa[kk], desc_mn(ot + 2048 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dv, pda[kk], desc_mn(ot + BOX + 2048 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      release(empty, st);
    }
    bf16* dk_out = static_cast<bf16*>(a.dk);
    bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = kw + r_lo + 8 * hf;
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

