// Depthwise same-pad conv1d for Hopper (sm_90a): the forward K4a (also the
// input gradient, with flipped taps) and the weight gradient K4b.
//
// Replaces: conformer_tpu/ops/pallas/depthwise_conv.py::_kernel (K4a, reached
// through _pallas_depthwise) and ::_dw_kernel (K4b, through _pallas_dw).
// Same functions, x (B, L, C) channels-last, w (K, C), bias (C,):
//   K4a: out[b, i, c] = bias[c] + sum_k x[b, i + k - pad, c] * w[k, c],
//        x read as 0 outside [0, L), taps added in order k = 0..K-1;
//   K4b: dw[k, c] = sum_{b, i} x[b, i + k - pad, c] * g[b, i, c], in fp32.
//
// What bounds them on the H100: bytes. K4a does 2*K FLOPs per output
// element on 2 input bytes (bf16) and 2 output bytes: ~15 FLOP/byte at K 31,
// under the fp32 machine balance (67 TFLOP/s over 3.35 TB/s = 20). It reads
// x once and writes out once. K4b reads x and g once and writes K*C floats.
//
// Rounding. K4a is bit for bit its plain version and the Pallas kernel run
// in interpret mode: it starts from the bias and adds the taps in order; in
// bf16 it rounds to bf16 after every product and every add (a product of two
// bf16 values is exact in fp32, so that is the bf16 product); in fp32 it uses
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA.
//
// Design. K4a has two kernels; the wrapper picks one from (K, C, dtype).
// - The window kernel, at K = 31 (the production conv) with C a multiple of
//   8 (bf16) or 4 (fp32), K a template parameter: one CTA per (64 frames,
//   128 bytes of channels, batch row), eight warps of 8 frames each. The
//   CTA copies its (64 + K - 1)-row halo of x into shared memory with
//   16-byte loads, zero outside [0, L) (a warp's load is four 128-byte row
//   pieces, against 64 bytes of one row with 2-byte loads). Each thread owns 4
//   bytes of channels (a bf16 pair or one fp32 channel): it loads its K taps
//   and its FPT + K - 1 input rows into registers once and reuses them
//   across the K taps (31 x 8 shared-memory reads a thread before, 38 now).
//   In bf16 each tap is mul.rn.bf16x2 then add.rn.bf16x2 through inline
//   PTX: two channels per instruction, no conversions, and no contraction
//   into an fma (each is one instruction nvcc cannot see into). That is
//   the same result bit for bit: the product of two bf16 values is exact in
//   fp32 (16 significant bits), so bf16(fp32(x*w)) = bf16(x*w), and for the
//   add, rounding to fp32 (24 bits) and then to bf16 (8) equals one
//   rounding to bf16 because 24 >= 2*8 + 2. Both bounds hold for bf16
//   subnormals too: they share fp32's exponent range, a subnormal sum of two
//   bf16 values is exact in both, and an inexact fp32 product lies below
//   2^-134, half bf16's smallest step, so either way it rounds to 0. In
//   fp32 each tap stays __fmul_rn then __fadd_rn. 640 CTAs at B 8, L 599,
//   C 512 in bf16 (1280 in fp32), several per SM. There, on an H100 80GB
//   HBM3 at 700 W: 0.0090 ms in bf16, 3.1x its byte bound (the runtime-K
//   kernel takes 0.0476), and 0.0142 ms in fp32 (0.0185).
// - The runtime-K kernel, for every other K (7 in ModelConfig.tiny, 4 in
//   the even-K dx check) and C: one CTA per (TL frames, TC channels, batch
//   row). It stages its (TL + K - 1, TC) halo of x in shared memory, zero
//   outside [0, L), with the (K, TC) taps beside it; each thread owns one
//   channel and FPT consecutive frames, so a tap's weight is read once for
//   FPT products and a warp reads 32 consecutive channels of one row.
// Neither has a length limit: the halo is 64 + K - 1 rows whatever L is.
//
// K4b: the TPU kernel carries the sum across its sequential batch grid.
// What bounds it here: the bytes (x and g read once, 2 * B * L * C
// elements) take under 3 us at B 8, L 599, C 512 in bf16, and the 2 * K
// multiply-adds an element about as long on the fp32 pipes, twice that on
// the fp64 pipes; measured, issuing the multiply-adds, shared-memory loads
// and conversions bounds it, over a fixed ~5 us of launch, clusters and
// final sums (tools/probe_depthwise_dw.py). There, on an H100 80GB HBM3
// at 700 W, the window kernel below takes 0.0173 ms in bf16 and 0.0176 in
// fp32 (the partial-and-reduce design it replaced at K 31: 0.0303 in
// both; fp32 sums in place of the fp64 ones: 0.0125). Two kernels, picked
// by the wrapper from (K, C, dtype) as K4a's are:
// - The window kernel, at K = 31 with C a multiple of 8 (bf16) or 4
//   (fp32), K a template parameter. The grid is (C / 32 channel slices) x
//   `splits` CTAs, and the CTAs of a slice are one thread-block cluster;
//   each takes 1 / splits of the B * L frames, flattened over (batch row,
//   frame) and walked a row segment at a time, so the split does not depend
//   on B. A CTA asks for more than half an SM's shared memory, so that no
//   two share an SM (two on one SM take twice as long, measured), and a
//   cluster's CTAs share a GPC: an H100 holds 15 clusters of 8 of them at
//   once, so at C 512 (16 slices) `splits` is the most CTAs a slice (at
//   most 8) for which every cluster fits at once: 6, 96 CTAs in one wave
//   (3 from C 1024, 1 at C 2400).
//   A producer warp has TMA copy 128-frame tiles of g and their
//   (128 + K - 1)-row halo of x, boxes of 32 channels in the input dtype
//   (zero outside [0, L) and past C), into a ring of 4 stages in bf16
//   (18 KB each) or 3 in fp32 (36 KB), full and empty mbarriers a stage;
//   16-byte cp.async copies by every thread did not overlap the sums
//   (measured: the two times added up). 8 consumer warps take 16 frames of
//   a tile each: a lane owns one channel, loads its 16 g values (zero past
//   the CTA's frames) into registers and walks the 16 + K - 1 x values of
//   its window, each met with the g values of the taps it reaches: 62
//   shared-memory reads for 496 multiply-adds (the runtime-K kernel reads 2
//   a multiply-add). Every product is taken in fp64, where it is exact for
//   bf16 and fp32 inputs, and added to an fp64 sum that stays in registers
//   across tiles; the CTA sums its warps' in fp64 through shared memory in
//   warp order, and the cluster its CTAs' in fp64 through distributed
//   shared memory in rank order, each CTA writing its share of the slice's
//   (K, 32) outputs, rounded once to fp32. One launch, no scratch, no
//   atomics: every run gives the same bits. The sums are that accurate
//   because the check holds each output to one bf16 ulp of the exact sum:
//   fp32 sums missed that on outputs near zero, by up to 6 ulps for a
//   running sum over a warp's frames and by 5 for 16-product sums added
//   in fp64 (measured, the latter at C 1536 in fp32).
// - The runtime-K kernel, for every other K (7 in ModelConfig.tiny, 4 in
//   the even-K check) and C: a first kernel writes one fp64 partial per
//   (batch row, 64-frame tile) for each (tap, channel) from the halo tile
//   staged in fp64 as K4a's runtime-K kernel stages it in fp32, and a
//   second sums the partials in fp64 in a fixed order: no atomics, the
//   same result on every run.
// Products of bf16 values are exact in fp32, of fp32 values in fp64.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TL = 64;               // frames per CTA
constexpr int TC = 32;               // channels per CTA (one warp wide)
constexpr int ROWS = 8;              // warps per CTA
constexpr int THREADS = TC * ROWS;   // 256
constexpr int FPT = TL / ROWS;       // frames per thread in K4a

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ float load(const float* p) { return *p; }
  static __device__ void store(float* p, float v) { *p = v; }
  // acc + x * w, two roundings, never an FMA
  static __device__ float mac(float acc, float x, float w) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ float to_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // bf16(acc + bf16(x * w)): the product of two bf16 values is exact in
  // fp32, and the fp32 sum of two bf16 values rounds to bf16 as the exact
  // sum does
  static __device__ float mac(float acc, float x, float w) {
    return to_bf16(__fadd_rn(acc, to_bf16(__fmul_rn(x, w))));
  }
};

// Stage rows [t0 - pad, t0 - pad + span) of x's channels [c0, c0 + TC) of
// batch row xb into s (span x TC values of S, float or double, either
// exact for T), zero outside [0, L) and past C.
template <typename T, typename S>
__device__ void load_halo(const T* __restrict__ xb, S* s, int span,
                          int t0, int pad, int c0, int L, int C) {
  for (int i = threadIdx.y * TC + threadIdx.x; i < span * TC; i += THREADS) {
    const int r = i / TC, ch = c0 + i % TC;
    const int t = t0 + r - pad;
    s[i] = (t >= 0 && t < L && ch < C)
               ? (S)Io<T>::load(xb + (size_t)t * C + ch) : (S)0;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dwconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int L,
                  int C, int K, int pad) {
  extern __shared__ float smem[];
  const int span = TL + K - 1;
  float* s_x = smem;                  // span x TC
  float* s_w = smem + span * TC;      // K x TC
  const int t0 = blockIdx.x * TL, c0 = blockIdx.y * TC, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;

  load_halo(x + (size_t)b * L * C, s_x, span, t0, pad, c0, L, C);
  for (int i = ty * TC + tx; i < K * TC; i += THREADS) {
    const int ch = c0 + i % TC;
    s_w[i] = ch < C ? Io<T>::load(w + (size_t)(i / TC) * C + ch) : 0.f;
  }
  __syncthreads();
  if (c >= C) return;

  const float bv = Io<T>::load(bias + c);
  float acc[FPT];
#pragma unroll
  for (int j = 0; j < FPT; ++j) acc[j] = bv;
  const float* col = s_x + ty * FPT * TC + tx;
  for (int k = 0; k < K; ++k) {
    const float wk = s_w[k * TC + tx];
#pragma unroll
    for (int j = 0; j < FPT; ++j)
      acc[j] = Io<T>::mac(acc[j], col[(j + k) * TC], wk);
  }
  T* ob = out + (size_t)b * L * C + c;
#pragma unroll
  for (int j = 0; j < FPT; ++j) {
    const int t = t0 + ty * FPT + j;
    if (t < L) Io<T>::store(ob + (size_t)t * C, acc[j]);
  }
}

// partial[(b * n_tiles + tile), k, c] = sum over the tile's frames i of
// x[b, i + k - pad, c] * g[b, i, c], each product and the sum in fp64.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dwconv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         double* __restrict__ partial, int L, int C, int K,
                         int pad) {
  extern __shared__ double dsmem[];
  const int span = TL + K - 1;
  double* s_x = dsmem;                // span x TC
  double* s_g = dsmem + span * TC;    // TL x TC
  const int t0 = blockIdx.x * TL, c0 = blockIdx.y * TC, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;

  load_halo(x + (size_t)b * L * C, s_x, span, t0, pad, c0, L, C);
  load_halo(g + (size_t)b * L * C, s_g, TL, t0, 0, c0, L, C);
  __syncthreads();
  if (c >= C) return;

  double* pb = partial + ((size_t)b * gridDim.x + blockIdx.x) * K * C + c;
  for (int k = ty; k < K; k += ROWS) {
    double acc = 0.0;
#pragma unroll 8
    for (int i = 0; i < TL; ++i)
      acc = fma(s_x[(i + k) * TC + tx], s_g[i * TC + tx], acc);
    pb[(size_t)k * C] = acc;
  }
}

// dw[j] = sum_p partial[p, j] for j < K*C, p in order 0..P-1, in fp64.
__global__ void __launch_bounds__(THREADS)
dwconv_dw_reduce_kernel(const double* __restrict__ partial,
                        float* __restrict__ dw, int P, int KC) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= KC) return;
  double s = 0.0;
  for (int p = 0; p < P; ++p) s += partial[(size_t)p * KC + j];
  dw[j] = (float)s;
}

// The window kernel's lane of channels: 4 bytes, two bf16 channels or one
// fp32 channel, and its multiply-add, rounded as Io<T>::mac rounds.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  using V = float;
  static constexpr int CH = 1;
  static __device__ float mac(float acc, float x, float w) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
};

template <>
struct Lane<__nv_bfloat16> {
  using V = uint32_t;  // a bf16x2 pair
  static constexpr int CH = 2;
  static __device__ uint32_t mac(uint32_t acc, uint32_t x, uint32_t w) {
    uint32_t p, s;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(x), "r"(w));
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(acc), "r"(p));
    return s;
  }
};

constexpr int W_TL = 64;                // frames per CTA
constexpr int W_FPT = W_TL / ROWS;      // frames per thread (8)

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dwconv_window_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ out, int L,
                     int C, int pad) {
  using V = typename Lane<T>::V;
  constexpr int CH = Lane<T>::CH;
  constexpr int SPAN = W_TL + K - 1;
  constexpr int PIECES = 128 / 16;          // 16-byte pieces of a halo row
  constexpr int PER_PIECE = 16 / sizeof(T); // channels in a piece
  __shared__ __align__(16) V s_x[SPAN][32];
  const int t0 = blockIdx.x * W_TL, c0 = blockIdx.y * 32 * CH, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* xb = x + (size_t)b * L * C;
  for (int i = threadIdx.x; i < SPAN * PIECES; i += THREADS) {
    const int r = i / PIECES, piece = i % PIECES;
    const int t = t0 + r - pad, ch = c0 + piece * PER_PIECE;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < L && ch < C)
      v = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + ch);
    reinterpret_cast<uint4*>(&s_x[r][0])[piece] = v;
  }
  const int c = c0 + lane * CH;
  V wk[K], bv = V(0);
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = V(0);
  if (c < C) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      wk[k] = *reinterpret_cast<const V*>(w + (size_t)k * C + c);
    bv = *reinterpret_cast<const V*>(bias + c);
  }
  __syncthreads();
  if (c >= C) return;

  V win[W_FPT + K - 1], acc[W_FPT];
#pragma unroll
  for (int j = 0; j < W_FPT + K - 1; ++j) win[j] = s_x[warp * W_FPT + j][lane];
#pragma unroll
  for (int j = 0; j < W_FPT; ++j) acc[j] = bv;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < W_FPT; ++j)
      acc[j] = Lane<T>::mac(acc[j], win[j + k], wk[k]);
  T* ob = out + (size_t)b * L * C + c;
#pragma unroll
  for (int j = 0; j < W_FPT; ++j) {
    const int t = t0 + warp * W_FPT + j;
    if (t < L) *reinterpret_cast<V*>(ob + (size_t)t * C) = acc[j];
  }
}

// K4b's window kernel (see the note at the top).
constexpr int DW_WARPS = 8;                    // consumer warps
constexpr int DW_FPT = 16;                     // frames a warp takes of a tile
constexpr int DW_TF = DW_WARPS * DW_FPT;       // frames per tile (128)
constexpr int DW_THREADS = (DW_WARPS + 1) * 32;  // and a producer warp
constexpr int DW_MAX_SPLITS = 8;               // CTAs per cluster, at most
constexpr int DW_LANES = 32;                   // channels per CTA

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The tile a CTA sums next: frames [t, min(t + DW_TF, te)) of batch row b,
// te the end of the CTA's frames in that row.
struct DwCursor {
  int b, t, te, L;
  long long n1;                 // end of the CTA's flattened frames
  bool valid;
  __device__ DwCursor(long long n0, long long n1_, int L_)
      : b((int)(n0 / L_)), t((int)(n0 % L_)), te(0), L(L_), n1(n1_),
        valid(n0 < n1_) {
    if (valid) te = (int)min((long long)L, n1 - (long long)b * L);
  }
  __device__ void next() {
    if (!valid) return;
    t += DW_TF;
    if (t < te) return;
    ++b;
    t = 0;
    valid = (long long)b * L < n1;
    if (valid) te = (int)min((long long)L, n1 - (long long)b * L);
  }
};

// Shared memory: a ring of STAGES tiles (x halo, then g, in T, each as
// TMA lands a box: rows of 32 channels), reused at the end for the warps'
// fp64 sums, red[tap][warp][lane], whose warp-0 entries then hold the
// CTA's.
template <typename T, int K>
struct DwSmem {
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 3;
  static constexpr int XROWS = DW_TF + K - 1;
  static constexpr size_t X_BYTES = sizeof(T) * XROWS * DW_LANES;
  static constexpr size_t G_BYTES = sizeof(T) * DW_TF * DW_LANES;
  static constexpr size_t STAGE = X_BYTES + G_BYTES;
  static_assert(X_BYTES % 128 == 0 && STAGE % 128 == 0, "TMA alignment");
  static constexpr size_t RED = sizeof(double) * K * DW_WARPS * DW_LANES;
  static constexpr size_t BYTES = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  // room to align to 128, and more than half an SM's 228 KB, so that the
  // cluster scheduler places one CTA an SM, never two of the few it has
  static constexpr size_t ALLOC = (BYTES > 115 * 1024 ? BYTES : 115 * 1024) + 128;
};

// The tensor maps of x and g, (batch, L, C) as 3-D boxes of 32 channels x
// rows x 1: XROWS rows for x, DW_TF for g; zeros out of bounds.
struct DwMaps {
  CUtensorMap x, g;
};

// One warp's share of a tile: the K taps of frames f0 .. f0 + 16 of the
// lane's channel, of which the first `valid` are the CTA's. sx points at x
// row f0 of the tile (the halo starts pad rows early), sg at g row f0. The
// 16 g values are loaded first, then the 16 + K - 1 x values one at a
// time; every product is taken in fp64, where it is exact for bf16 and
// fp32 inputs, and added to acc there.
template <typename T, int K>
__device__ __forceinline__ void dw_chunk(const T* __restrict__ sx,
                                         const T* __restrict__ sg, int valid,
                                         double (&acc)[K]) {
  double gv[DW_FPT];
#pragma unroll
  for (int j = 0; j < DW_FPT; ++j)
    gv[j] = j < valid ? (double)to_float(sg[j * DW_LANES]) : 0.0;
  // x of window row m meets g of frame j at tap m - j
#pragma unroll
  for (int m = 0; m < DW_FPT + K - 1; ++m) {
    const double xm = (double)to_float(sx[m * DW_LANES]);
#pragma unroll
    for (int j = 0; j < DW_FPT; ++j)
      if (m - j >= 0 && m - j < K) acc[m - j] = fma(xm, gv[j], acc[m - j]);
  }
}

// Grid (slices of 32 channels, splits), launched as clusters of (1, splits).
template <typename T, int K>
__global__ void __launch_bounds__(DW_THREADS, 1)
dwconv_dw_window_kernel(const __grid_constant__ DwMaps maps,
                        float* __restrict__ dw, int batch, int L, int C,
                        int pad) {
  using S = DwSmem<T, K>;
  extern __shared__ unsigned char dw_raw[];
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = gridDim.y;
  const int c0 = blockIdx.x * DW_LANES;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long n = (long long)batch * L;
  const long long n0 = n * rank / splits, n1 = n * (rank + 1) / splits;
  const uint32_t full0 = sm90::smem_u32(full), empty0 = sm90::smem_u32(empty);
  const uint32_t raw = sm90::smem_u32(dw_raw);
  const uint32_t ring = (raw + 127u) & ~127u;   // TMA boxes land 128-aligned
  unsigned char* dw_smem = dw_raw + (ring - raw);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      sm90::bar_init(full0 + 8 * i, 1);
      sm90::bar_init(empty0 + 8 * i, DW_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;

  if (warp == DW_WARPS) {
    // The producer: one thread asks TMA for each tile once its ring slot is
    // free: x rows t - pad .. t - pad + XROWS and g rows t .. t + DW_TF of
    // batch row b.
    if (lane == 0) {
      DwCursor load(n0, n1, L);
      for (int it = 0; load.valid; ++it, load.next()) {
        const int buf = it % S::STAGES;
        if (it >= S::STAGES)
          sm90::bar_wait(empty0 + 8 * buf, (it / S::STAGES - 1) & 1);
        const uint32_t bar = full0 + 8 * buf, dst = ring + buf * S::STAGE;
        sm90::bar_expect(bar, (int)S::STAGE);
        sm90::tma_3d(dst, &maps.x, bar, c0, load.t - pad, load.b);
        sm90::tma_3d(dst + S::X_BYTES, &maps.g, bar, c0, load.t, load.b);
      }
    }
  } else {
    // The consumers: each warp waits for a tile, takes its share and frees
    // the slot; warps drift apart by up to STAGES - 1 tiles, so that one
    // warp's loads, another's FMAs and a third's fp64 adds overlap.
    DwCursor comp(n0, n1, L);
    for (int it = 0; comp.valid; ++it, comp.next()) {
      const int buf = it % S::STAGES;
      sm90::bar_wait(full0 + 8 * buf, (it / S::STAGES) & 1);
      const int f0 = comp.t + warp * DW_FPT;
      if (f0 < comp.te) {
        const unsigned char* base = dw_smem + buf * S::STAGE;
        dw_chunk<T, K>(
            reinterpret_cast<const T*>(base) + warp * DW_FPT * DW_LANES + lane,
            reinterpret_cast<const T*>(base + S::X_BYTES) +
                warp * DW_FPT * DW_LANES + lane,
            comp.te - f0, acc);
      }
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(empty0 + 8 * buf);
    }
  }
  __syncthreads();   // every tile taken: the ring is free for the sums

  // The CTA's sum over its consumer warps, in fp64 and warp order, into
  // warp 0's entries (each read and written by one thread only).
  double* red = reinterpret_cast<double*>(dw_smem);
  if (warp < DW_WARPS) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      red[(k * DW_WARPS + warp) * DW_LANES + lane] = acc[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * DW_LANES; i += DW_THREADS) {
    double* r = red + (i / DW_LANES) * DW_WARPS * DW_LANES + i % DW_LANES;
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < DW_WARPS; ++q) s += r[q * DW_LANES];
    r[0] = s;
  }
  // The cluster's sum over its CTAs, in fp64 and rank order: CTA `rank`
  // writes its share of the slice's K * 32 outputs, rounded once to fp32
  // (a share is larger than the CTA when splits is 3 or fewer).
  cluster.sync();
  const int share = (K * DW_LANES + splits - 1) / splits;
  const int end = min((rank + 1) * share, K * DW_LANES);
  for (int i = rank * share + (int)threadIdx.x; i < end; i += DW_THREADS) {
    const int off = (i / DW_LANES) * DW_WARPS * DW_LANES + i % DW_LANES;
    double s = 0.0;
    for (int q = 0; q < splits; ++q)
      s += cluster.map_shared_rank(red, q)[off];
    const int c = c0 + i % DW_LANES;
    if (c < C) dw[(size_t)(i / DW_LANES) * C + c] = (float)s;
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

dim3 tile_grid(int batch, int L, int C) {
  return dim3((L + TL - 1) / TL, (C + TC - 1) / TC, batch);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The window kernel's K.
constexpr int WINDOW_K = 31;

template <typename T>
cudaError_t fwd_window(const void* x, const void* w, const void* bias,
                       void* out, int batch, int L, int C, int K, int pad,
                       cudaStream_t stream) {
  if (K != WINDOW_K || C % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  const int tcw = 32 * Lane<T>::CH;
  const dim3 grid((L + W_TL - 1) / W_TL, (C + tcw - 1) / tcw, batch);
  dwconv_window_kernel<T, WINDOW_K><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), L, C, pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* out,
                int batch, int L, int C, int K, int pad, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(TL + K - 1 + K) * TC;
  cudaError_t err = allow_smem(dwconv_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dwconv_fwd_kernel<T><<<tile_grid(batch, L, C), dim3(TC, ROWS), smem,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), L, C, K, pad);
  return cudaGetLastError();
}

// A launch of the window kernel in clusters of (1, splits).
template <typename T>
cudaLaunchConfig_t window_config(int C, int splits, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + DW_LANES - 1) / DW_LANES, splits);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DwSmem<T, WINDOW_K>::ALLOC;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = splits;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The window kernel's split of the frames: the most CTAs a slice of
// channels (at most 8) for which every slice's cluster is on the card at
// once, so that the launch is one wave (a cluster's CTAs share a GPC, and
// an H100 holds 15 clusters of 8 of these CTAs, one an SM, not the 16 that
// C 512 has); 8 if no split gives one wave. Or -cudaError_t.
template <typename T>
int window_splits(int C) {
  static int capacity[DW_MAX_SPLITS + 1] = {0};   // clusters the card holds
  const int slices = (C + DW_LANES - 1) / DW_LANES;
  for (int s = DW_MAX_SPLITS; s >= 1; --s) {
    if (capacity[s] == 0) {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg = window_config<T>(C, s, nullptr, &attr);
      int n = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(
          &n, (void*)dwconv_dw_window_kernel<T, WINDOW_K>, &cfg);
      if (err != cudaSuccess) return -(int)err;
      capacity[s] = n > 0 ? n : -1;
    }
    if (capacity[s] >= slices) return s;
  }
  return DW_MAX_SPLITS;
}

template <typename T>
cudaError_t dw_window(const void* x, const void* g, void* dw_out, int batch,
                      int L, int C, int K, int pad, cudaStream_t stream) {
  if (K != WINDOW_K || C % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dwconv_dw_window_kernel<T, WINDOW_K>,
                               DwSmem<T, WINDOW_K>::ALLOC);
  if (err != cudaSuccess) return err;
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {sizeof(T) * (cuuint64_t)C,
                                 sizeof(T) * (cuuint64_t)C * L};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  DwMaps maps;
  auto encode = [&](CUtensorMap* map, const void* ptr, int rows) {
    const cuuint32_t box[3] = {DW_LANES, (cuuint32_t)rows, 1};
    return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!encode(&maps.x, x, DwSmem<T, WINDOW_K>::XROWS) ||
      !encode(&maps.g, g, DW_TF))
    return cudaErrorInvalidValue;
  const int splits = window_splits<T>(C);
  if (splits < 0) return static_cast<cudaError_t>(-splits);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = window_config<T>(C, splits, stream, &attr);
  return cudaLaunchKernelEx(&cfg, dwconv_dw_window_kernel<T, WINDOW_K>, maps,
                            static_cast<float*>(dw_out), batch, L, C, pad);
}

template <typename T>
cudaError_t dw(const void* x, const void* g, void* partial, void* dw_out,
               int batch, int L, int C, int K, int pad, cudaStream_t stream) {
  const size_t smem = sizeof(double) * (size_t)(TL + K - 1 + TL) * TC;
  cudaError_t err = allow_smem(dwconv_dw_partial_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(batch, L, C);
  dwconv_dw_partial_kernel<T><<<grid, dim3(TC, ROWS), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<double*>(partial), L, C, K, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kc = K * C;
  dwconv_dw_reduce_kernel<<<(kc + THREADS - 1) / THREADS, THREADS, 0,
                            stream>>>(static_cast<const double*>(partial),
                                      static_cast<float*>(dw_out),
                                      batch * (int)grid.x, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of fp64 scratch depthwise_conv_dw needs for these shapes and
// variant (0 the window kernel: none; 1 the runtime-K kernel's partials).
extern "C" long long depthwise_conv_dw_scratch_bytes(int batch, int L, int C,
                                                     int K, int variant) {
  if (variant == 0) return 0;
  return (long long)sizeof(double) * batch * ((L + TL - 1) / TL) * K * C;
}

// K4b's window kernel (dtype 0 fp32, 1 bf16) at C channels: CTAs a slice
// of 32 channels (the cluster size), or -cudaError_t.
extern "C" int depthwise_conv_dw_window_splits(int C, int dtype) {
  cudaError_t err = dtype == 1
      ? allow_smem(dwconv_dw_window_kernel<__nv_bfloat16, WINDOW_K>,
                   DwSmem<__nv_bfloat16, WINDOW_K>::ALLOC)
      : allow_smem(dwconv_dw_window_kernel<float, WINDOW_K>,
                   DwSmem<float, WINDOW_K>::ALLOC);
  if (err != cudaSuccess) return -(int)err;
  return dtype == 1 ? window_splits<__nv_bfloat16>(C) : window_splits<float>(C);
}

// K4a. x (batch, L, C), w (K, C), bias (C,), out (batch, L, C), all of one
// dtype (0 fp32, 1 bf16), contiguous, 16-byte aligned, on the current
// device; pad is the left pad (K - 1 - pad on the right). variant: 0 the
// window kernel (K 31, C a multiple of 8 in bf16 or 4 in fp32), 1 the
// runtime-K kernel. Returns a cudaError_t.
extern "C" int depthwise_conv_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int batch,
                                  int L, int C, int K, int pad, int dtype,
                                  int variant, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (variant == 0)
    return dtype == 1
               ? fwd_window<bf16>(x, w, bias, out, batch, L, C, K, pad, s)
               : fwd_window<float>(x, w, bias, out, batch, L, C, K, pad, s);
  if (variant != 1) return cudaErrorInvalidValue;
  return dtype == 1 ? fwd<bf16>(x, w, bias, out, batch, L, C, K, pad, s)
                    : fwd<float>(x, w, bias, out, batch, L, C, K, pad, s);
}

// K4b. x, g (batch, L, C) of one dtype (0 fp32, 1 bf16), contiguous,
// 16-byte aligned for the window kernel; partial: scratch of
// depthwise_conv_dw_scratch_bytes; dw (K, C) fp32. variant: 0 the window
// kernel (K 31, C a multiple of 8 in bf16 or 4 in fp32), 1 the runtime-K
// kernels. Returns a cudaError_t.
extern "C" int depthwise_conv_dw(const void* x, const void* g, void* partial,
                                 void* dw_out, int batch, int L, int C, int K,
                                 int pad, int dtype, int variant,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (variant == 0)
    return dtype == 1
               ? dw_window<bf16>(x, g, dw_out, batch, L, C, K, pad, s)
               : dw_window<float>(x, g, dw_out, batch, L, C, K, pad, s);
  if (variant != 1) return cudaErrorInvalidValue;
  return dtype == 1
             ? dw<bf16>(x, g, partial, dw_out, batch, L, C, K, pad, s)
             : dw<float>(x, g, partial, dw_out, batch, L, C, K, pad, s);
}
