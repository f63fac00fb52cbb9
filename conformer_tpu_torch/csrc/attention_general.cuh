// The general attention kernels' shared pieces (namespace attn::gen): the
// forward K1 (sincos_attention.cu, namespace general) and the backward K2
// (sincos_attention_bwd.cu, namespace general) for fp32 and for every bf16
// head shape the wgmma kernels do not take (any dh up to 128, odd H, D/2
// not a multiple of 64, D > 512).
//
// Every product runs on the tensor cores through mma.sync: bf16 operands on
// m16n8k16 (products of bf16 values are exact, so only the fp32 sums differ
// from the plain version's), fp32 operands in 3xTF32 on m16n8k8 (tf32.cuh).
// The tensor cores truncate their running sums, so an fp32 product deeper
// than one tile is summed per tile (at most 64 deep, 24 TF32 products) from
// zero and each tile's sum added to the result in fp32.
//
// Widths. The packed operands (qu, qv, k, v, out) are (B, L, D) with
// D = H * dh; the position side (wh's last axis, the sin/cos tables, da)
// is Dp wide, which is D on one device and the whole model's width when a
// mesh gives this call a rank's H/tp heads (Dp = tp * D).
//
// Layout. Head widths and table widths are arbitrary, so each segment of
// a product's depth is zero-padded to 16 on its own (dhp and d2p: dh and
// D/2 rounded up to 16), and the score depth is the virtual row
// [qu | alpha | beta] . [k | cos | sin] of ep = dhp + 2 * d2p columns.
// Operands are copied from device memory with cp.async in vectors of
// vb bytes, the widest that divides dh and D/2 in bytes (16 down to 4; a
// bf16 shape with an odd dh or D/2 copies 2-byte elements through
// registers), into shared tiles whose rows are padded so that every
// fragment read is free of bank conflicts: 16 bytes for tiles read by
// ldmatrix or by the fp32 reads of a k-major tile whose k index is
// permuted (below), 32 bytes (fp32) for the k-major tiles read in the
// natural order.
//
// Fragments. A C fragment holds keys (or columns) 2t and 2t+1 of each
// n-tile. bf16 takes them as A fragments of the next product directly; the
// fp32 m16n8k8 A fragment wants columns t and t+4, so its k index is
// permuted instead (k column t <-> 2t, t+4 <-> 2t+1) and the B operand read
// with the same permutation, which keeps C fragments in registers. Tiles
// stored k-major ([k][m] or [k][n]) are read by ldmatrix.trans in bf16 and
// by scalar loads in fp32.
#pragma once

#include "sincos_attention_common.cuh"
#include "tf32.cuh"

namespace attn {
namespace gen {

constexpr int TK = 64;        // keys (or query rows) per streamed tile
constexpr int STAGES = 3;     // cp.async ring stages of the key-side passes
constexpr int THREADS = 128;  // their four warps, 16 rows each
constexpr int QTHREADS = 256; // query passes: two warps per 16 rows
constexpr int XW = 32;        // alpha | beta columns per prologue step
constexpr int SMS = 132;      // the H100's SMs
constexpr int PB = 8;         // row pad of the fp32 k-major tiles read in
                              // the natural order (32 bytes: stride = 8
                              // mod 32 floats); 16 bytes in bf16
constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The value product's width: dh rounded up to 16, 32, 64 or 128; 0 past
// 128.
__host__ __device__ inline int padded_head(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 0;
}

// Everything about a call's shapes that the kernels and the host share.
struct Geo {
  int B, L, H, dh, D, Dp, D2;  // D = H * dh packed; Dp position width, D2 = Dp/2
  int esz;         // bytes of T
  int pa;          // row pad (elements) of tiles read by ldmatrix or permuted
  int dhp, d2p;    // dh and D/2 rounded up to 16
  int ep;          // score depth, dhp + 2 * d2p
  int dvp;         // value width, padded_head(dh)
  int vb;          // copy width in bytes
  int nc;          // 64-column chunks of the score depth
  int qs;          // query tile row stride (elements)
  int ss;          // ring rows' stride: max(64, dvp) + pa
  int rows;        // query rows per CTA (16 per pair of warps)
  int stages;      // the query pass's ring stages, 3 or 4
};

inline Geo make_geo(int B, int L, int H, int dh, int Dp, int esz) {
  Geo g;
  g.B = B;
  g.L = L;
  g.H = H;
  g.dh = dh;
  g.D = H * dh;
  g.Dp = Dp;
  g.D2 = Dp / 2;
  g.esz = esz;
  g.pa = 16 / esz;
  g.dhp = round_up(dh, 16);
  g.d2p = round_up(g.D2, 16);
  g.ep = g.dhp + 2 * g.d2p;
  g.dvp = padded_head(dh);
  g.vb = 16;
  while (g.vb > esz && ((dh * esz) % g.vb || (g.D2 * esz) % g.vb)) g.vb /= 2;
  g.nc = (g.dhp + 63) / 64 + 2 * ((g.d2p + 63) / 64);
  g.qs = g.ep + g.pa;
  g.ss = (g.dvp > 64 ? g.dvp : 64) + g.pa;
  g.rows = 0;
  g.stages = 0;
  return g;
}

// Shared memory (bytes) of a query pass with `rows` query rows and a ring
// of `stages`: the query tile [qu | alpha | beta], with the backward also
// dO's tile and the halves' row sums of delta, then the ring, which the
// prologue's qv tile and position weights use first and the halves'
// combine (fp32 m, l and dvp sums per lane) last.
inline size_t query_smem(const Geo& g, int rows, int stages, bool bwd) {
  const size_t tile = (size_t)rows * g.qs * g.esz +
                      (bwd ? (size_t)rows * (g.dvp + g.pa) * g.esz +
                                 2 * (size_t)rows * 4
                           : 0);
  const size_t ring = (size_t)stages * TK * g.ss * g.esz;
  const size_t pro =
      ((size_t)rows * (g.dhp + g.pa) + 4 * (size_t)g.dhp * (XW + PB)) * g.esz;
  const size_t comb = (size_t)rows * 2 * (4 + g.dvp / 2) * 4;
  size_t big = ring > pro ? ring : pro;
  big = big > comb ? big : comb;
  return tile + big;
}

// The ring stages of a query pass with `rows` rows: 4 where they fit, else
// 3, else 0.
inline int query_stages(const Geo& g, int rows, bool bwd) {
  for (int st = 4; st >= 3; --st)
    if (query_smem(g, rows, st, bwd) <= SMEM_LIMIT) return st;
  return 0;
}

// Query rows per CTA: the most of 64, 32, 16 whose tile fits, halved while
// the grid has fewer CTAs than SMs (each CTA re-reads the whole key side,
// so smaller tiles cost L2 reads); 0 when not even 16 rows fit.
inline int query_rows(const Geo& g, bool bwd) {
  int rows = 64;
  while (rows >= 16 && query_stages(g, rows, bwd) == 0) rows /= 2;
  if (rows < 16) return 0;
  const long long per_tile = (long long)g.B * g.H;
  while (rows > 16 && per_tile * ((g.L + rows - 1) / rows) < SMS)
    rows /= 2;
  return rows;
}

// ---------------------------------------------------------------------------
// Element helpers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and widened back: the plain version's .to(dtype).float().
template <class T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// Copies: cp.async of vb bytes (4, 8, 16) with zero fill, or 2 bytes
// through registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_vec(void* dst, const void* src, int vb,
                                       bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? vb : 0;
  if (vb == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (vb == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (vb == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src) : 0;
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0..3) groups are pending.
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 3)
    cp_wait<3>();
  else if (n == 2)
    cp_wait<2>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<0>();
}

// rows x cols elements into a shared tile of row stride ss: element (r, c)
// is src[r * gstride + c] where r < vrows and c < vcols, else 0. cols is a
// multiple of 16, vcols of the vector's elements.
template <class T>
__device__ __forceinline__ void load_tile(T* dst, int ss, const T* src,
                                          size_t gstride, int rows, int vrows,
                                          int cols, int vcols, int vb) {
  const int ve = vb / (int)sizeof(T), per_row = cols / ve;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * ve;
    const bool ok = r < vrows && c < vcols;
    cp_vec(dst + r * ss + c, ok ? src + (size_t)r * gstride + c : src, vb, ok);
  }
}

// ---------------------------------------------------------------------------
// Fragments. ldmatrix reads 8 x 8 matrices of 16-bit values; an fp32 tile
// is read as 8 rows of 4 values, which is the TF32 A fragment and the
// [n][k] B fragment in their natural order.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Type-specific products: K is the k-step; the rest read fragments of
// shared tiles (m0/n0/k0 in elements) and multiply-accumulate.
template <class T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  using A = uint32_t[4];
  // A of rows m0.., depth k0.. of a row-major [m][k] tile.
  static __device__ __forceinline__ void a_mk(uint32_t (&a)[4], const bf16* s,
                                              int ss, int m0, int k0) {
    const int l = lane_id();
    ldsm4(a, s + (m0 + (l & 15)) * ss + k0 + (l >> 4) * 8);
  }
  // A of rows m0.., depth k0.. of a k-major [k][m] tile.
  static __device__ __forceinline__ void a_km(uint32_t (&a)[4], const bf16* s,
                                              int ss, int m0, int k0) {
    const int l = lane_id(), mi = l >> 3;
    ldsm4_t(a, s + (k0 + (mi >> 1) * 8 + (l & 7)) * ss + m0 + (mi & 1) * 8);
  }
  // B of n-tiles n0 and n0 + 8 at depth k0 of an [n][k] tile:
  // (b0, b1) of the first in b[0..1], of the second in b[2..3].
  static __device__ __forceinline__ void b_nk(uint32_t (&b)[4], const bf16* s,
                                              int ss, int n0, int k0) {
    const int l = lane_id(), mi = l >> 3;
    ldsm4(b, s + (n0 + (mi >> 1) * 8 + (l & 7)) * ss + k0 + (mi & 1) * 8);
  }
  // The same from a k-major [k][n] tile.
  static __device__ __forceinline__ void b_kn(uint32_t (&b)[4], const bf16* s,
                                              int ss, int n0, int k0) {
    const int l = lane_id(), mi = l >> 3;
    ldsm4_t(b, s + (k0 + (mi & 1) * 8 + (l & 7)) * ss + n0 + (mi >> 1) * 8);
  }
  // A of the next product from the C fragments of n-tiles 2kk, 2kk + 1,
  // rounded to bf16.
  static __device__ __forceinline__ void a_c(uint32_t (&a)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
    a[0] = pack(c0[0], c0[1]);
    a[1] = pack(c0[2], c0[3]);
    a[2] = pack(c1[0], c1[1]);
    a[3] = pack(c1[2], c1[3]);
  }
  // d0 += a . (b[0], b[1]), d1 += a . (b[2], b[3])
  static __device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[4]) {
    attn::mma(d0, a, b[0], b[1]);
    attn::mma(d1, a, b[2], b[3]);
  }
};

// fp32: the A and B fragments split into TF32 hi | lo by truncation
// (tf32::split_trunc: on the H100 at fp32 production width K1 took 1.32
// ms against 1.66 with cvt.rna's split, and agreed with its plain version
// to 5.5e-6 against 3.3e-6, tools/probe_attention_general.py).
struct SplitA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void split_a(SplitA& a, const uint32_t (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    tf32::split_trunc(__uint_as_float(x[i]), a.hi[i], a.lo[i]);
}
__device__ __forceinline__ void split_a(SplitA& a, float x0, float x1,
                                        float x2, float x3) {
  tf32::split_trunc(x0, a.hi[0], a.lo[0]);
  tf32::split_trunc(x1, a.hi[1], a.lo[1]);
  tf32::split_trunc(x2, a.hi[2], a.lo[2]);
  tf32::split_trunc(x3, a.hi[3], a.lo[3]);
}
// d += a . (b0, b1) in 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  tf32::split_trunc(b0, h0, l0);
  tf32::split_trunc(b1, h1, l1);
  tf32::mma3x(d, a.hi, a.lo, h0, h1, l0, l1);
}

template <>
struct Mma<float> {
  static constexpr int K = 8;
  // Natural order: A of a row-major [m][k] tile by ldmatrix.
  static __device__ __forceinline__ void a_mk(SplitA& a, const float* s,
                                              int ss, int m0, int k0) {
    const int l = lane_id();
    uint32_t x[4];
    ldsm4(x, s + (m0 + (l & 15)) * ss + k0 + (l >> 4) * 4);
    split_a(a, x);
  }
  // Natural order: B of n-tiles n0, n0 + 8 of an [n][k] tile by ldmatrix.
  static __device__ __forceinline__ void b_nk(float (&b)[4], const float* s,
                                              int ss, int n0, int k0) {
    const int l = lane_id(), mi = l >> 3;
    uint32_t x[4];
    ldsm4(x, s + (n0 + (mi >> 1) * 8 + (l & 7)) * ss + k0 + (mi & 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __uint_as_float(x[i]);
  }
  // Natural order: B of n-tile n0 of a k-major [k][n] tile (stride = 8
  // mod 32 floats).
  static __device__ __forceinline__ void b_kn_nat(float& b0, float& b1,
                                                  const float* s, int ss,
                                                  int n0, int k0) {
    const int l = lane_id(), g = l >> 2, t = l & 3;
    b0 = s[(k0 + t) * ss + n0 + g];
    b1 = s[(k0 + t + 4) * ss + n0 + g];
  }
  // Permuted order (k column t <-> 2t, t + 4 <-> 2t + 1):
  // A of a k-major [k][m] tile (stride = 4 mod 16 floats).
  static __device__ __forceinline__ void a_km(SplitA& a, const float* s,
                                              int ss, int m0, int k0) {
    const int l = lane_id(), g = l >> 2, t = l & 3;
    const float* p = s + (k0 + 2 * t) * ss + m0 + g;
    split_a(a, p[0], p[8], p[ss], p[ss + 8]);
  }
  // Permuted order: B of n-tile n0 of a k-major [k][n] tile.
  static __device__ __forceinline__ void b_kn(float& b0, float& b1,
                                              const float* s, int ss, int n0,
                                              int k0) {
    const int l = lane_id(), g = l >> 2, t = l & 3;
    const float* p = s + (k0 + 2 * t) * ss + n0 + g;
    b0 = p[0];
    b1 = p[ss];
  }
  // Permuted order: B of n-tile n0 of an [n][k] tile (stride = 8 mod 32).
  static __device__ __forceinline__ void b_nk_perm(float& b0, float& b1,
                                                   const float* s, int ss,
                                                   int n0, int k0) {
    const int l = lane_id(), g = l >> 2, t = l & 3;
    const float2 x =
        *reinterpret_cast<const float2*>(s + (n0 + g) * ss + k0 + 2 * t);
    b0 = x.x;
    b1 = x.y;
  }
  // Permuted order: A from the C fragment of one n-tile.
  static __device__ __forceinline__ void a_c(SplitA& a, const float (&c)[4]) {
    split_a(a, c[0], c[2], c[1], c[3]);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
}
template <int N>
__device__ __forceinline__ void add_to(float (&x)[N][4], const float (&y)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] += y[i][j];
}

// ---------------------------------------------------------------------------
// The score depth in chunks of at most 64 columns, each within one segment:
// [k | cos | sin] on the key side, [qu | alpha | beta] in the query tile.
// ---------------------------------------------------------------------------

struct Chunk {
  int seg;    // 0 k, 1 cos, 2 sin
  int col;    // first column in the segment
  int width;  // columns, a multiple of 16
  int qoff;   // first column in the query tile
};

__device__ __forceinline__ Chunk chunk_of(const Geo& g, int i) {
  const int nk = (g.dhp + 63) / 64, nx = (g.d2p + 63) / 64;
  Chunk c;
  if (i < nk) {
    c.seg = 0;
    c.col = 64 * i;
    c.width = min(64, g.dhp - c.col);
    c.qoff = c.col;
  } else {
    i -= nk;
    c.seg = 1 + i / nx;
    c.col = 64 * (i % nx);
    c.width = min(64, g.d2p - c.col);
    c.qoff = g.dhp + (c.seg - 1) * g.d2p + c.col;
  }
  return c;
}

// Issue the copies of score chunk `ci` of keys j0.. into a ring slot.
template <class T>
__device__ __forceinline__ void load_key_chunk(const Geo& g, T* slot,
                                               const T* k, const T* cos_t,
                                               const T* sin_t, int b, int h,
                                               int j0, int ci) {
  const Chunk c = chunk_of(g, ci);
  const int vrows = g.L - j0;
  if (c.seg == 0)
    load_tile(slot, g.ss, k + ((size_t)b * g.L + j0) * g.D + h * g.dh + c.col,
              g.D, TK, vrows, c.width, g.dh - c.col, g.vb);
  else
    load_tile(slot, g.ss,
              (c.seg == 1 ? cos_t : sin_t) + (size_t)j0 * g.D2 + c.col, g.D2,
              TK, vrows, c.width, g.D2 - c.col, g.vb);
}

// Rows j0.. of a packed (B, L, D) operand's head h, dvp columns, into a
// ring slot.
template <class T>
__device__ __forceinline__ void load_head_rows(const Geo& g, T* slot, int ss,
                                               const T* x, int b, int h,
                                               int j0, int rows) {
  load_tile(slot, ss, x + ((size_t)b * g.L + j0) * g.D + h * g.dh, g.D, rows,
            g.L - j0, g.dvp, g.dh, g.vb);
}

// s[16 rows of this warp][its 32 keys] += one score chunk: query tile
// columns c.qoff.. against rows kn0.. of the chunk in `kt`. fp32 sums the
// chunk from zero and adds it.
template <class T>
__device__ __forceinline__ void score_chunk(float (&s)[4][4], const Geo& g,
                                            const T* qt, const T* kt, int wrow,
                                            int kn0, const Chunk& c);

template <>
__device__ __forceinline__ void score_chunk<bf16>(float (&s)[4][4],
                                                  const Geo& g, const bf16* qt,
                                                  const bf16* kt, int wrow,
                                                  int kn0, const Chunk& c) {
  using M = Mma<bf16>;
  for (int kk = 0; kk < c.width; kk += 16) {
    uint32_t a[4];
    M::a_mk(a, qt, g.qs, wrow, c.qoff + kk);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      M::b_nk(b, kt, g.ss, kn0 + 16 * np, kk);
      M::mma2(s[2 * np], s[2 * np + 1], a, b);
    }
  }
}

template <>
__device__ __forceinline__ void score_chunk<float>(float (&s)[4][4],
                                                   const Geo& g,
                                                   const float* qt,
                                                   const float* kt, int wrow,
                                                   int kn0, const Chunk& c) {
  using M = Mma<float>;
  float part[4][4];
  zero(part);
  for (int kk = 0; kk < c.width; kk += 8) {
    SplitA a;
    M::a_mk(a, qt, g.qs, wrow, c.qoff + kk);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      float b[4];
      M::b_nk(b, kt, g.ss, kn0 + 16 * np, kk);
      mma3(part[2 * np], a, b[0], b[1]);
      mma3(part[2 * np + 1], a, b[2], b[3]);
    }
  }
  add_to(s, part);
}

// acc[16 rows][NV n-tiles] += x . y over this warp's 32 keys, x in C
// fragments (16 rows x 32, rounded to T as A), y the k-major
// [32 keys][>= 8 NV] rows of the tile: P . V in the forward, ds . k in the
// backward. fp32 sums the tile from zero and adds it.
template <class T, int NV>
__device__ __forceinline__ void c_times_kn(float (&acc)[NV][4],
                                           const float (&x)[4][4],
                                           const T* y, int ys) {
  if constexpr (sizeof(T) == 2) {
    using M = Mma<bf16>;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      M::a_c(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
      for (int vp = 0; vp < NV / 2; ++vp) {
        uint32_t b[4];
        M::b_kn(b, y, ys, 16 * vp, 16 * kk);
        M::mma2(acc[2 * vp], acc[2 * vp + 1], a, b);
      }
    }
  } else {
    using M = Mma<float>;
    float part[NV][4];
    zero(part);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      SplitA a;
      M::a_c(a, x[nt]);
#pragma unroll
      for (int vn = 0; vn < NV; ++vn) {
        float b0, b1;
        M::b_kn(b0, b1, y, ys, 8 * vn, 8 * nt);
        mma3(part[vn], a, b0, b1);
      }
    }
    add_to(acc, part);
  }
}

// ---------------------------------------------------------------------------
// The query tile: [qu | alpha | beta] of query rows q0.. of head h, with
//   a = qv . wh[h] (fp32 sums), alpha = T(a_s sin_q + a_c cos_q),
//   beta = T(-a_s cos_q + a_c sin_q)
// on the tensor cores, XW columns of each half at a time (the position
// weights double-buffered), written once into the tile. `work` is the ring,
// not yet in use. Drains every copy group; ends with a __syncthreads.
// ---------------------------------------------------------------------------

template <class T>
__device__ void build_query_tile(const Geo& g, T* qt, T* work, const T* qu,
                                 const T* qv, const T* wh, const T* sin_t,
                                 const T* cos_t, int b, int h, int q0,
                                 int rows) {
  using M = Mma<T>;
  const int qvs = g.dhp + g.pa, ws = XW + PB;
  T* qvt = work;
  T* wbuf = work + rows * qvs;  // [buffer][half][dhp][ws]
  const size_t wsz = (size_t)g.dhp * ws;
  const size_t row0 = (size_t)b * g.L + q0;
  load_tile(qt, g.qs, qu + row0 * g.D + h * g.dh, g.D, rows, g.L - q0, g.dhp,
            g.dh, g.vb);
  load_tile(qvt, qvs, qv + row0 * g.D + h * g.dh, g.D, rows, g.L - q0, g.dhp,
            g.dh, g.vb);
  const T* whh = wh + (size_t)h * g.dh * g.Dp;
  auto load_w = [&](int xc) {
    const int x0 = xc * XW;
    T* dst = wbuf + (size_t)(xc & 1) * 2 * wsz;
    for (int half = 0; half < 2; ++half)
      load_tile(dst + half * wsz, ws, whh + half * g.D2 + x0, g.Dp, g.dhp,
                g.dh, XW, g.D2 - x0, g.vb);
  };
  const int nx = (g.d2p + XW - 1) / XW;
  load_w(0);
  cp_commit();
  // a pair of warps per 16 rows, each on two of the four n-tiles
  const int warp = threadIdx.x / 32, wrow = 16 * (warp >> 1);
  const int n0 = 16 * (warp & 1);
  const int l = lane_id(), gq = l >> 2, t = l & 3;
  for (int xc = 0; xc < nx; ++xc) {
    if (xc + 1 < nx) load_w(xc + 1);
    cp_commit();
    // this thread's query rows' sin and cos, loaded behind the wait
    float sq[2][4], cq[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + wrow + gq + 8 * (i >> 1);
        const int x = xc * XW + n0 + 8 * nt + 2 * t + (i & 1);
        const bool in = q < g.L && x < g.D2;
        sq[nt][i] = in ? to_f(sin_t[(size_t)q * g.D2 + x]) : 0.f;
        cq[nt][i] = in ? to_f(cos_t[(size_t)q * g.D2 + x]) : 0.f;
      }
    cp_wait<1>();
    __syncthreads();
    const T* w_s = wbuf + (size_t)(xc & 1) * 2 * wsz;
    const T* w_c = w_s + wsz;
    float as[2][4], ac[2][4];
    zero(as);
    zero(ac);
    for (int kk = 0; kk < g.dhp; kk += M::K) {
      if constexpr (sizeof(T) == 2) {
        uint32_t a[4], b[4];
        M::a_mk(a, qvt, qvs, wrow, kk);
        M::b_kn(b, w_s, ws, n0, kk);
        M::mma2(as[0], as[1], a, b);
        M::b_kn(b, w_c, ws, n0, kk);
        M::mma2(ac[0], ac[1], a, b);
      } else {
        SplitA a;
        M::a_mk(a, qvt, qvs, wrow, kk);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float b0, b1;
          M::b_kn_nat(b0, b1, w_s, ws, n0 + 8 * nt, kk);
          mma3(as[nt], a, b0, b1);
          M::b_kn_nat(b0, b1, w_c, ws, n0 + 8 * nt, kk);
          mma3(ac[nt], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wrow + gq + 8 * (i >> 1);
        const int x = xc * XW + n0 + 8 * nt + 2 * t + (i & 1);
        if (x >= g.d2p) continue;
        const float s_ = as[nt][i], c_ = ac[nt][i];
        const float sn = sq[nt][i], cs = cq[nt][i];
        qt[r * g.qs + g.dhp + x] =
            from_f<T>(__fadd_rn(__fmul_rn(s_, sn), __fmul_rn(c_, cs)));
        qt[r * g.qs + g.dhp + g.d2p + x] =
            from_f<T>(__fadd_rn(__fmul_rn(-s_, cs), __fmul_rn(c_, sn)));
      }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();
}

}  // namespace gen
}  // namespace attn
