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
// K4b: the TPU kernel carries the sum across its sequential batch grid;
// here a first kernel writes one fp32 partial per (batch row, frame tile)
// for each (tap, channel), and a second sums the partials in a fixed order:
// no atomics, the same result on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// batch row xb into s (span x TC floats), zero outside [0, L) and past C.
template <typename T>
__device__ void load_halo(const T* __restrict__ xb, float* s, int span,
                          int t0, int pad, int c0, int L, int C) {
  for (int i = threadIdx.y * TC + threadIdx.x; i < span * TC; i += THREADS) {
    const int r = i / TC, ch = c0 + i % TC;
    const int t = t0 + r - pad;
    s[i] = (t >= 0 && t < L && ch < C) ? Io<T>::load(xb + (size_t)t * C + ch)
                                       : 0.f;
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
// x[b, i + k - pad, c] * g[b, i, c], fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dwconv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         float* __restrict__ partial, int L, int C, int K,
                         int pad) {
  extern __shared__ float smem[];
  const int span = TL + K - 1;
  float* s_x = smem;                  // span x TC
  float* s_g = smem + span * TC;      // TL x TC
  const int t0 = blockIdx.x * TL, c0 = blockIdx.y * TC, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;

  load_halo(x + (size_t)b * L * C, s_x, span, t0, pad, c0, L, C);
  load_halo(g + (size_t)b * L * C, s_g, TL, t0, 0, c0, L, C);
  __syncthreads();
  if (c >= C) return;

  float* pb = partial + ((size_t)b * gridDim.x + blockIdx.x) * K * C + c;
  for (int k = ty; k < K; k += ROWS) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < TL; ++i)
      acc = fmaf(s_x[(i + k) * TC + tx], s_g[i * TC + tx], acc);
    pb[(size_t)k * C] = acc;
  }
}

// dw[j] = sum_p partial[p, j] for j < K*C, p in order 0..P-1.
__global__ void __launch_bounds__(THREADS)
dwconv_dw_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ dw, int P, int KC) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= KC) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(size_t)p * KC + j];
  dw[j] = s;
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

template <typename T>
cudaError_t dw(const void* x, const void* g, void* partial, void* dw_out,
               int batch, int L, int C, int K, int pad, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(TL + K - 1 + TL) * TC;
  cudaError_t err = allow_smem(dwconv_dw_partial_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(batch, L, C);
  dwconv_dw_partial_kernel<T><<<grid, dim3(TC, ROWS), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(partial), L, C, K, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kc = K * C;
  dwconv_dw_reduce_kernel<<<(kc + THREADS - 1) / THREADS, THREADS, 0,
                            stream>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(dw_out),
                                      batch * (int)grid.x, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of fp32 scratch depthwise_conv_dw needs for these shapes.
extern "C" long long depthwise_conv_dw_scratch_bytes(int batch, int L, int C,
                                                     int K) {
  return (long long)sizeof(float) * batch * ((L + TL - 1) / TL) * K * C;
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

// K4b. x, g (batch, L, C) of one dtype (0 fp32, 1 bf16); partial: scratch of
// depthwise_conv_dw_scratch_bytes; dw (K, C) fp32. Returns a cudaError_t.
extern "C" int depthwise_conv_dw(const void* x, const void* g, void* partial,
                                 void* dw_out, int batch, int L, int C, int K,
                                 int pad, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dw<__nv_bfloat16>(x, g, partial, dw_out, batch, L, C, K, pad, s)
             : dw<float>(x, g, partial, dw_out, batch, L, C, K, pad, s);
}
