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
// Design. K4a: one CTA per (tile of TL frames, tile of TC channels, batch
// row). It stages its (TL + K - 1, TC) halo of x in shared memory, zero
// outside [0, L), with the (K, TC) taps beside it; each thread owns one
// channel and FPT consecutive frames, so a tap's weight is read once for
// FPT products and a warp reads 32 consecutive channels of one row. There is
// no length limit: the halo is TL + K - 1 rows whatever L is. K4b: the TPU
// kernel carries the sum across its sequential batch grid; here a first
// kernel writes one fp32 partial per (batch row, frame tile) for each
// (tap, channel), and a second sums the partials in a fixed order: no
// atomics, the same result on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

dim3 tile_grid(int batch, int L, int C) {
  return dim3((L + TL - 1) / TL, (C + TC - 1) / TC, batch);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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
// dtype (0 fp32, 1 bf16), contiguous, on the current device; pad is the
// left pad (K - 1 - pad on the right). Returns a cudaError_t.
extern "C" int depthwise_conv_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int batch,
                                  int L, int C, int K, int pad, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? fwd<__nv_bfloat16>(x, w, bias, out, batch, L, C, K, pad, s)
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
