// Per-pass cost microbenchmark for Hopper (sm_90a), kernel K5: apply one op
// n times to every element of an fp32 (rows, cols) tile per CTA, so that the
// slope of the time over n prices one pass of that op on this card.
//
// Replaces: tools/bench_vpu_pass.py::_kernel, the TPU's per-pass cost of a
// VPU op over an attention score tile. The same arithmetic per op:
//   add      x = x + 1.000001
//   mul      x = x * 1.000001
//   where    x = m ? x : x * 0.999999, m = (x > 0.5) of the input
//   exp      x = exp(x * 1e-6)
//   exp2     x = exp2(x * 1e-6)
//   exp_raw  x = exp(x) * 1e-6
//   max      acc = acc + max_j(x[:, j] + acc[:, 0]), acc starting at x
//   sum      the same with a sum over the row
// expf and exp2f are CUDA's accurate versions (no --use_fast_math): they are
// what exp and exp2 cost in this package's kernels.
//
// What bounds it: operations, by design. Per element it reads 4 bytes and
// writes 4 and does n passes; at the JAX tool's n (64 and 320) the passes
// dominate. add, mul and where issue on the FP32 pipe (128 lanes per SM per
// clock), the exponentials on the MUFU unit (ex2, 16 per SM per clock).
//
// Design. The op is a template parameter, so the switch happens once, at
// launch, and each kernel is one loop over the passes with the element in a
// register. The where mask passes through an empty asm statement on every
// pass, so the compiler cannot hoist the select out of the loop. max and sum
// are row reductions: one warp per row, each lane holding up to 8 of the
// row's columns (cols <= 256), a shuffle reduction per pass, and acc[:, 0]
// broadcast from lane 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Op { ADD = 0, MUL, WHERE, EXP, EXP2, EXP_RAW, MAX, SUM };

constexpr int THREADS = 256;
constexpr int PER_LANE = 8;   // row reductions: cols <= 32 * PER_LANE

template <int OP>
__global__ void __launch_bounds__(THREADS)
elementwise_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int rows, int cols, int n) {
  const size_t tile = (size_t)rows * cols;
  const size_t base = (size_t)blockIdx.x * tile;
  for (size_t i = threadIdx.x; i < tile; i += THREADS) {
    float v = x[base + i];
    int keep = v > 0.5f;
    for (int p = 0; p < n; ++p) {
      if constexpr (OP == ADD) {
        v = v + 1.000001f;
      } else if constexpr (OP == MUL) {
        v = v * 1.000001f;
      } else if constexpr (OP == WHERE) {
        asm volatile("" : "+r"(keep));
        v = keep ? v : v * 0.999999f;
      } else if constexpr (OP == EXP) {
        v = expf(v * 1e-6f);
      } else if constexpr (OP == EXP2) {
        v = exp2f(v * 1e-6f);
      } else {
        v = expf(v) * 1e-6f;
      }
    }
    out[base + i] = v;
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
row_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
           int cols, int n) {
  const int lane = threadIdx.x % 32;
  const float identity = OP == MAX ? -INFINITY : 0.f;
  for (int r = threadIdx.x / 32; r < rows; r += THREADS / 32) {
    const size_t row = ((size_t)blockIdx.x * rows + r) * cols;
    float xv[PER_LANE], acc[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = lane + 32 * j;
      xv[j] = col < cols ? x[row + col] : 0.f;
      acc[j] = xv[j];
    }
    for (int p = 0; p < n; ++p) {
      const float a0 = __shfl_sync(0xffffffffu, acc[0], 0);
      float red = identity;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (lane + 32 * j < cols) {
          const float t = xv[j] + a0;
          red = OP == MAX ? fmaxf(red, t) : red + t;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, red, off);
        red = OP == MAX ? fmaxf(red, o) : red + o;
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) acc[j] = acc[j] + red;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = lane + 32 * j;
      if (col < cols) out[row + col] = acc[j];
    }
  }
}

template <int OP>
cudaError_t launch(const float* x, float* out, int rows, int cols, int grid,
                   int n, cudaStream_t stream) {
  if constexpr (OP == MAX || OP == SUM) {
    row_kernel<OP><<<grid, THREADS, 0, stream>>>(x, out, rows, cols, n);
  } else {
    elementwise_kernel<OP><<<grid, THREADS, 0, stream>>>(x, out, rows, cols,
                                                         n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* vpu_pass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int vpu_pass_max_row_cols() { return 32 * PER_LANE; }

// x, out (grid * rows, cols) fp32 contiguous on the current device; op is
// the index of the op in the list above (add = 0 ... sum = 7). Returns a
// cudaError_t (cudaErrorInvalidValue for an unknown op).
extern "C" int vpu_pass(const void* x, void* out, int op, int n, int rows,
                        int cols, int grid, void* stream) {
  const auto* xi = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case ADD: return launch<ADD>(xi, o, rows, cols, grid, n, s);
    case MUL: return launch<MUL>(xi, o, rows, cols, grid, n, s);
    case WHERE: return launch<WHERE>(xi, o, rows, cols, grid, n, s);
    case EXP: return launch<EXP>(xi, o, rows, cols, grid, n, s);
    case EXP2: return launch<EXP2>(xi, o, rows, cols, grid, n, s);
    case EXP_RAW: return launch<EXP_RAW>(xi, o, rows, cols, grid, n, s);
    case MAX: return launch<MAX>(xi, o, rows, cols, grid, n, s);
    case SUM: return launch<SUM>(xi, o, rows, cols, grid, n, s);
    default: return cudaErrorInvalidValue;
  }
}
