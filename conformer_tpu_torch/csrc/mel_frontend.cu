// Fused log-mel frontend for Hopper (sm_90a): frame + Hann-windowed DFT +
// power + slaney mel projection + log, one kernel, nothing but the log-mels
// written to device memory.
//
// Replaces: conformer_tpu/ops/pallas/mel_frontend.py::_kernel (reached through
// logmel_pallas). Same function: out[b, t, m] =
//   log(max(sum_k fb[k, m] * (re[t, k]^2 + im[t, k]^2), clamp)),
//   [re | im][t, :] = audio[b, t*hop : t*hop + n_fft] @ dft,
// with samples past the end of the padded row read as zeros.
//
// What bounds it on the H100: operations. Per frame it does
// 2*n_fft*(2*n_bins) + 2*n_bins*n_mels FLOPs (~354 kFLOP at n_fft 400) on
// 4*hop new bytes of audio and 4*n_mels bytes of output: ~700 FLOP/byte, far
// above the fp32 machine balance (67 TFLOP/s over 3.35 TB/s = 20). The
// products are plain fp32 FMAs, not TF32, because the log of small
// energies needs fp32 accuracy (the JAX tests hold 1e-4).
//
// Design. One CTA per (batch row, tile of TF frames). The TPU kernel's
// hop-row reshape was a Mosaic workaround; here the CTA stages the tile's
// contiguous audio span in shared memory and reads frame t at offset t*hop.
// The (n_fft, 2*n_bins) DFT matrix (643 KB) does not fit in shared memory: it
// streams through in chunks of KC samples x BC bins, with the real and
// imaginary columns of the same bins side by side, so each thread holds the
// re and im sums of its own bins in registers and squares them there. The
// power tile and the filterbank stay in shared memory for the mel product.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TF = 64;          // frames per CTA
constexpr int BC = 64;          // frequency bins per chunk
constexpr int KC = 32;          // DFT rows (samples) per chunk
constexpr int THREADS = 256;    // 8 frame groups (warps) x 32 bin pairs
constexpr int FPT = TF / 8;     // frames per thread

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ audio, int s_pad,
              const float* __restrict__ dft, const float* __restrict__ fb,
              float* __restrict__ out, int n_frames, int hop, int n_fft,
              int n_bins, int n_mels, float clamp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (TF - 1) * hop + n_fft;
  float* s_audio = smem;                          // span samples
  float* s_dft = s_audio + round4(span);          // KC x [BC re | BC im]
  float* s_pow = s_dft + KC * 2 * BC;             // TF x n_bins
  float* s_fb = s_pow + round4(TF * n_bins);      // n_bins x n_mels

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int tid = threadIdx.x;
  const int ty = tid / 32;                        // frames ty*FPT ...
  const int tx = tid % 32;                        // bins kb + 2*tx, +1

  const float* row = audio + (size_t)b * s_pad;
  const long start = (long)t0 * hop;
  for (int i = tid; i < span; i += THREADS) {
    const long s = start + i;
    s_audio[i] = s < s_pad ? row[s] : 0.f;
  }
  for (int i = tid; i < n_bins * n_mels; i += THREADS) s_fb[i] = fb[i];

  for (int kb = 0; kb < n_bins; kb += BC) {
    float re[FPT][2], im[FPT][2];
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      re[i][0] = re[i][1] = im[i][0] = im[i][1] = 0.f;
    }
    for (int k0 = 0; k0 < n_fft; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < KC * 2 * BC; i += THREADS) {
        const int kk = i / (2 * BC), c = i % (2 * BC);
        const int k = k0 + kk;
        const int bin = kb + (c % BC);
        const int col = c < BC ? bin : n_bins + bin;
        s_dft[i] = (k < n_fft && bin < n_bins)
                       ? dft[(size_t)k * 2 * n_bins + col] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KC, n_fft - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float2 wr =
            *reinterpret_cast<const float2*>(&s_dft[kk * 2 * BC + 2 * tx]);
        const float2 wi =
            *reinterpret_cast<const float2*>(&s_dft[kk * 2 * BC + BC + 2 * tx]);
        const float* a_col = s_audio + k0 + kk;
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
          const float a = a_col[(ty * FPT + i) * hop];
          re[i][0] = fmaf(a, wr.x, re[i][0]);
          re[i][1] = fmaf(a, wr.y, re[i][1]);
          im[i][0] = fmaf(a, wi.x, im[i][0]);
          im[i][1] = fmaf(a, wi.y, im[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int bin = kb + 2 * tx + j;
        if (bin < n_bins)
          s_pow[(ty * FPT + i) * n_bins + bin] =
              re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TF * n_mels; idx += THREADS) {
    const int f = idx / n_mels, m = idx % n_mels;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    const float* p = s_pow + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], s_fb[k * n_mels + m], acc);
    out[((size_t)b * n_frames + t) * n_mels + m] = logf(fmaxf(acc, clamp));
  }
}

}  // namespace

extern "C" const char* mel_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// audio (batch, s_pad) fp32 reflect-padded; dft (n_fft, 2*n_bins) fp32;
// fb (n_bins, n_mels) fp32; out (batch, n_frames, n_mels) fp32. All
// contiguous, on the current device. Returns a cudaError_t.
extern "C" int logmel_fwd(const void* audio, int batch, int s_pad,
                          const void* dft, const void* fb, void* out,
                          int n_frames, int hop, int n_fft, int n_bins,
                          int n_mels, float clamp, void* stream) {
  const int span = (TF - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(round4(span) + KC * 2 * BC +
                                               round4(TF * n_bins) +
                                               n_bins * n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + TF - 1) / TF, batch);
  logmel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), s_pad, static_cast<const float*>(dft),
      static_cast<const float*>(fb), static_cast<float*>(out), n_frames, hop,
      n_fft, n_bins, n_mels, clamp);
  return cudaGetLastError();
}
