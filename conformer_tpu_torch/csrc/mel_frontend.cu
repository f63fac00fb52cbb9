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
// 4*hop new bytes of audio and 4*n_mels bytes of output: ~700 FLOP/byte.
// On CUDA cores (67 TFLOP/s fp32) that is 0.101 ms at B 8, 2401 frames; the
// log of small energies needs fp32 accuracy (the JAX tests hold 1e-4), so a
// single TF32 product would not do.
//
// Design: both products on the tensor cores at fp32 accuracy, 3xTF32 on
// mma.sync m16n8k8: a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, fp32 sums,
// where x_hi is x rounded to TF32 and x_lo the rest rounded to TF32 (the
// dropped a_lo.b_lo is ~2^-22 of a.b). Three TF32 products cost 3x the
// FLOPs at 495 TFLOP/s: a bound of 0.041 ms at B 8, 2401 frames.
// - The DFT: frames x n_fft samples x 2*n_bins columns. Its matrix is split
//   into hi and lo once, when the frontend is built (ops/cuda/mel_frontend.py
//   ::k3_operands), and packed in mma fragment order: per chunk of 16 bins,
//   per 8-sample k-step, per n-tile of 8 columns, each lane's
//   (b0_hi, b1_hi, b0_lo, b1_lo) as one 16-byte vector. The columns are
//   interleaved [re_k | im_k], so the C fragment gives each thread the re
//   and im of the same bin side by side and the power is formed in
//   registers, never stored.
// - The A operand is read straight from the CTA's audio span in shared
//   memory, laid out in hop-sized rows (frame t's samples are rows t, t+1,
//   ... of the span, as the TPU kernel's hop-row reshape has them) padded to
//   a stride of 4 mod 8 floats, so the 8 frames of a fragment hit 32
//   different banks. The k-steps never cross a row: each row's last step
//   is zero-padded in the packed matrix. The split of A is done in
//   registers (cvt.rna.tf32.f32).
// - The mel product: the 16 bins' powers of a chunk become the A fragments
//   of two m16n8k8 k-steps in registers (bins t and t+4 of a k-step are the
//   same thread's n-tiles 2u and 2u+1), against the filterbank, split and
//   packed the same way, read through the read-only cache.
// - One CTA per (tile of frames, batch row), each warp on one 16-frame
//   m-tile, so a B fragment serves 3 products and an A fragment 4 n-tiles.
//   The DFT fragments stream through a 2-stage cp.async ring that overlaps
//   the next stage's copy with this one's products. Two tilings (Tile):
//   wide, 128 frames and 8 warps with 20 KB stages (125 KB of shared
//   memory, 85 KB of it audio: one CTA an SM), while the grid has at most
//   one CTA an SM; else narrow, 64 frames and 4 warps with 10 KB stages
//   (63 KB, three CTAs an SM), so that no SM runs two wide CTAs in turn
//   (152 wide CTAs at B 8, 2401 frames on 132 SMs would). The DFT is read
//   from L2 once per CTA: 1.3 MB.
// - A table in shared memory gives each k-step's offset in the span, so
//   the loop does no integer division.
// - Each k-step's three products start from zero and are added to the
//   running sum in fp32 (mma3): on an H100 80GB HBM3 at 700 W that keeps
//   the log-mels within 1.3e-5 of float64 (the plain version's fp32 GEMMs
//   4.3e-5), where accumulating in the tensor cores' running sum gave
//   8.9e-5, at ~10 % of the time at 2401 frames.
// tools/probe_mel_frontend.py times each tiling alone, the first design
// (4 warps of two m-tiles, 128 frames, two CTAs an SM) and the running-sum
// accumulation. The check on the card holds 1e-4 on the log-mels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using namespace tf32;

constexpr int NT = 4;        // DFT n-tiles per chunk: 16 bins
constexpr int STAGES = 2;    // ring stages
constexpr int STEP_PAD = 10; // the packed k-steps are a multiple of this

// A CTA's tiling: WARPS warps of MT 16-frame m-tiles each, KS k-steps (of
// NT n-tiles) per ring stage, MIN_CTAS CTAs an SM for the register budget.
template <int W, int M, int K_STEPS, int MIN_CTAS>
struct Tile {
  static constexpr int WARPS = W, MT = M, KS = K_STEPS, MIN_CTAS_PER_SM = MIN_CTAS;
  static constexpr int FRAMES = WARPS * MT * 16, THREADS = WARPS * 32;
  static constexpr int STAGE = KS * NT * 32;  // float4s per stage
  static_assert(STEP_PAD % KS == 0, "a stage must divide the packed steps");
};
// 128 frames, 8 warps, 20 KB stages: 125 KB of shared memory, one CTA an SM.
using Wide = Tile<8, 1, 10, 1>;
// 64 frames, 4 warps, 10 KB stages: 63 KB, three CTAs an SM.
using Narrow = Tile<4, 1, 5, 3>;

// acc += a . b in 3xTF32; b = (b0_hi, b1_hi, b0_lo, b1_lo). The three
// products of this k-step are summed by the tensor cores from zero, the
// small terms first, and that sum added to acc by an fp32 add. The tensor
// cores round their accumulation towards zero: on a running sum over the
// 150 products of a bin, those truncations add up to ~1e-4 of the log-mel
// of a bin whose re or im cancels out; added to acc with round-to-nearest
// instead, they stay at fp32's own size.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  float d[4];
  mma0(d, lo, bh0, bh1);
  mma(d, hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(d, hi, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Samples per hop row and its padded stride in shared memory.
__host__ __device__ inline int steps_per_row(int hop) { return (hop + 7) / 8; }
__host__ __device__ inline int row_stride(int hop) {
  return 8 * steps_per_row(hop) + 4;
}
__host__ __device__ inline int span_rows(int frames, int hop, int n_fft) {
  return frames + (n_fft - 1) / hop;
}
template <class C>
size_t smem_bytes(int hop, int n_fft, int s_pad) {
  return sizeof(float4) * STAGES * C::STAGE +
         sizeof(float) * (size_t)span_rows(C::FRAMES, hop, n_fft) *
             row_stride(hop) +
         sizeof(int) * (size_t)s_pad;
}

// dft_frag: (n_chunks, s_pad, NT, 32) float4; fb_frag: (2 * n_chunks, NTM,
// 32) float4; n_steps real k-steps of s_pad (a multiple of C::KS).
template <class C, int NTM>
__global__ void __launch_bounds__(C::THREADS, C::MIN_CTAS_PER_SM)
logmel_kernel(const float* __restrict__ audio, int s_pad_audio,
              const float4* __restrict__ dft_frag,
              const float4* __restrict__ fb_frag, float* __restrict__ out,
              int n_frames, int hop, int n_fft, int n_steps, int s_pad,
              int n_chunks, int n_mels, float clamp) {
  constexpr int WARPS = C::WARPS, MT = C::MT, KS = C::KS, FRAMES = C::FRAMES;
  constexpr int THREADS = C::THREADS, STAGE = C::STAGE;
  extern __shared__ float4 smem4[];
  float4* s_b = smem4;                                           // the ring
  float* s_a = reinterpret_cast<float*>(smem4 + STAGES * STAGE);  // span rows
  const int spr = steps_per_row(hop), hs = row_stride(hop);
  const int n_rows = span_rows(FRAMES, hop, n_fft);
  const int b = blockIdx.y, t0 = blockIdx.x * FRAMES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int stages_per_chunk = s_pad / KS, n_stages = n_chunks * stages_per_chunk;
  // Each k-step's offset in the span: row s / spr, sample (s % spr) * 8.
  int* s_off = reinterpret_cast<int*>(s_a + n_rows * hs);
  for (int s = tid; s < s_pad; s += THREADS)
    s_off[s] = (s / spr) * hs + (s % spr) * 8;

  // Stage st goes to ring slot st % STAGES in commit group st; a group past
  // the last stage is empty, so every iteration waits on the same count.
  auto issue = [&](int st) {
    if (st < n_stages) {
      const float4* src = dft_frag + (size_t)st * STAGE;
      float4* dst = s_b + (st % STAGES) * STAGE;
      for (int i = tid; i < STAGE; i += THREADS) cp_async16(dst + i, src + i);
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);

  const float* row = audio + (size_t)b * s_pad_audio;
  const long start = (long)t0 * hop;
  for (int r = warp; r < n_rows; r += WARPS)
    for (int c = lane; c < hs; c += 32) {
      const long s = start + (long)r * hop + c;
      s_a[r * hs + c] = c < hop && s < s_pad_audio ? row[s] : 0.f;
    }

  float acc[MT][NT][4], mel[MT][NTM][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NTM; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mel[m][j][i] = 0.f;
  }
  const int f_warp = warp * MT * 16 + g;   // this lane's first frame row

  for (int st = 0; st < n_stages; ++st) {
    issue(st + STAGES - 1);   // into the slot stage st - 1 has freed
    cp_wait<STAGES - 1>();
    __syncthreads();
    const float4* sb = s_b + (st % STAGES) * STAGE;
    const int kb = st % stages_per_chunk;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int s = kb * KS + ks;
      if (s >= n_steps) break;
      const int off = s_off[s] + t;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* p = s_a + (f_warp + m * 16) * hs + off;
        const float x[4] = {p[0], p[8 * hs], p[4], p[8 * hs + 4]};
        split4(x, ahi[m], alo[m]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 bv = sb[(ks * NT + j) * 32 + lane];
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(acc[m][j], ahi[m], alo[m], bv);
      }
    }
    if (kb == stages_per_chunk - 1) {
      // The chunk's 16 bins are done: their powers are two k-steps of the
      // mel product. Thread (g, t) holds bin 4j + t of n-tile j.
      const int u = st / stages_per_chunk;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pw[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // i = 0, 1: bin t of rows g, g + 8; i = 2, 3: bin t + 4
            const int j = 2 * half + i / 2, r = 2 * (i % 2);
            pw[i] = acc[m][j][r] * acc[m][j][r] + acc[m][j][r + 1] * acc[m][j][r + 1];
          }
          uint32_t phi[4], plo[4];
          split4(pw, phi, plo);
          const float4* fbk = fb_frag + (size_t)(2 * u + half) * NTM * 32 + lane;
#pragma unroll
          for (int n = 0; n < NTM; ++n)
            mma3(mel[m][n], phi, plo, __ldg(fbk + n * 32));
        }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    }
    __syncthreads();  // slot st % STAGES is free for issue(st + STAGES)
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int f = t0 + f_warp + m * 16 + 8 * hf;
      if (f >= n_frames) continue;
      float* dst = out + ((size_t)b * n_frames + f) * n_mels;
#pragma unroll
      for (int n = 0; n < NTM; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < n_mels) dst[c] = logf(fmaxf(mel[m][n][2 * hf], clamp));
        if (c + 1 < n_mels) dst[c + 1] = logf(fmaxf(mel[m][n][2 * hf + 1], clamp));
      }
    }
}

template <class C, int NTM>
cudaError_t launch(const float* audio, int batch, int s_pad_audio,
                   const float4* dft_frag, const float4* fb_frag, float* out,
                   int n_frames, int hop, int n_fft, int n_steps, int s_pad,
                   int n_chunks, int n_mels, float clamp, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(hop, n_fft, s_pad);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<C, NTM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + C::FRAMES - 1) / C::FRAMES, batch);
  logmel_kernel<C, NTM><<<grid, C::THREADS, smem, stream>>>(
      audio, s_pad_audio, dft_frag, fb_frag, out, n_frames, hop, n_fft,
      n_steps, s_pad, n_chunks, n_mels, clamp);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int NTM>
cudaError_t launch_tiled(const float* audio, int batch, int s_pad_audio,
                         const float4* dft_frag, const float4* fb_frag,
                         float* out, int n_frames, int hop, int n_fft,
                         int n_steps, int s_pad, int n_chunks, int n_mels,
                         float clamp, cudaStream_t stream) {
  // Wide CTAs while there is at most one an SM; past that, narrow ones,
  // three an SM, so that no SM runs two wide CTAs in turn.
  const long long wide_ctas =
      (long long)batch * ((n_frames + Wide::FRAMES - 1) / Wide::FRAMES);
  const bool wide = wide_ctas <= sm_count();
  return (wide ? launch<Wide, NTM> : launch<Narrow, NTM>)(
      audio, batch, s_pad_audio, dft_frag, fb_frag, out, n_frames, hop, n_fft,
      n_steps, s_pad, n_chunks, n_mels, clamp, stream);
}

}  // namespace

extern "C" const char* mel_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The packing constants ops/cuda/mel_frontend.py::k3_operands must use:
// [bins per chunk, the multiple the packed k-steps are padded to].
extern "C" void logmel_layout(int* out) {
  out[0] = NT * 4;
  out[1] = STEP_PAD;
}

// audio (batch, s_pad_audio) fp32 reflect-padded; dft_frag, fb_frag: the
// split and packed DFT matrix and filterbank of k3_operands (n_steps real
// k-steps of s_pad, n_chunks chunks of 16 bins, n_mel_tiles 10 or 16);
// out (batch, n_frames, n_mels) fp32. All contiguous, 16-byte aligned, on
// the current device. Returns a cudaError_t.
extern "C" int logmel_fwd(const void* audio, int batch, int s_pad_audio,
                          const void* dft_frag, const void* fb_frag, void* out,
                          int n_frames, int hop, int n_fft, int n_steps,
                          int s_pad, int n_chunks, int n_mels, int n_mel_tiles,
                          float clamp, void* stream) {
  if (s_pad % STEP_PAD != 0 || n_steps > s_pad || 8 * n_mel_tiles < n_mels)
    return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(audio);
  const auto* d = static_cast<const float4*>(dft_frag);
  const auto* f = static_cast<const float4*>(fb_frag);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_mel_tiles == 10)
    return launch_tiled<10>(a, batch, s_pad_audio, d, f, o, n_frames, hop, n_fft,
                      n_steps, s_pad, n_chunks, n_mels, clamp, s);
  if (n_mel_tiles == 16)
    return launch_tiled<16>(a, batch, s_pad_audio, d, f, o, n_frames, hop, n_fft,
                      n_steps, s_pad, n_chunks, n_mels, clamp, s);
  return cudaErrorInvalidValue;
}
