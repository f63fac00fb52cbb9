// Native audio I/O: WAV decoding + polyphase resampling with a C ABI.
//
// A copy of native/audio_io.cpp. Linked with flac.cpp into one library at
// first use by conformer_tpu_torch/native/__init__.py::load_audio (into
// build/); bound with ctypes by conformer_tpu_torch/audio/native.py.
//
// WAV support: RIFF/RIFX PCM 16/24/32-bit and IEEE float32, any channel
// count. Resampler: windowed-sinc polyphase with scipy resample_poly's
// default window ('kaiser', 5.0) and half length 10 * max(up, down), the
// products summed in fp64.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct WavData {
  int sample_rate = 0;
  int channels = 0;
  long frames = 0;           // samples per channel
  std::vector<float> interleaved;
};

static bool read_wav_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  auto rd = [&](void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; };

  char magic[4];
  uint32_t riff_size;
  if (!rd(magic, 4) || std::memcmp(magic, "RIFF", 4) != 0) { std::fclose(f); return false; }
  if (!rd(&riff_size, 4)) { std::fclose(f); return false; }
  if (!rd(magic, 4) || std::memcmp(magic, "WAVE", 4) != 0) { std::fclose(f); return false; }

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool got_fmt = false;

  while (rd(magic, 4)) {
    uint32_t chunk_size;
    if (!rd(&chunk_size, 4)) break;
    if (std::memcmp(magic, "fmt ", 4) == 0) {
      std::vector<uint8_t> buf(chunk_size);
      if (!rd(buf.data(), chunk_size)) break;
      format = buf[0] | (buf[1] << 8);
      channels = buf[2] | (buf[3] << 8);
      sample_rate = buf[4] | (buf[5] << 8) | (buf[6] << 16) | ((uint32_t)buf[7] << 24);
      bits = buf[14] | (buf[15] << 8);
      if (format == 0xFFFE && chunk_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        format = buf[24] | (buf[25] << 8);
      }
      got_fmt = true;
    } else if (std::memcmp(magic, "data", 4) == 0) {
      if (!got_fmt || channels == 0) break;
      const int bytes_per = bits / 8;
      long total = chunk_size / bytes_per;
      std::vector<uint8_t> raw(chunk_size);
      size_t got = std::fread(raw.data(), 1, chunk_size, f);
      total = (long)(got / bytes_per);
      out->interleaved.resize(total);
      const uint8_t* d = raw.data();
      if (format == 1 && bits == 16) {
        for (long i = 0; i < total; ++i) {
          int16_t s = (int16_t)(d[2 * i] | (d[2 * i + 1] << 8));
          out->interleaved[i] = s / 32768.0f;
        }
      } else if (format == 1 && bits == 24) {
        for (long i = 0; i < total; ++i) {
          int32_t s = (d[3 * i] << 8) | (d[3 * i + 1] << 16) | ((int32_t)d[3 * i + 2] << 24);
          out->interleaved[i] = (s >> 8) / 8388608.0f;
        }
      } else if (format == 1 && bits == 32) {
        for (long i = 0; i < total; ++i) {
          int32_t s;
          std::memcpy(&s, d + 4 * i, 4);
          out->interleaved[i] = s / 2147483648.0f;
        }
      } else if (format == 3 && bits == 32) {
        out->interleaved.assign((const float*)d, (const float*)d + total);
      } else {
        break;  // unsupported encoding
      }
      out->sample_rate = (int)sample_rate;
      out->channels = channels;
      out->frames = total / channels;
      std::fclose(f);
      return true;
    } else {
      std::fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  return false;
}

// ---------------------------------------------------------------------------
// Polyphase resampling with a Kaiser-windowed sinc filter.
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

static std::vector<double> design_filter(int up, int down, double beta,
                                         int half_len_mult) {
  const int max_rate = up > down ? up : down;
  const double f_c = 1.0 / max_rate;                // normalized cutoff
  const int half_len = half_len_mult * max_rate;    // taps per side
  const int n = 2 * half_len + 1;
  std::vector<double> h(n);
  const double i0b = bessel_i0(beta);
  for (int i = 0; i < n; ++i) {
    const double t = i - half_len;
    const double sinc = t == 0 ? f_c : std::sin(M_PI * f_c * t) / (M_PI * t);
    const double r = 2.0 * i / (n - 1) - 1.0;
    const double win = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = up * sinc * win;
  }
  return h;
}

}  // namespace

extern "C" {

// -> 0 on success; fills sr/channels/frames so the caller can size buffers.
int audio_wav_info(const char* path, int* sr, int* channels, long* frames) {
  WavData w;
  if (!read_wav_file(path, &w)) return 1;
  *sr = w.sample_rate;
  *channels = w.channels;
  *frames = w.frames;
  return 0;
}

// Reads interleaved float32 samples into `out` (capacity frames*channels).
int audio_wav_read(const char* path, float* out, long capacity) {
  WavData w;
  if (!read_wav_file(path, &w)) return 1;
  long n = (long)w.interleaved.size();
  if (n > capacity) n = capacity;
  std::memcpy(out, w.interleaved.data(), n * sizeof(float));
  return 0;
}

// Output length for resample_poly-style resampling.
long audio_resample_out_len(long n, int up, int down) {
  return (n * (long)up + down - 1) / down;
}

// Polyphase resampling of a mono float32 signal. Returns samples written.
long audio_resample(const float* in, long n, int up, int down, float* out,
                    long capacity, double kaiser_beta, int half_len_mult) {
  if (up == down) {
    long m = n < capacity ? n : capacity;
    std::memcpy(out, in, m * sizeof(float));
    return m;
  }
  std::vector<double> h = design_filter(up, down, kaiser_beta, half_len_mult);
  const long c = ((long)h.size() - 1) / 2;
  const long out_len = audio_resample_out_len(n, up, down);
  const long m_max = out_len < capacity ? out_len : capacity;
  for (long m = 0; m < m_max; ++m) {
    // y[m] = sum_j x[j] * h[c + m*down - j*up]
    const long center = m * (long)down;
    long j_lo = (center - c + up - 1) / up;  // ceil((center-c)/up)
    long j_hi = (center + c) / up;           // floor
    if (j_lo < 0) j_lo = 0;
    if (j_hi >= n) j_hi = n - 1;
    double acc = 0.0;
    for (long j = j_lo; j <= j_hi; ++j) {
      acc += in[j] * h[c + center - j * (long)up];
    }
    out[m] = (float)acc;
  }
  return m_max;
}

}  // extern "C"
