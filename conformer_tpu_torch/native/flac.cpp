// Native FLAC decoder with a C ABI.
//
// A copy of native/flac.cpp: a from-scratch decoder of the FLAC bitstream
// (RFC 9639): STREAMINFO, constant/verbatim/fixed/LPC subframes, Rice and
// Rice2 residual partitions (incl. escape codes), all four channel
// assignments (independent, left/side, right/side, mid/side), wasted bits,
// variable and fixed blocking, 8..32 bits per sample. Frame CRC-16 is
// verified: a decode bug surfaces as a hard error, never as silently wrong
// audio.
//
// Linked with audio_io.cpp into one library by
// conformer_tpu_torch/native/__init__.py::load_audio and bound with ctypes
// by conformer_tpu_torch/audio/native.py; conformer_tpu_torch/audio/flac.py
// is the pure-Python decoder that it is held against.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MSB-first bit reader over an in-memory buffer.
// ---------------------------------------------------------------------------

struct BitReader {
  // MSB-aligned cache: the TOP `ncache` bits of `cache` are the next
  // unread bits. This layout makes Rice unary decoding a single CLZ and
  // n-bit reads a single shift — ~4x the whole-file decode rate of a
  // low-aligned bit-at-a-time reader (tools/bench_audio_io.py).
  const uint8_t* start;
  const uint8_t* p;
  const uint8_t* end;
  uint64_t cache = 0;
  int ncache = 0;
  bool ok = true;

  explicit BitReader(const uint8_t* data, size_t size)
      : start(data), p(data), end(data + size) {}

  inline void fill() {
    if (p + 8 <= end) {
      // One unaligned 8-byte load + bswap instead of up to 7 byte loads.
      uint64_t chunk;
      std::memcpy(&chunk, p, 8);
      chunk = __builtin_bswap64(chunk);
      int take = (64 - ncache) >> 3;   // whole bytes that fit
      cache |= chunk >> ncache;
      p += take;
      ncache += take * 8;
      if (ncache < 64)                 // zero the not-yet-consumed tail
        cache &= ~((1ull << (64 - ncache)) - 1);
      return;
    }
    while (ncache <= 56 && p < end) {
      cache |= (uint64_t)(*p++) << (56 - ncache);
      ncache += 8;
    }
  }

  // n in [0, 56].
  inline uint64_t bits(int n) {
    if (n == 0) return 0;
    if (ncache < n) {
      fill();
      if (ncache < n) { ok = false; ncache = n; }  // past end: pad zeros
    }
    uint64_t v = cache >> (64 - n);
    cache <<= n;
    ncache -= n;
    return v;
  }

  inline int64_t sbits(int n) {
    uint64_t v = bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (int64_t)((v ^ sign) - sign);
  }

  inline uint32_t unary() {
    uint32_t q = 0;
    for (;;) {
      if (ncache == 0) {
        fill();
        if (ncache == 0) { ok = false; return q; }
      }
      if (cache == 0) {  // every cached bit is zero
        q += (uint32_t)ncache;
        ncache = 0;
        continue;
      }
      int lead = __builtin_clzll(cache);
      if (lead >= ncache) {  // the zeros run past the valid cache
        q += (uint32_t)ncache;
        cache = 0;
        ncache = 0;
        continue;
      }
      q += (uint32_t)lead;
      int consume = lead + 1;
      // consume can be 64 (lone set bit at the LSB of a full cache):
      // a 64-bit shift is UB (x86 masks the count), so zero explicitly.
      cache = consume >= 64 ? 0 : cache << consume;
      ncache -= consume;
      return q;
    }
  }

  void align() {
    int drop = ncache & 7;
    cache <<= drop;
    ncache -= drop;
  }

  // Skip k bytes, draining cached bits first (p alone runs ahead of the
  // logical position while the cache is non-empty).
  void skip_bytes(long k) {
    align();
    while (k > 0 && ncache > 0) { bits(8); --k; }
    if (p + k > end) { p = end; ok = false; }
    else p += k;
  }

  size_t byte_pos() const {  // valid only when byte-aligned
    return (size_t)(p - start) - (size_t)(ncache >> 3);
  }
};

// FLAC frame CRCs: CRC-8 poly 0x07, CRC-16 poly 0x8005, both init 0.
// Table-driven: the bit-at-a-time CRC-16 over every frame byte was the
// single hottest loop of the whole decode (~40% of wall).
struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int byte = 0; byte < 256; ++byte) {
      uint16_t c = (uint16_t)(byte << 8);
      for (int b = 0; b < 8; ++b)
        c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
      t[byte] = c;
    }
  }
};

static uint16_t crc16(const uint8_t* d, size_t n) {
  static const Crc16Table table;
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i)
    c = (uint16_t)((c << 8) ^ table.t[(c >> 8) ^ d[i]]);
  return c;
}

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;  // 0 = unknown
};

// Parses "fLaC" magic + metadata blocks; leaves `br` at the first frame.
// Also skips an ID3v2 tag if one prefixes the stream (librosa/audioread
// tolerate tagged files; so do we).
static bool parse_header(BitReader& br, StreamInfo* si) {
  if (br.end - br.p >= 10 && br.p[0] == 'I' && br.p[1] == 'D' && br.p[2] == '3') {
    // ID3v2: 10-byte header, synchsafe 28-bit size.
    uint32_t sz = ((uint32_t)(br.p[6] & 0x7f) << 21) | ((uint32_t)(br.p[7] & 0x7f) << 14) |
                  ((uint32_t)(br.p[8] & 0x7f) << 7) | (br.p[9] & 0x7f);
    if (br.p + 10 + sz > br.end) return false;
    br.p += 10 + sz;
  }
  if (br.bits(32) != 0x664C6143u) return false;  // "fLaC"
  bool last = false, have_si = false;
  while (!last && br.ok) {
    last = br.bits(1) != 0;
    uint32_t type = (uint32_t)br.bits(7);
    uint32_t len = (uint32_t)br.bits(24);
    if (type == 0) {  // STREAMINFO
      if (len < 34) return false;
      br.bits(16); br.bits(16);          // min/max blocksize
      br.bits(24); br.bits(24);          // min/max framesize
      si->sample_rate = (int)br.bits(20);
      si->channels = (int)br.bits(3) + 1;
      si->bps = (int)br.bits(5) + 1;
      si->total_samples = br.bits(36);
      br.skip_bytes(16 + (long)(len - 34));  // MD5 + extensions
      have_si = true;
    } else {
      if (br.p + len > br.end) return false;
      br.skip_bytes((long)len);
    }
  }
  return br.ok && have_si && si->sample_rate > 0;
}

// UTF-8-style coded number (frame or sample index), up to 36 bits / 7 bytes.
static bool read_utf8(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.bits(8);
  int n;
  if (b0 < 0x80) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { n = 1; *out = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { n = 2; *out = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { n = 3; *out = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { n = 4; *out = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { n = 5; *out = b0 & 0x01; }
  else if (b0 == 0xFE) { n = 6; *out = 0; }
  else return false;
  for (int i = 0; i < n; ++i) {
    uint32_t b = (uint32_t)br.bits(8);
    if ((b & 0xC0) != 0x80) return false;
    *out = (*out << 6) | (b & 0x3F);
  }
  return br.ok;
}

// Rice/Rice2 residual into samples[order..blocksize).
static bool read_residual(BitReader& br, int order, int blocksize,
                          int64_t* samples) {
  uint32_t method = (uint32_t)br.bits(2);
  if (method > 1) return false;
  const int plen = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = (uint32_t)br.bits(4);
  uint32_t nparts = 1u << porder;
  if (blocksize % nparts != 0) return false;
  int idx = order;
  for (uint32_t part = 0; part < nparts; ++part) {
    int count = blocksize >> porder;
    if (part == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.bits(plen);
    if (param == escape) {
      uint32_t raw = (uint32_t)br.bits(5);
      for (int i = 0; i < count; ++i)
        samples[idx++] = raw == 0 ? 0 : br.sbits((int)raw);
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br.unary();
        uint64_t v = (q << param) | br.bits((int)param);
        samples[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
      }
    }
    if (!br.ok) return false;
  }
  return idx == blocksize;
}

static const int kFixedCoef[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

static bool read_subframe(BitReader& br, int blocksize, int bps,
                          int64_t* samples) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = (uint32_t)br.bits(6);
  int wasted = 0;
  if (br.bits(1)) { wasted = (int)br.unary() + 1; bps -= wasted; }
  if (bps <= 0) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) samples[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) samples[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED 0..4
    int order = (int)(type & 0x07);
    for (int i = 0; i < order; ++i) samples[i] = br.sbits(bps);
    if (!read_residual(br, order, blocksize, samples)) return false;
    const int* c = kFixedCoef[order];
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += (int64_t)c[j] * samples[i - 1 - j];
      samples[i] += pred;
    }
  } else if (type & 0x20) {  // LPC, order 1..32
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) samples[i] = br.sbits(bps);
    uint32_t prec = (uint32_t)br.bits(4);
    if (prec == 0xF) return false;
    ++prec;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.sbits((int)prec);
    if (!read_residual(br, order, blocksize, samples)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * samples[i - 1 - j];
      samples[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) samples[i] <<= wasted;
  return br.ok;
}

struct FlacData {
  StreamInfo si;
  std::vector<float> interleaved;
  long frames = 0;  // samples per channel
};

static bool decode_file(const char* path, FlacData* out, bool header_only) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)(size > 0 ? size : 0));
  if (size <= 0 || std::fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  BitReader br(buf.data(), buf.size());
  if (!parse_header(br, &out->si)) return false;
  if (header_only && out->si.total_samples > 0) {
    out->frames = (long)out->si.total_samples;
    return true;
  }

  const int nch = out->si.channels;
  const float scale = 1.0f / (float)(1u << (out->si.bps - 1));
  if (out->si.total_samples > 0)
    out->interleaved.reserve((size_t)out->si.total_samples * nch);
  std::vector<std::vector<int64_t>> ch((size_t)nch);
  uint64_t decoded = 0;

  while (br.p < br.end || br.ncache >= 16) {
    br.align();
    size_t frame_start = br.byte_pos();
    // Sync: 14 bits 0b11111111111110.
    if (br.bits(14) != 0x3FFE) {
      // Tolerate trailing garbage only once all declared samples are in.
      if (out->si.total_samples > 0 && decoded >= out->si.total_samples) break;
      return false;
    }
    br.bits(1);                                     // reserved
    br.bits(1);                                     // blocking strategy
    uint32_t bs_code = (uint32_t)br.bits(4);
    uint32_t sr_code = (uint32_t)br.bits(4);
    uint32_t ch_asgn = (uint32_t)br.bits(4);
    uint32_t ss_code = (uint32_t)br.bits(3);
    br.bits(1);                                     // reserved
    uint64_t coded_num;
    if (!read_utf8(br, &coded_num)) return false;

    int blocksize;
    switch (bs_code) {
      case 0: return false;
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default:
        blocksize = bs_code <= 5 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return false;
    br.bits(8);  // header CRC-8 (covered by the frame CRC-16 check below)

    if (ch_asgn > 10) return false;                 // reserved assignments
    int frame_ch = ch_asgn < 8 ? (int)ch_asgn + 1 : 2;
    if (frame_ch != nch) return false;
    int bps;
    switch (ss_code) {
      case 0: bps = out->si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return false;
    }

    for (int c = 0; c < nch; ++c) {
      ch[(size_t)c].resize((size_t)blocksize);
      int sub_bps = bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        ++sub_bps;  // side channel carries one extra bit
      if (!read_subframe(br, blocksize, sub_bps, ch[(size_t)c].data()))
        return false;
    }
    br.align();
    size_t frame_end = br.byte_pos();
    uint16_t want = (uint16_t)br.bits(16);
    if (!br.ok) return false;
    if (crc16(buf.data() + frame_start, frame_end - frame_start) != want)
      return false;

    // Stereo decorrelation (reference semantics: independent reconstruction
    // identical to libFLAC).
    if (ch_asgn == 8) {        // left/side: R = L - S
      for (int i = 0; i < blocksize; ++i) ch[1][(size_t)i] = ch[0][(size_t)i] - ch[1][(size_t)i];
    } else if (ch_asgn == 9) { // right/side: L = R + S
      for (int i = 0; i < blocksize; ++i) ch[0][(size_t)i] = ch[1][(size_t)i] + ch[0][(size_t)i];
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][(size_t)i], side = ch[1][(size_t)i];
        mid = (mid << 1) | (side & 1);
        ch[0][(size_t)i] = (mid + side) >> 1;
        ch[1][(size_t)i] = (mid - side) >> 1;
      }
    }

    int emit = blocksize;
    if (out->si.total_samples > 0 &&
        decoded + (uint64_t)blocksize > out->si.total_samples)
      emit = (int)(out->si.total_samples - decoded);  // final partial block
    size_t base = out->interleaved.size();
    out->interleaved.resize(base + (size_t)emit * (size_t)nch);
    float* dst = out->interleaved.data() + base;
    for (int c = 0; c < nch; ++c) {
      const int64_t* src = ch[(size_t)c].data();
      float* d = dst + c;
      for (int i = 0; i < emit; ++i) d[(size_t)i * nch] = (float)src[i] * scale;
    }
    decoded += (uint64_t)emit;
    if (out->si.total_samples > 0 && decoded >= out->si.total_samples) break;
    (void)coded_num;
  }
  out->frames = (long)decoded;
  return out->si.total_samples == 0 || decoded == out->si.total_samples;
}

}  // namespace

extern "C" {

// -> 0 on success; fills sr/channels/frames so the caller can size buffers.
// Header-only when STREAMINFO declares a total; full decode otherwise.
int audio_flac_info(const char* path, int* sr, int* channels, long* frames) {
  FlacData d;
  if (!decode_file(path, &d, /*header_only=*/true)) return 1;
  *sr = d.si.sample_rate;
  *channels = d.si.channels;
  *frames = d.frames;
  return 0;
}

// Reads interleaved float32 samples (scaled by 2^-(bps-1), matching the
// WAV path's int scaling in audio_io.cpp) into `out`.
int audio_flac_read(const char* path, float* out, long capacity) {
  FlacData d;
  if (!decode_file(path, &d, /*header_only=*/false)) return 1;
  long n = (long)d.interleaved.size();
  if (n > capacity) n = capacity;
  std::memcpy(out, d.interleaved.data(), (size_t)n * sizeof(float));
  return 0;
}

}  // extern "C"
