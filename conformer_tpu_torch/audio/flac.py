"""Pure-Python FLAC codec: decoder and encoder (counterpart of
conformer_tpu/audio/flac.py, a copy of it).

The fast decoder is the native one (``native/flac.cpp`` in this package,
through ``conformer_tpu_torch.audio.native``); this module is the pure-Python
decoder that ``audio/io.py::read_flac`` falls back to when the native one
rejects a stream, and that decodes uploaded FLAC payloads in memory. The
encoder writes FLAC files (``write_flac``) and test streams that exercise
every decoder path (constant / verbatim / fixed / LPC subframes, Rice + Rice2
+ escape residuals, independent / left-side / right-side / mid-side stereo,
wasted bits), choosing each Rice partition order by its cost.

Format: RFC 9639. Both directions are lossless: integer samples round-trip
bit-exactly, so a FLAC file decodes to the identical float array as the WAV
of the same PCM.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_FIXED_COEF = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))


def _make_crc_table(poly: int, width: int) -> List[int]:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = []
    for byte in range(256):
        c = byte << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table.append(c & mask)
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8_TABLE[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16_TABLE[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Bit I/O (MSB-first)
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # byte position of next unread byte
        self.cache = 0        # low `ncache` bits valid
        self.ncache = 0
        self.ok = True

    def bits(self, n: int) -> int:
        while self.ncache < n:
            if self.pos >= len(self.data):
                self.ok = False
                self.cache <<= 8
            else:
                self.cache = (self.cache << 8) | self.data[self.pos]
                self.pos += 1
            self.ncache += 8
        self.ncache -= n
        v = (self.cache >> self.ncache) & ((1 << n) - 1)
        self.cache &= (1 << self.ncache) - 1
        return v

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        sign = 1 << (n - 1)
        return (v ^ sign) - sign

    def unary(self) -> int:
        q = 0
        while True:
            while self.ncache > 0:
                self.ncache -= 1
                if (self.cache >> self.ncache) & 1:
                    self.cache &= (1 << self.ncache) - 1
                    return q
                q += 1
            if self.pos >= len(self.data):
                self.ok = False
                return q
            self.cache = self.data[self.pos]
            self.pos += 1
            self.ncache = 8

    def align(self) -> None:
        drop = self.ncache & 7
        self.ncache -= drop
        self.cache &= (1 << self.ncache) - 1

    def byte_pos(self) -> int:  # valid only when byte-aligned
        return self.pos - (self.ncache >> 3)

    def at_end(self) -> bool:
        return self.pos >= len(self.data) and self.ncache < 16


class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.cache = 0
        self.ncache = 0

    def bits(self, value: int, n: int) -> None:
        self.cache = (self.cache << n) | (value & ((1 << n) - 1))
        self.ncache += n
        while self.ncache >= 8:
            self.ncache -= 8
            self.buf.append((self.cache >> self.ncache) & 0xFF)
        self.cache &= (1 << self.ncache) - 1

    def unary(self, q: int) -> None:
        self.bits(1, q + 1)  # q zeros then a one

    def align(self) -> None:
        if self.ncache:
            self.bits(0, 8 - self.ncache)

    def bytes_out(self) -> bytes:
        assert self.ncache == 0
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _skip_bytes(br: _BitReader, k: int) -> None:
    """Skip k bytes, draining any cached bits first (br.pos alone runs ahead
    of the logical position while the cache is non-empty)."""
    br.align()
    while k > 0 and br.ncache:
        br.bits(8)
        k -= 1
    br.pos += k


def _read_utf8(br: _BitReader) -> Optional[int]:
    b0 = br.bits(8)
    if b0 < 0x80:
        return b0
    n = None
    for count, mask, val in ((1, 0xE0, 0xC0), (2, 0xF0, 0xE0), (3, 0xF8, 0xF0),
                             (4, 0xFC, 0xF8), (5, 0xFE, 0xFC)):
        if (b0 & mask) == val:
            n, out = count, b0 & (0xFF >> (count + 2))
            break
    else:
        if b0 == 0xFE:
            n, out = 6, 0
        else:
            return None
    for _ in range(n):
        b = br.bits(8)
        if (b & 0xC0) != 0x80:
            return None
        out = (out << 6) | (b & 0x3F)
    return out if br.ok else None


def _read_residual(br: _BitReader, order: int, blocksize: int,
                   out: List[int]) -> bool:
    method = br.bits(2)
    if method > 1:
        return False
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.bits(4)
    nparts = 1 << porder
    if blocksize % nparts:
        return False
    idx = order
    for part in range(nparts):
        count = (blocksize >> porder) - (order if part == 0 else 0)
        if count < 0:
            return False
        param = br.bits(plen)
        if param == escape:
            raw = br.bits(5)
            for _ in range(count):
                out[idx] = br.sbits(raw) if raw else 0
                idx += 1
        else:
            for _ in range(count):
                v = (br.unary() << param) | br.bits(param)
                out[idx] = (v >> 1) ^ -(v & 1)
                idx += 1
        if not br.ok:
            return False
    return idx == blocksize


def _read_subframe(br: _BitReader, blocksize: int, bps: int) -> Optional[List[int]]:
    if br.bits(1) != 0:
        return None
    stype = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = br.unary() + 1
        bps -= wasted
    if bps <= 0:
        return None
    samples: List[int] = [0] * blocksize
    if stype == 0:  # CONSTANT
        v = br.sbits(bps)
        samples = [v] * blocksize
    elif stype == 1:  # VERBATIM
        for i in range(blocksize):
            samples[i] = br.sbits(bps)
    elif (stype & 0x38) == 0x08 and (stype & 0x07) <= 4:  # FIXED
        order = stype & 0x07
        for i in range(order):
            samples[i] = br.sbits(bps)
        if not _read_residual(br, order, blocksize, samples):
            return None
        coef = _FIXED_COEF[order]
        for i in range(order, blocksize):
            samples[i] += sum(c * samples[i - 1 - j] for j, c in enumerate(coef))
    elif stype & 0x20:  # LPC
        order = (stype & 0x1F) + 1
        for i in range(order):
            samples[i] = br.sbits(bps)
        prec = br.bits(4)
        if prec == 0xF:
            return None
        prec += 1
        shift = br.sbits(5)
        if shift < 0:
            return None
        coef = [br.sbits(prec) for _ in range(order)]
        if not _read_residual(br, order, blocksize, samples):
            return None
        for i in range(order, blocksize):
            pred = sum(c * samples[i - 1 - j] for j, c in enumerate(coef))
            samples[i] += pred >> shift
    else:
        return None
    if wasted:
        samples = [s << wasted for s in samples]
    return samples if br.ok else None


def decode_flac_bytes(raw: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory FLAC stream -> (float32 signal, sample_rate).

    Signal is (samples,) for mono, (channels, samples) otherwise — the
    read_wav convention (audio/io.py). Frame CRC-16 is
    verified; a corrupt stream raises ValueError rather than returning
    silently wrong audio.
    """
    if raw[:3] == b"ID3" and len(raw) >= 10:  # skip an ID3v2 prefix
        size = ((raw[6] & 0x7F) << 21) | ((raw[7] & 0x7F) << 14) | \
               ((raw[8] & 0x7F) << 7) | (raw[9] & 0x7F)
        raw = raw[10 + size:]
    br = _BitReader(raw)
    if br.bits(32) != 0x664C6143:  # "fLaC"
        raise ValueError("not a FLAC stream")
    sample_rate = channels = bps = 0
    total = 0
    last = False
    seen_si = False
    while not last and br.ok:
        last = bool(br.bits(1))
        btype = br.bits(7)
        length = br.bits(24)
        if btype == 0:
            if length < 34:
                raise ValueError("short STREAMINFO")
            br.bits(16); br.bits(16)
            br.bits(24); br.bits(24)
            sample_rate = br.bits(20)
            channels = br.bits(3) + 1
            bps = br.bits(5) + 1
            total = br.bits(36)
            _skip_bytes(br, 16 + (length - 34))  # MD5 + extensions
            seen_si = True
        else:
            _skip_bytes(br, length)
    if not (br.ok and seen_si and sample_rate > 0):
        raise ValueError("bad FLAC metadata")

    scale = np.float32(1.0 / (1 << (bps - 1)))
    chans: List[List[int]] = [[] for _ in range(channels)]
    decoded = 0
    while not br.at_end():
        br.align()
        frame_start = br.byte_pos()
        if br.bits(14) != 0x3FFE:
            if total and decoded >= total:
                break
            raise ValueError("lost FLAC frame sync")
        br.bits(2)  # reserved + blocking strategy
        bs_code = br.bits(4)
        sr_code = br.bits(4)
        ch_asgn = br.bits(4)
        ss_code = br.bits(3)
        br.bits(1)
        if _read_utf8(br) is None:
            raise ValueError("bad frame number")
        if bs_code == 0:
            raise ValueError("reserved blocksize code")
        elif bs_code == 1:
            blocksize = 192
        elif bs_code == 6:
            blocksize = br.bits(8) + 1
        elif bs_code == 7:
            blocksize = br.bits(16) + 1
        elif bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        else:
            blocksize = 256 << (bs_code - 8)
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        elif sr_code == 15:
            raise ValueError("invalid sample-rate code")
        br.bits(8)  # header CRC-8 (covered by the frame CRC-16 below)

        if ch_asgn > 10:
            raise ValueError("reserved channel assignment")
        frame_ch = ch_asgn + 1 if ch_asgn < 8 else 2
        if frame_ch != channels:
            raise ValueError("frame/stream channel mismatch")
        frame_bps = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(ss_code)
        if frame_bps is None:
            raise ValueError("reserved sample-size code")

        subs: List[List[int]] = []
        for c in range(channels):
            extra = 1 if (ch_asgn == 8 and c == 1) or (ch_asgn == 9 and c == 0) \
                or (ch_asgn == 10 and c == 1) else 0
            sub = _read_subframe(br, blocksize, frame_bps + extra)
            if sub is None:
                raise ValueError("bad subframe")
            subs.append(sub)
        br.align()
        frame_end = br.byte_pos()
        want = br.bits(16)
        if not br.ok or _crc16(raw[frame_start:frame_end]) != want:
            raise ValueError("FLAC frame CRC mismatch")

        if ch_asgn == 8:       # left/side
            subs[1] = [l - s for l, s in zip(subs[0], subs[1])]
        elif ch_asgn == 9:     # side/right
            subs[0] = [r + s for s, r in zip(subs[0], subs[1])]
        elif ch_asgn == 10:    # mid/side
            left, right = [], []
            for m, s in zip(subs[0], subs[1]):
                m = (m << 1) | (s & 1)
                left.append((m + s) >> 1)
                right.append((m - s) >> 1)
            subs = [left, right]

        emit = blocksize
        if total and decoded + blocksize > total:
            emit = total - decoded
        for c in range(channels):
            chans[c].extend(subs[c][:emit])
        decoded += emit
        if total and decoded >= total:
            break
    if total and decoded != total:
        raise ValueError("truncated FLAC stream")

    arrays = [np.asarray(c, np.float32) * scale for c in chans]
    if channels == 1:
        return arrays[0], sample_rate
    return np.stack(arrays), sample_rate


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Pure-Python FLAC file decode (the fallback of audio/io.py::read_flac)."""
    with open(path, "rb") as f:
        return decode_flac_bytes(f.read())


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _write_utf8(bw: _BitWriter, value: int) -> None:
    if value < 0x80:
        bw.bits(value, 8)
        return
    width = value.bit_length()
    # n continuation bytes: lead byte holds 6-n payload bits (n<6); the
    # 7-byte form (lead 0xFE) holds 36 bits in 6 continuation bytes.
    for n in range(1, 7):
        if width <= (6 - n + 6 * n if n < 6 else 36):
            break
    if n < 6:
        lead = (0xFF << (7 - n)) & 0xFF
        bw.bits(lead | (value >> (6 * n)), 8)
    else:
        bw.bits(0xFE, 8)
    for i in range(n - 1, -1, -1):
        bw.bits(0x80 | ((value >> (6 * i)) & 0x3F), 8)


def _best_rice_param(zig: Sequence[int], plen: int) -> int:
    if not zig:
        return 0
    mean = sum(zig) / len(zig)
    p = 0
    while (1 << (p + 1)) < mean + 1 and p < (1 << plen) - 2:
        p += 1
    return p


def _best_partition_plan(zig: "np.ndarray", blocksize: int,
                         order: int) -> Tuple[int, List[int]]:
    """-> (partition order p, per-partition Rice params) minimizing the
    estimated bit cost. Partition p splits the block into 2^p runs of
    blocksize/2^p samples (the first short by `order` warmup samples)."""
    best = (0, [int(_best_rice_param(zig.tolist(), 5))], float("inf"))
    for p in range(0, 5):
        nparts = 1 << p
        if blocksize % nparts or (blocksize >> p) <= order:
            continue
        size = blocksize >> p
        params, cost = [], 4 * nparts
        idx = 0
        for part in range(nparts):
            count = size - (order if part == 0 else 0)
            seg = zig[idx: idx + count]
            idx += count
            if count == 0:
                params.append(0)
                continue
            k_best, c_best = 0, float("inf")
            for k in range(0, 31):
                c = count * (k + 1) + int(np.sum(seg >> k))
                if c < c_best:
                    k_best, c_best = k, c
                if k > k_best + 2:   # cost is convex in k; stop early
                    break
            params.append(k_best)
            cost += c_best
        if cost < best[2]:
            best = (p, params, cost)
    return best[0], best[1]


def _write_residual(bw: _BitWriter, resid: Sequence[int], blocksize: int,
                    order: int) -> None:
    """Rice-coded residual with a cost-chosen partition order (0..4) and
    per-partition parameters; Rice (4-bit params) when every parameter
    fits, Rice2 (5-bit) otherwise, with the raw escape per partition when
    fixed-width beats Rice."""
    zig = np.fromiter(((abs(r) << 1) - (1 if r < 0 else 0) for r in resid),
                      dtype=np.int64, count=len(resid))
    porder, params = _best_partition_plan(zig, blocksize, order)
    method = 0 if all(k <= 14 for k in params) else 1
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    bw.bits(method, 2)
    bw.bits(porder, 4)
    size = blocksize >> porder
    idx = 0
    for part, k in enumerate(params):
        count = size - (order if part == 0 else 0)
        seg = zig[idx: idx + count]
        rs = resid[idx: idx + count]
        idx += count
        raw = max(int(max((abs(int(r)) for r in rs), default=0)).bit_length()
                  + 1, 1)
        rice_cost = count * (k + 1) + int(np.sum(seg >> k))
        if k >= escape or raw * count + 5 < rice_cost:
            if raw > 31:
                raise ValueError("residual exceeds FLAC escape width")
            bw.bits(escape, plen)
            bw.bits(raw, 5)
            for r in rs:
                bw.bits(int(r) & ((1 << raw) - 1), raw)
        else:
            bw.bits(k, plen)
            mask = (1 << k) - 1
            for z in seg.tolist():
                bw.unary(z >> k)
                bw.bits(z & mask, k)


def _fixed_residual(samples: Sequence[int], order: int) -> List[int]:
    coef = _FIXED_COEF[order]
    return [samples[i] - sum(c * samples[i - 1 - j] for j, c in enumerate(coef))
            for i in range(order, len(samples))]


def _lpc_coefficients(samples: Sequence[int], order: int,
                      precision: int = 15) -> Optional[Tuple[List[int], int]]:
    """Linear-prediction coefficients by solving the Toeplitz normal
    equations directly (order <= 8, so a dense lstsq is trivial), quantized
    to `precision` bits -> (coefficients, shift). Returns None when the
    signal is degenerate (constant / too short). Any valid quantized
    coefficients give a bit-exact round trip — optimality only affects
    compression ratio, so robustness wins over a textbook Levinson here."""
    n = len(samples)
    if n <= order:
        return None
    x = np.asarray(samples, np.float64)
    autoc = np.array([float(np.dot(x[: n - lag], x[lag:]))
                      for lag in range(order + 1)])
    if autoc[0] == 0.0:
        return None
    toeplitz = np.empty((order, order))
    for i in range(order):
        for j in range(order):
            toeplitz[i, j] = autoc[abs(i - j)]
    try:
        lpc = np.linalg.lstsq(toeplitz, autoc[1:], rcond=None)[0]
    except np.linalg.LinAlgError:
        return None
    cmax = float(np.max(np.abs(lpc)))
    if not np.isfinite(cmax) or cmax == 0.0:
        return None
    shift = precision - 2 - int(np.floor(np.log2(cmax)))
    shift = max(0, min(shift, 15))
    q = [int(np.clip(round(c * (1 << shift)),
                     -(1 << (precision - 1)), (1 << (precision - 1)) - 1))
         for c in lpc]
    if not any(q):
        return None
    return q, shift


def _write_subframe(bw: _BitWriter, samples: Sequence[int], bps: int,
                    kind: str) -> None:
    n = len(samples)
    if kind == "auto":
        if n and all(s == samples[0] for s in samples):
            kind = "constant"
        elif n > 16:
            kind = "lpc"
        else:
            kind = "verbatim"
    if kind == "constant":
        if not all(s == samples[0] for s in samples):
            raise ValueError("constant subframe on non-constant data")
        bw.bits(0, 1); bw.bits(0, 6); bw.bits(0, 1)
        bw.bits(samples[0] & ((1 << bps) - 1), bps)
        return
    if kind == "verbatim":
        bw.bits(0, 1); bw.bits(1, 6); bw.bits(0, 1)
        for s in samples:
            bw.bits(s & ((1 << bps) - 1), bps)
        return
    if kind.startswith("fixed"):
        order = int(kind[5:]) if len(kind) > 5 else 2
        order = min(order, n)
        bw.bits(0, 1); bw.bits(0x08 | order, 6); bw.bits(0, 1)
        for i in range(order):
            bw.bits(samples[i] & ((1 << bps) - 1), bps)
        _write_residual(bw, _fixed_residual(samples, order), n, order)
        return
    if kind == "lpc":
        order = min(8, max(1, n - 1))
        got = _lpc_coefficients(samples, order)
        if got is None:  # degenerate: fall back to fixed-2
            _write_subframe(bw, samples, bps, "fixed2" if n > 2 else "verbatim")
            return
        coef, shift = got
        precision = 15
        bw.bits(0, 1); bw.bits(0x20 | (order - 1), 6); bw.bits(0, 1)
        for i in range(order):
            bw.bits(samples[i] & ((1 << bps) - 1), bps)
        bw.bits(precision - 1, 4)
        bw.bits(shift & 0x1F, 5)
        for c in coef:
            bw.bits(c & ((1 << precision) - 1), precision)
        resid = [samples[i] - (sum(c * samples[i - 1 - j]
                                   for j, c in enumerate(coef)) >> shift)
                 for i in range(order, n)]
        _write_residual(bw, resid, n, order)
        return
    raise ValueError(f"unknown subframe kind: {kind}")


_SS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def encode_flac_bytes(signal: np.ndarray, sample_rate: int,
                      bits_per_sample: int = 16, block_size: int = 4096,
                      subframe: str = "auto",
                      stereo: str = "independent") -> bytes:
    """Encode PCM -> a FLAC stream (bytes).

    `signal`: float in [-1, 1] ((samples,) or (channels, samples)) — quantized
    to `bits_per_sample` — or an integer array taken as raw sample values,
    which must fit `bits_per_sample` (ValueError otherwise).
    `subframe`: auto | constant | verbatim | fixed0..fixed4 | lpc.
    `stereo`: independent | left_side | right_side | mid_side (stereo only).
    """
    sig = np.asarray(signal)
    if sig.ndim == 1:
        sig = sig[None, :]
    channels, n = sig.shape
    if not (1 <= channels <= 8):
        raise ValueError("FLAC supports 1..8 channels")
    if not (16 <= block_size <= 65535):
        raise ValueError("block_size must be in [16, 65535] (16-bit "
                         "STREAMINFO/frame fields)")
    if not (1 <= sample_rate < 1 << 20):
        raise ValueError("sample_rate must fit the 20-bit STREAMINFO field")
    if not (4 <= bits_per_sample <= 32):
        raise ValueError("bits_per_sample must be in [4, 32]")
    bps = bits_per_sample
    if np.issubdtype(sig.dtype, np.floating):
        full = 1 << (bps - 1)
        ints = np.clip(np.round(sig * full), -full, full - 1).astype(np.int64)
    else:
        ints = sig.astype(np.int64)
        lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
        if ints.size and (ints.min() < lo or ints.max() > hi):
            raise ValueError(f"integer samples outside [{lo}, {hi}] do not "
                             f"fit {bps} bits per sample")
    if stereo != "independent" and channels != 2:
        raise ValueError("stereo decorrelation requires 2 channels")

    md5 = hashlib.md5()
    bytes_per = bps // 8 if bps % 8 == 0 else None
    if bytes_per:
        inter = np.ascontiguousarray(ints.T).astype(np.int64)
        flat = inter.reshape(-1)
        raw = np.zeros((flat.size, bytes_per), np.uint8)
        v = flat & ((1 << bps) - 1)
        for b in range(bytes_per):
            raw[:, b] = (v >> (8 * b)) & 0xFF
        md5.update(raw.tobytes())

    bw = _BitWriter()
    bw.bits(0x664C6143, 32)  # fLaC
    # STREAMINFO (single, last metadata block).
    bw.bits(1, 1); bw.bits(0, 7); bw.bits(34, 24)
    # Fixed-blocksize stream: min == max == block_size (the final frame may
    # still be shorter — RFC 9639 permits this without reflecting it here).
    bw.bits(block_size, 16)
    bw.bits(block_size, 16)
    bw.bits(0, 24); bw.bits(0, 24)  # min/max framesize unknown
    bw.bits(sample_rate, 20)
    bw.bits(channels - 1, 3)
    bw.bits(bps - 1, 5)
    bw.bits(n & ((1 << 36) - 1), 36)
    digest = md5.digest() if bytes_per else b"\x00" * 16
    for byte in digest:
        bw.bits(byte, 8)

    ch_asgn = {"independent": channels - 1, "left_side": 8,
               "right_side": 9, "mid_side": 10}[stereo]
    ss = _SS_CODE.get(bps, 0)

    for frame_idx, start in enumerate(range(0, n, block_size)):
        block = ints[:, start: start + block_size]
        blocksize = block.shape[1]
        fw = _BitWriter()
        fw.bits(0x3FFE, 14)  # sync
        fw.bits(0, 1)        # reserved
        fw.bits(0, 1)        # fixed blocksize strategy
        fw.bits(7, 4)        # blocksize: 16-bit value-1 follows
        fw.bits(0, 4)        # sample rate: from STREAMINFO
        fw.bits(ch_asgn, 4)
        fw.bits(ss, 3)
        fw.bits(0, 1)
        _write_utf8(fw, frame_idx)
        fw.bits(blocksize - 1, 16)
        header = bytes(fw.buf)
        fw.bits(_crc8(header), 8)

        if stereo == "independent":
            subs = [(block[c].tolist(), bps) for c in range(channels)]
        else:
            left = block[0].tolist()
            right = block[1].tolist()
            side = [l - r for l, r in zip(left, right)]
            if stereo == "left_side":
                subs = [(left, bps), (side, bps + 1)]
            elif stereo == "right_side":
                subs = [(side, bps + 1), (right, bps)]
            else:
                mid = [(l + r) >> 1 for l, r in zip(left, right)]
                subs = [(mid, bps), (side, bps + 1)]
        for data, sub_bps in subs:
            _write_subframe(fw, data, sub_bps, subframe)
        fw.align()
        frame = bytes(fw.buf)
        fw.bits(_crc16(frame), 16)
        for byte in fw.bytes_out():
            bw.bits(byte, 8)

    bw.align()
    return bw.bytes_out()


def write_flac(path: str, signal: np.ndarray, sample_rate: int,
               bits_per_sample: int = 16, block_size: int = 4096,
               subframe: str = "auto", stereo: str = "independent") -> None:
    """Write `signal` to a FLAC file (see encode_flac_bytes)."""
    data = encode_flac_bytes(signal, sample_rate, bits_per_sample, block_size,
                             subframe, stereo)
    with open(path, "wb") as f:
        f.write(data)
