"""The port's host audio I/O against the JAX package's, on the same seeded
inputs:

- the FLAC encoder writes the JAX encoder's bytes, for mono and stereo, 16
  and 24 bits, two block sizes, every subframe type and stereo mode;
- the port's decoders (native C++ and pure Python) give the JAX decoder's
  arrays bit for bit;
- ``read_audio`` and ``decode_audio_bytes`` sniff formats as the JAX ones
  do (ID3-tagged FLAC read, OGG / MP3 / unknown refused with the same
  named errors);
- ``resample`` and ``load_audio`` at 8, 22.05, 44.1 and 48 kHz give the JAX
  package's bits: both run the same polyphase filter (native/audio_io.cpp),
  where the port once ran scipy's ``resample_poly``, up to 2.6e-4 away.
"""

import io
import wave

import numpy as np
import pytest
from scipy.io import wavfile

from conformer_tpu.audio import flac as jflac
from conformer_tpu.audio import io as jio
from conformer_tpu.audio import native as jnative
from conformer_tpu_torch import native as native_build
from conformer_tpu_torch.audio import flac, native
from conformer_tpu_torch.audio import io as tio
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000


def _pcm(channels: int, bps: int, n: int = 9000, seed: int = 0):
    """Seeded integer PCM: a tone over noise per channel, at full scale of
    ``bps`` bits, (samples,) or (channels, samples)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    full = 1 << (bps - 1)
    rows = [0.5 * np.sin(2 * np.pi * (440 + 110 * c) * t)
            + 0.05 * rng.standard_normal(n) for c in range(channels)]
    ints = np.clip(np.round(np.stack(rows) * full), -full, full - 1)
    ints = ints.astype(np.int64)
    return ints[0] if channels == 1 else ints


def _assert_same(got, want):
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


CODEC_CASES = [(ch, bps, block, stereo)
               for ch, stereo in ((1, "independent"), (2, "independent"))
               for bps in (16, 24) for block in (1152, 4096)]
CODEC_CASES += [(2, 16, 4096, mode)
                for mode in ("left_side", "right_side", "mid_side")]


@pytest.mark.parametrize("channels,bps,block,stereo", CODEC_CASES)
def test_flac_bytes_and_decodes_equal_the_jax_codec(tmp_path, channels, bps,
                                                    block, stereo):
    ints = _pcm(channels, bps, seed=channels * 100 + bps)
    raw = flac.encode_flac_bytes(ints, SR, bits_per_sample=bps,
                                 block_size=block, stereo=stereo)
    assert raw == jflac.encode_flac_bytes(ints, SR, bits_per_sample=bps,
                                          block_size=block, stereo=stereo)
    want = jflac.decode_flac_bytes(raw)
    want_scaled = (ints / float(1 << (bps - 1))).astype(np.float32)
    np.testing.assert_array_equal(want[0], want_scaled)
    path = str(tmp_path / "a.flac")
    flac.write_flac(path, ints, SR, bits_per_sample=bps, block_size=block,
                    stereo=stereo)
    with open(path, "rb") as f:
        assert f.read() == raw
    _assert_same(flac.decode_flac_bytes(raw), want)
    _assert_same(flac.read_flac(path), want)
    _assert_same(native.read_flac(path), want)
    _assert_same(tio.read_flac(path), jio.read_flac(path))


@pytest.mark.parametrize("subframe", ["constant", "verbatim", "fixed0",
                                      "fixed2", "fixed4", "lpc"])
def test_flac_subframe_types_equal_the_jax_codec(tmp_path, subframe):
    ints = (np.full(5000, -1234, np.int64) if subframe == "constant"
            else _pcm(1, 16, seed=7))
    raw = flac.encode_flac_bytes(ints, SR, subframe=subframe, block_size=1024)
    assert raw == jflac.encode_flac_bytes(ints, SR, subframe=subframe,
                                          block_size=1024)
    path = tmp_path / "s.flac"
    path.write_bytes(raw)
    want = jflac.decode_flac_bytes(raw)
    _assert_same(native.read_flac(str(path)), want)
    _assert_same(flac.decode_flac_bytes(raw), want)


def test_float_signal_quantises_as_jax_and_wav_and_flac_load_the_same(
        tmp_path):
    """A float signal is quantised by the encoder as the JAX one does, and
    the same PCM loads to the identical array from a WAV and a FLAC."""
    rng = np.random.default_rng(3)
    sig = np.clip(rng.standard_normal(7000) * 0.2, -1, 1)
    raw = flac.encode_flac_bytes(sig, SR)
    assert raw == jflac.encode_flac_bytes(sig, SR)
    (tmp_path / "a.flac").write_bytes(raw)
    ints = np.clip(np.round(sig * 32768), -32768, 32767).astype(np.int16)
    wavfile.write(tmp_path / "a.wav", SR, ints)
    from_flac = tio.load_audio(str(tmp_path / "a.flac"))
    np.testing.assert_array_equal(from_flac,
                                  tio.load_audio(str(tmp_path / "a.wav")))
    np.testing.assert_array_equal(from_flac,
                                  jio.load_audio(str(tmp_path / "a.flac")))


def test_a_corrupt_flac_raises_the_jax_error(tmp_path):
    """The native decoder refuses a stream whose frame CRC fails; the
    fallback decoder then names the fault, as in the JAX package."""
    raw = bytearray(flac.encode_flac_bytes(_pcm(1, 16), SR))
    raw[-40] ^= 0xFF
    path = tmp_path / "bad.flac"
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError) as want:
        jio.read_flac(str(path))
    with pytest.raises(ValueError) as got:
        tio.read_flac(str(path))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        native.read_flac(str(path))


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_the_encoder_refuses_integers_outside_bits_per_sample(bps):
    """An integer sample past [-2^(bps-1), 2^(bps-1) - 1] raises, where the
    JAX encoder masks it to bps bits and the stream decodes as another
    signal (40000 at 16 bits as -0.7793); the edge values round-trip."""
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    edges = np.array([lo, hi, 0, -1, 1, hi, lo] * 4, np.int64)
    raw = flac.encode_flac_bytes(edges, SR, bits_per_sample=bps)
    want = (edges / float(1 << (bps - 1))).astype(np.float32)
    for decoded in (flac.decode_flac_bytes(raw)[0],
                    jflac.decode_flac_bytes(raw)[0]):
        np.testing.assert_array_equal(decoded, want)
    for bad in (hi + 1, lo - 1, 40000 * (1 << (bps - 8))):
        ints = edges.copy()
        ints[3] = bad
        with pytest.raises(ValueError, match="outside"):
            flac.encode_flac_bytes(ints, SR, bits_per_sample=bps)
        with pytest.raises(ValueError, match="outside"):
            flac.encode_flac_bytes(ints.astype(np.int32), SR,
                                   bits_per_sample=bps)
        wrapped = jflac.decode_flac_bytes(
            jflac.encode_flac_bytes(ints, SR, bits_per_sample=bps))[0]
        assert wrapped[3] != np.float32(bad / float(1 << (bps - 1)))
        assert abs(float(wrapped[3])) <= 1.0
    # the float path still clips
    loud = flac.decode_flac_bytes(flac.encode_flac_bytes(
        np.array([2.0, -2.0, 0.5]), SR, bits_per_sample=bps))[0]
    np.testing.assert_array_equal(loud, np.float32([hi, lo, 1 << (bps - 2)])
                                  / np.float32(1 << (bps - 1)))


def _with_channel_code(raw: bytes, code: int) -> bytes:
    """The one-frame stream ``raw`` with its frame header's channel
    assignment set to ``code``, the header's CRC-8 and the frame's CRC-16
    recomputed, so that no checksum is what rejects it."""
    out = bytearray(raw)
    start = 4 + 4 + 34                        # fLaC, STREAMINFO's header, body
    assert out[start] == 0xFF and out[start + 1] & 0xFC == 0xF8
    bs_code, sr_code = out[start + 2] >> 4, out[start + 2] & 0xF
    out[start + 3] = (code << 4) | (out[start + 3] & 0xF)
    crc8 = start + 4 + 1                      # frame 0: a one-byte number
    crc8 += {6: 1, 7: 2}.get(bs_code, 0) + {12: 1, 13: 2, 14: 2}.get(sr_code,
                                                                    0)
    out[crc8] = flac._crc8(bytes(out[start:crc8]))
    out[-2:] = flac._crc16(bytes(out[start:-2])).to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("code", [11, 12, 13, 14, 15])
def test_both_decoders_refuse_a_reserved_channel_assignment(tmp_path, code):
    """Channel codes 11-15 are reserved: the port's Python and native
    decoders raise, where the JAX Python decoder reads the frame as two
    independent channels."""
    ints = _pcm(2, 16, n=1000)
    raw = flac.encode_flac_bytes(ints, SR, block_size=1024)
    good = _with_channel_code(raw, 1)         # independent stereo: as written
    assert good == raw
    bad = _with_channel_code(raw, code)
    path = tmp_path / "reserved.flac"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match="reserved channel assignment"):
        flac.decode_flac_bytes(bad)
    with pytest.raises(ValueError, match="reserved channel assignment"):
        tio.read_flac(str(path))
    with pytest.raises(ValueError, match="unreadable FLAC"):
        native.read_flac(str(path))
    got, sr = jflac.decode_flac_bytes(bad)
    assert sr == SR
    np.testing.assert_array_equal(got, (ints / 32768.0).astype(np.float32))


def _id3(body: bytes, size: int = 21) -> bytes:
    tag = b"ID3\x04\x00\x00" + bytes([0, 0, 0, size]) + b"\x00" * size
    return tag + body


def _wav_bytes(ints: np.ndarray, sr: int = SR) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, ints)
    return buf.getvalue()


PAYLOADS = {
    "wav": lambda: _wav_bytes(_pcm(1, 16).astype(np.int16)),
    "wav_stereo": lambda: _wav_bytes(_pcm(2, 16).T.astype(np.int16).copy()),
    "wav_uint8": lambda: _wav_bytes(
        (np.arange(3000) % 256).astype(np.uint8)),
    "wav_float": lambda: _wav_bytes(
        (_pcm(1, 16) / 40000.0).astype(np.float32)),
    "flac": lambda: flac.encode_flac_bytes(_pcm(1, 16), SR),
    "flac_id3": lambda: _id3(flac.encode_flac_bytes(_pcm(2, 24), SR,
                                                    bits_per_sample=24)),
    "ogg": lambda: b"OggS" + b"\x00" * 60,
    "mp3": lambda: b"\xff\xfb\x90\x00" + b"\x00" * 60,
    "mp3_id3": lambda: _id3(b"\xff\xf3\x90\x00" + b"\x00" * 60),
    "unknown": lambda: b"\x00\x01\x02\x03" * 16,
}


def _outcome(fn, arg):
    try:
        return fn(arg), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_read_audio_and_decode_audio_bytes_sniff_as_jax(tmp_path, kind):
    raw = PAYLOADS[kind]()
    path = str(tmp_path / f"x.{kind}")
    with open(path, "wb") as f:
        f.write(raw)
    for got, want in ((_outcome(tio.read_audio, path),
                       _outcome(jio.read_audio, path)),
                      (_outcome(tio.decode_audio_bytes, raw),
                       _outcome(jio.decode_audio_bytes, raw))):
        assert got[1] == want[1]
        if want[1] is None:
            _assert_same(got[0], want[0])
        else:
            assert kind in ("ogg", "mp3", "mp3_id3", "unknown")
            assert ("not supported" in got[1]) == (kind != "unknown")


def test_native_wav_reader_equals_jax(tmp_path):
    """The native WAV decoder (for files scipy rejects) gives the JAX
    native decoder's arrays, for 16-bit stereo and float32 files."""
    ints = _pcm(2, 16).T.astype(np.int16).copy()
    wavfile.write(tmp_path / "s.wav", SR, ints)
    wavfile.write(tmp_path / "f.wav", 22050,
                  (_pcm(1, 16) / 40000.0).astype(np.float32))
    for name in ("s.wav", "f.wav"):
        path = str(tmp_path / name)
        _assert_same(native.read_wav(path), jnative.read_wav(path))
        _assert_same(tio.read_wav(path), jio.read_wav(path))
    # a 24-bit WAV through the stdlib writer: scipy reads it too, and the
    # native decoder agrees with it
    pcm24 = _pcm(1, 24)
    with wave.open(str(tmp_path / "w24.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(SR)
        w.writeframes(b"".join(int(v).to_bytes(3, "little", signed=True)
                               for v in pcm24))
    path = str(tmp_path / "w24.wav")
    _assert_same(native.read_wav(path), jnative.read_wav(path))
    np.testing.assert_allclose(native.read_wav(path)[0],
                               pcm24 / float(1 << 23), rtol=0, atol=1e-7)


RATES = (8000, 22050, 44100, 48000)


@pytest.mark.parametrize("sr", RATES)
def test_resample_equals_the_jax_package_bit_for_bit(sr):
    """3 s of seeded noise (sigma 0.1), mono and stereo, to 16 kHz and back
    from it: the port's output is the JAX package's, bit for bit."""
    assert jnative.available()   # the JAX package resamples natively here
    rng = np.random.default_rng(sr)
    mono = (rng.standard_normal(3 * sr) * 0.1).astype(np.float32)
    stereo = (rng.standard_normal((2, 2 * sr)) * 0.1).astype(np.float32)
    for sig, a, b in ((mono, sr, SR), (stereo, sr, SR), (mono, SR, sr)):
        got = tio.resample(sig, a, b)
        want = jio.resample(sig, a, b)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.resample(mono, SR, SR), mono)


@pytest.mark.parametrize("sr", RATES)
def test_load_audio_resamples_as_the_jax_package(tmp_path, sr):
    rng = np.random.default_rng(sr + 1)
    sig = np.clip(rng.standard_normal((2, 2 * sr)) * 0.1, -1, 1)
    ints = np.round(sig * 32767).astype(np.int16)
    wavfile.write(tmp_path / "a.wav", sr, ints.T.copy())
    flac.write_flac(str(tmp_path / "a.flac"), ints.astype(np.int64), sr)
    for name in ("a.wav", "a.flac"):
        path = str(tmp_path / name)
        for kwargs in ({}, {"channel": 1}):
            got = tio.load_audio(path, SR, **kwargs)
            want = jio.load_audio(path, SR, **kwargs)
            assert got.shape == want.shape == (2 * SR,)
            np.testing.assert_array_equal(got, want)


def test_the_audio_library_is_built_into_build_not_native():
    path = native_build.lib_path("audio")
    native_build.load("audio")
    assert path.exists() and path.parent.name == "build"
    assert path.name.startswith("libaudio-")
    assert native_build.lib_path("decode").name.startswith("libdecode-")
    assert not (native_build.SRC / "libaudio.so").exists()


def test_a_failed_build_raises_and_nothing_falls_back_to_scipy(
        monkeypatch, tmp_path):
    """With no g++ and no library built, resampling and the native
    decoders raise; the port never resamples with scipy in their place."""
    from conformer_tpu_torch.audio import native as audio_native

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(audio_native, "_LIB", None)
    sig = np.zeros(800, np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tio.resample(sig, 8000, SR)
    np.testing.assert_array_equal(tio.resample(sig, SR, SR), sig)
    flac.write_flac(str(tmp_path / "a.flac"), _pcm(1, 16), SR)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tio.read_flac(str(tmp_path / "a.flac"))
    assert not (tmp_path / "build").exists()
