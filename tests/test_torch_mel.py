"""The port's log-mel frontend and kernel K3's plain version against the JAX
package on the same seeded audio (fp32 on the CPU).

Tolerances: atol 1e-4 on log-mels, as tests/test_pallas.py holds the Pallas
kernel to the XLA frontend; the filterbank, window and DFT constants are
built the same way in float64 and must agree to fp32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.audio import mel as jmel
from conformer_tpu.config import AudioConfig as JAudioConfig
from conformer_tpu.ops.pallas.mel_frontend import logmel_pallas
from conformer_tpu_torch.audio import mel as tmel
from conformer_tpu_torch.config import AudioConfig
from conformer_tpu_torch.ops.cuda import launch_counts
from conformer_tpu_torch.ops.cuda.mel_frontend import logmel_fwd, logmel_plain
from torch_threads import one_torch_thread  # noqa: F401


def _audio(shape, seed=0, amp=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * amp
            ).astype(np.float32)


def test_constants_match():
    cfg = AudioConfig()
    np.testing.assert_array_equal(tmel.hann_window(400), jmel.hann_window(400))
    np.testing.assert_array_equal(
        tmel._dft_matrix(400, tmel.hann_window(400)),
        jmel._dft_matrix(400, jmel.hann_window(400)))
    for scale in ("slaney", "htk"):
        np.testing.assert_array_equal(
            tmel.mel_filterbank(201, 80, 16000, 0.0, 8000.0, "slaney", scale),
            jmel.mel_filterbank(201, 80, 16000, 0.0, 8000.0, "slaney", scale))
    assert cfg == AudioConfig(**JAudioConfig().__dict__)


@pytest.mark.parametrize("impl", ["matmul", "rfft"])
@pytest.mark.parametrize("n", [16000, 7321, 150])
def test_frontend_matches_jax(impl, n):
    audio = _audio((2, n))
    want = jmel.MelFrontend(JAudioConfig(stft_impl=impl))(jnp.asarray(audio))
    got = tmel.MelFrontend(AudioConfig(stft_impl=impl))(torch.from_numpy(audio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_reflect_pad_matches_numpy_for_any_length():
    for n in (1, 2, 5, 150, 401):
        x = _audio((3, n))
        got = tmel.reflect_pad(torch.from_numpy(x), 200).numpy()
        np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (200, 200)),
                                                  mode="reflect"))


def test_frame_lengths_and_auto_dispatch():
    fe = tmel.MelFrontend(AudioConfig())
    assert fe.frame_lengths(torch.tensor([0, 159, 160, 16000])).tolist() == \
        [1, 1, 2, 101]
    assert fe.AUTO_PALLAS_MIN_FRAMES == jmel.MelFrontend.AUTO_PALLAS_MIN_FRAMES
    assert fe.impl_for(1599 * 160 - 1) == "matmul"      # 1599 frames
    assert fe.impl_for(1599 * 160) == "pallas"          # 1600 frames
    assert tmel.MelFrontend(AudioConfig(stft_impl="matmul")).impl_for(
        10 ** 6) == "matmul"


@pytest.mark.parametrize("n,tile", [(16000, 32), (7321, 17)])
def test_kernel_plain_version_matches_pallas_interpret(n, tile):
    """K3's plain version against logmel_pallas in interpret mode, with an
    even and an uneven tile split."""
    cfg = JAudioConfig()
    fe = jmel.MelFrontend(cfg)
    audio = _audio((2, n), seed=1, amp=1.0)
    pad = cfg.n_fft // 2
    padded = np.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = n // cfg.hop_length + 1
    want = logmel_pallas(jnp.asarray(padded), fe._dft, fe._fb, cfg.hop_length,
                         cfg.n_fft, n_frames, cfg.log_clamp_min,
                         frames_per_tile=tile, interpret=True)
    t = tmel.MelFrontend(AudioConfig())
    args = (torch.from_numpy(padded), t._dft, t._fb, cfg.hop_length,
            cfg.n_fft, n_frames, cfg.log_clamp_min)
    before = launch_counts()["logmel_fwd"]
    got = logmel_fwd(*args)
    assert launch_counts()["logmel_fwd"] == before     # CPU: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), logmel_plain(*args).numpy())


def test_kernel_path_of_the_frontend_matches_jax_frontend():
    """stft_impl='pallas' (K3's plain version on the CPU) against the JAX
    frontend's matmul path, batched and unbatched."""
    audio = _audio((2, 9000), seed=2)
    want = jmel.MelFrontend(JAudioConfig(stft_impl="matmul"))(jnp.asarray(audio))
    fe = tmel.MelFrontend(AudioConfig(stft_impl="pallas"))
    np.testing.assert_allclose(fe(torch.from_numpy(audio)).numpy(),
                               np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(fe(torch.from_numpy(audio[0])).numpy(),
                               np.asarray(want)[0], atol=1e-4)


def test_tf32_split_reproduces_the_dft_matrix():
    """K3's 3xTF32 operands: hi and lo are TF32 values (the low 13 mantissa
    bits zero), hi is the DFT matrix rounded to nearest, and hi + lo holds
    it to 2^-21 of each entry (lo rounded to TF32 keeps 11 of lo's bits)."""
    from conformer_tpu_torch.ops.cuda.mel_frontend import split_tf32

    dft = tmel.MelFrontend(AudioConfig())._dft.numpy()
    hi, lo = split_tf32(dft)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(hi - dft) <= np.abs(dft) * 2.0 ** -11).all()
    err = np.abs(hi.astype(np.float64) + lo - dft)
    assert (err <= np.abs(dft) * 2.0 ** -21).all()
    assert np.abs(lo).max() > 0


def _emulate_k3(padded, ops, hop, n_fft, n_frames, n_mels, clamp):
    """K3's sums in float64 from its packed operands, indexed as the kernel
    indexes them: audio in hop rows (step s reads row s // spr, samples
    (s % spr) * 8 + 0..7, zero past the row), B fragments lane 4g + t =
    (depth t and t + 4, column g), interleaved [re | im] columns, and the
    powers of 16-bin chunks against the filterbank's fragments."""
    dft = ops.dft.numpy().astype(np.float64)
    fbf = ops.fb.numpy().astype(np.float64)
    n_chunks, s_pad = ops.n_chunks, ops.s_pad
    spr = -(-hop // 8)
    lanes = dft.reshape(n_chunks, s_pad, 4, 8, 4, 4)      # u, s, j, g, t, 4
    b = np.concatenate([lanes[..., 0] + lanes[..., 2],
                        lanes[..., 1] + lanes[..., 3]], axis=-1)  # .., g, kk
    s = np.arange(s_pad)[:, None]
    col, row = (s % spr) * 8 + np.arange(8)[None, :], s // spr
    idx = (np.arange(n_frames)[:, None, None] + row) * hop + col
    audio = np.pad(padded, ((0, 0), (0, max(0, idx.max() + 1
                                           - padded.shape[1]))))
    a = np.where((col < hop) & (s < ops.n_steps), audio[:, idx], 0.0)
    proj = np.einsum("bfsk,usjgk->bfujg", a, b)
    power = (proj[..., 0::2] ** 2 + proj[..., 1::2] ** 2).reshape(
        len(padded), n_frames, n_chunks * 16)
    m = fbf.reshape(2 * n_chunks, ops.n_mel_tiles, 8, 4, 4)   # m, n, g, t, 4
    fb = np.concatenate([m[..., 0] + m[..., 2], m[..., 1] + m[..., 3]],
                        axis=-1)                               # m, n, g, kk
    fb = fb.transpose(0, 3, 1, 2).reshape(n_chunks * 16, -1)[:, :n_mels]
    return np.log(np.maximum(power @ fb, clamp))


@pytest.mark.parametrize("n_fft,hop,n_mels", [(400, 160, 80), (256, 100, 96)])
def test_k3_operands_are_packed_as_the_kernel_reads_them(n_fft, hop, n_mels):
    """The kernel's view of its packed operands computes the plain
    version's log-mels (1e-4), at the production frontend and at one whose
    hop is not a multiple of 8 (padded k-steps) with a remainder row and
    more than 80 mels (16 mel tiles)."""
    from conformer_tpu_torch.ops.cuda.mel_frontend import k3_operands

    cfg = AudioConfig(n_fft=n_fft, win_length=n_fft, hop_length=hop,
                      n_mels=n_mels)
    fe = tmel.MelFrontend(cfg)
    ops = k3_operands(fe._dft, fe._fb, hop, n_fft)
    assert ops.s_pad % 10 == 0 and ops.n_steps <= ops.s_pad
    assert ops.n_mel_tiles == (10 if n_mels <= 80 else 16)
    audio = _audio((2, 3000), seed=3)
    padded = tmel.reflect_pad(torch.from_numpy(audio), n_fft // 2)
    n_frames = 3000 // hop + 1
    want = logmel_plain(padded, fe._dft, fe._fb, hop, n_fft, n_frames,
                        cfg.log_clamp_min)
    got = _emulate_k3(padded.numpy().astype(np.float64), ops, hop, n_fft,
                      n_frames, n_mels, cfg.log_clamp_min)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4)
