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
