"""The port's host CTC beam search and n-gram LMs against the JAX package on
the CPU.

- the ARPA from the port's native builder is the JAX one byte for byte, at
  orders 3 and 5, on the corpus of tests/test_lm_beam.py;
- the port's native and plain Python scorers give the JAX scores on seeded
  contexts (each scorer the same floats as its JAX counterpart);
- the port's native decoder and its Python one (the plain version) give the
  JAX decoder's texts on the seeded log-probs of tests/test_lm_beam.py's
  ``TestNativeBeamParity``, at its three operating points (beam 16; 24 with
  the LM; 190 with the LM and hotwords), and ``BeamStream`` fed in chunks
  gives the JAX stream's text after every chunk;
- ``cli.create_lm`` writes the JAX CLI's files;
- ``InferencePipeline(decode="beam", device="cpu")`` at ``ModelConfig.tiny``
  with the JAX pipeline's weights gives its texts, WER and CER at beam 16
  with the LM;
- ``beam_auto`` resolves as the JAX package resolves it (the host beam on
  the CPU, the device beam on a CUDA device), and
  ``InferencePipeline(decode="beam_device", device="cpu")`` (the port's
  eager device search, word LM and a hotword, W 8) gives the JAX
  pipeline's texts, WER and CER.
"""

import csv
import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.cli import create_lm as j_create_lm
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import DecodeConfig as JDecodeConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.decode.beam_search import BeamSearchDecoder as JDecoder
from conformer_tpu.lm import ngram as jngram
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.cli import create_lm
from conformer_tpu_torch.config import Config, DecodeConfig
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.decode.beam_search import BeamSearchDecoder
from conformer_tpu_torch.decode.pipeline import (InferencePipeline,
                                                 resolve_beam_backend)
from conformer_tpu_torch.lm.ngram import NgramLM, PyNgramLM, build_arpa
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = ["XIN CHÀO", "XIN CHÀO BẠN", "CẢM ƠN BẠN", "TẠM BIỆT", "XIN LỖI",
          "CHÀO BẠN"] * 5
# TestNativeBeamParity's operating points (tests/test_lm_beam.py)
OPERATING_POINTS = [
    dict(beam_width=16),
    dict(beam_width=24, alpha=2.1, beta=9.2, beam_prune_logp=-20.0,
         token_min_logp=-5.0, use_lm=True),
    dict(beam_width=190, alpha=2.1, beta=9.2, beam_prune_logp=-20.0,
         use_lm=True, hotwords=("XIN CHÀO", "BẠN"), hotword_weight=9.0),
]


@pytest.fixture(scope="module")
def vi():
    return load_tokenizer("vi")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    path.write_text("\n".join(CORPUS), encoding="utf8")
    return str(path)


@pytest.fixture(scope="module")
def arpa(corpus, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "lm.arpa")
    build_arpa(corpus, path, order=3)
    return path


@pytest.mark.parametrize("order", [3, 5])
def test_arpa_is_the_jax_arpa_byte_for_byte(corpus, tmp_path, order):
    ours, theirs = tmp_path / "port.arpa", tmp_path / "jax.arpa"
    build_arpa(corpus, str(ours), order=order)
    jngram.build_arpa(corpus, str(theirs), order=order)
    assert ours.read_bytes() == theirs.read_bytes()
    assert f"\\{order}-grams:" in ours.read_text(encoding="utf8")


def _contexts(rng, words, n=40):
    return [([str(w) for w in rng.choice(words, size=rng.integers(0, 4))],
             str(rng.choice(words))) for _ in range(n)]


def test_lm_scores_equal_the_jax_scores(arpa):
    """Each scorer gives its JAX counterpart's floats, OOV words and
    contexts past the order included; native and Python agree to 1e-5."""
    words = ["XIN", "CHÀO", "BẠN", "CẢM", "ƠN", "TẠM", "BIỆT", "LỖI", "</s>",
             "<s>", "ZZZ"]
    cases = _contexts(np.random.default_rng(3), words)
    native, plain = NgramLM(arpa), NgramLM(arpa, native=False)
    j_native, j_plain = jngram.NgramLM(arpa), jngram.PyNgramLM(arpa)
    assert isinstance(plain._py, PyNgramLM)
    assert native.order == plain.order == j_native.order == 3
    for ctx, w in cases:
        got = native.score_word(ctx, w)
        assert got == j_native.score_word(ctx, w)
        py = plain.score_id([plain.vocab_id(x) for x in ctx], plain.vocab_id(w))
        assert py == j_plain.score_id([j_plain.vocab.get(x, -1) for x in ctx],
                                      j_plain.vocab.get(w, -1))
        assert py == pytest.approx(got, abs=1e-5)
    for sentence in (["XIN", "CHÀO", "BẠN"], ["TẠM", "ZZZ"], []):
        assert native.sentence_logprob(sentence) == \
            j_native.sentence_logprob(sentence)


def _random_lp(tok, rng, t=40):
    """TestNativeBeamParity._random_lp: a random token path with noise."""
    v = tok.vocab_size
    lp = rng.normal(-6.0, 1.5, size=(t, v)).astype(np.float32)
    path = rng.integers(0, v, size=t)
    lp[np.arange(t), path] += rng.uniform(2.0, 6.0, size=t)
    lp[rng.uniform(size=t) < 0.3, tok.pad_id] += 5.0
    return (lp - np.log(np.exp(lp).sum(1, keepdims=True))).astype(np.float32)


def _configs(cfg_kwargs, arpa):
    kw = dict(cfg_kwargs)
    if kw.pop("use_lm", False):
        kw["lm_path"] = arpa
    return DecodeConfig(**kw), JDecodeConfig(**kw)


@pytest.mark.parametrize("cfg_kwargs", OPERATING_POINTS)
def test_decoders_give_the_jax_texts(vi, arpa, cfg_kwargs):
    cfg, jcfg = _configs(cfg_kwargs, arpa)
    rng = np.random.default_rng(0)
    batch = np.stack([_random_lp(vi, rng) for _ in range(6)])
    lengths = rng.integers(20, 41, size=6).astype(np.int32)
    want = JDecoder(j_load_tokenizer("vi"), jcfg).decode_batch(batch, lengths)
    native = BeamSearchDecoder(vi, cfg)
    plain = BeamSearchDecoder(vi, cfg, native=False)
    assert native._native is not None and plain._native is None
    assert native.decode_batch(batch, lengths) == want
    assert plain.decode_batch(batch, lengths) == want
    assert native.decode(batch[0], lengths[0]) == want[0]


@pytest.mark.parametrize("native", [True, False])
def test_stream_gives_the_jax_stream_texts(vi, arpa, native):
    cfg, jcfg = _configs(dict(beam_width=32, alpha=2.1, beta=9.2,
                              beam_prune_logp=-20.0, use_lm=True,
                              hotwords=("BẠN",), hotword_weight=9.0), arpa)
    lp = _random_lp(vi, np.random.default_rng(7), t=30)
    ours = BeamSearchDecoder(vi, cfg, native=native).stream()
    theirs = JDecoder(j_load_tokenizer("vi"), jcfg).stream()
    for i in range(0, 30, 7):
        ours.feed(lp[i:i + 7])
        theirs.feed(lp[i:i + 7])
        assert ours.text() == theirs.text()
    assert ours.text() == BeamSearchDecoder(vi, cfg).decode(lp)


def test_the_plain_decoder_scores_with_the_python_lm(vi, arpa):
    """native=False keeps native code off the whole path: its LM is the
    Python scorer, whose scores are the native one's."""
    cfg = DecodeConfig(beam_width=8, lm_path=arpa)
    dec = BeamSearchDecoder(vi, cfg, native=False)
    assert dec._native is None and isinstance(dec.lm._py, PyNgramLM)
    assert dec.lm._native is None
    assert BeamSearchDecoder(vi, DecodeConfig(beam_width=8),
                             native=False).lm is None
    words = ["XIN", "CHÀO", "BẠN"]
    assert dec.lm.sentence_logprob(words) == pytest.approx(
        NgramLM(arpa).sentence_logprob(words), abs=1e-5)


def test_create_lm_writes_the_jax_files(corpus, tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    args = ["--text", corpus, "--order", "4", "--token-level",
            "--token-order", "3"]
    create_lm.main(args + ["--out", str(ours)])
    j_create_lm.main(args + ["--out", str(theirs)])
    names = ("lm_text.txt", "lexicon.txt", "lm.arpa", "lm_tokens.txt",
             "lm_tokens.arpa")
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    assert sorted(p.name for p in ours.iterdir()) == sorted(names)


# ---------------------------------------------------------------------------
# The pipeline with decode="beam"

TEXTS = ["xin chào", "xin chào bạn", "cảm ơn bạn", "tạm biệt", "xin lỗi"]
SECONDS = [0.6, 0.9, 0.8, 0.95, 0.5]   # one 1 s bucket: one JAX compile
OVERRIDES = {"optim.compute_dtype": "float32", "data.batch_size": 2,
             "data.bucket_boundaries_s": [1.0, 2.0], "data.max_audio_s": 2.0,
             "data.num_workers": 0, "decode.beam_width": 16}


def _manifest(directory):
    rng = np.random.default_rng(12)
    path = directory / "eval.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, (sec, text) in enumerate(zip(SECONDS, TEXTS)):
            wav = directory / f"b{i}.wav"
            sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), text])
    return str(path)


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _variables():
    """The tiny model's flax-initialised weights (the pipeline's key 0),
    compiled once."""
    jcfg = JConfig(model=JModelConfig.tiny(370)).override(**OVERRIDES)
    return jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))(
        jax.random.PRNGKey(0))


def _reference(directory, arpa, decode="beam", **overrides):
    """(port config, port state dict, JAX metrics, JAX pairs): the JAX
    pipeline with seeded random weights, ``decode`` with the LM."""
    jcfg = JConfig(model=JModelConfig.tiny(370)).override(**OVERRIDES)
    jcfg = jcfg.override(**{"train.checkpoint_dir": str(directory / "none"),
                            "decode.lm_path": arpa, **overrides})
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: _variables()):
        pipe = jpipeline.InferencePipeline(jcfg, j_load_tokenizer("vi"),
                                           decode=decode)
    metrics, pairs = pipe.evaluate(str(directory / "eval.csv"))
    variables = {"params": pipe.state.params,
                 "batch_stats": pipe.state.batch_stats}
    tcfg = Config.from_dict(jcfg.to_dict())
    return tcfg, flax_to_state_dict(variables, tcfg.model), metrics, pairs


@pytest.fixture(scope="module")
def jax_host_beam(arpa, tmp_path_factory):
    """(manifest, port config, weights file, JAX metrics, JAX pairs) of the
    JAX pipeline with decode="beam" (the LM, W 16)."""
    directory = tmp_path_factory.mktemp("beam_eval")
    manifest = _manifest(directory)
    tcfg, state, metrics, pairs = _reference(directory, arpa)
    weights = directory / "w.pt"
    torch.save(state, weights)
    return manifest, tcfg, weights, metrics, pairs


def test_pipeline_beam_with_lm_matches_the_jax_pipeline(jax_host_beam, vi):
    manifest, tcfg, weights, want_metrics, want_pairs = jax_host_beam
    pipe = InferencePipeline(tcfg, vi, weights=str(weights), decode="beam",
                             device="cpu")
    assert pipe._beam is not None and pipe._beam._native is not None
    metrics, pairs = pipe.evaluate(manifest)
    assert pairs == want_pairs and len(pairs) == len(TEXTS)
    assert metrics["wer"] == want_metrics["wer"]
    assert metrics["cer"] == want_metrics["cer"]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)
    assert all(b["decode_s"] <= b["seconds"] for b in pipe.batch_log)


@pytest.fixture(scope="module")
def jax_device_beam(arpa, tmp_path_factory):
    """(manifest, port config, weights file, JAX metrics, JAX pairs) of the
    JAX pipeline with decode="beam_device" (word LM, a hotword, W 8)."""
    directory = tmp_path_factory.mktemp("device_beam")
    manifest = _manifest(directory)
    over = {"decode.beam_width": 8, "decode.hotwords": ("XIN CHÀO",)}
    tcfg, state, metrics, pairs = _reference(directory, arpa,
                                             decode="beam_device", **over)
    weights = directory / "w.pt"
    torch.save(state, weights)
    return manifest, tcfg, weights, metrics, pairs


def test_device_beam_raises_where_the_jax_package_would_take_it(
        jax_device_beam, vi):
    """beam_auto picks the backend as the JAX resolve_beam_backend does:
    the host beam on the CPU, the device beam on an accelerator. The
    device beam no longer raises: ``decode="beam_device"`` on the CPU runs
    the port's eager search (word LM from decode.lm_path, a hotword, W 8)
    and gives the JAX pipeline's texts, WER, CER and loss."""
    assert resolve_beam_backend(torch.device("cpu")) == "beam" == \
        jpipeline.resolve_beam_backend(n_devices=1)
    assert resolve_beam_backend(torch.device("cuda")) == "beam_device"
    manifest, tcfg, weights, want_metrics, want_pairs = jax_device_beam
    pipe = InferencePipeline(tcfg, vi, weights=str(weights),
                             decode="beam_device", device="cpu")
    assert pipe._device_beam is not None and pipe._beam is None
    metrics, pairs = pipe.evaluate(manifest)
    assert pairs == want_pairs and len(pairs) == len(TEXTS)
    assert metrics["wer"] == want_metrics["wer"]
    assert metrics["cer"] == want_metrics["cer"]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)
