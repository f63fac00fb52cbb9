"""The port's streaming CTC transcriber against the JAX package's on the CPU.

``ModelConfig.tiny`` in fp32, dropout off, the JAX weights carried across by
``conformer_tpu_torch.convert``; seeded tone-over-noise audio:

- greedy and host-beam (a small ARPA, beam 16) texts of single-chunk and
  multi-chunk utterances equal JAX ``StreamingTranscriber``'s, and so do
  ``cli.infer --streaming --device cpu``'s;
- feeding granularity changes nothing, pipelined emission equals the
  synchronous one, ``reset`` clears every carried state;
- a single-chunk utterance gives the offline pipeline's text;
- ``beam_auto`` is the host beam search, as the JAX package resolves it for a
  stream; ``beam_device`` (the device search, word LM, W 8) gives the JAX
  transcriber's texts whatever the block size, also through ``cli.infer
  --streaming``; a transducer's ``beam_device`` is its beam (its greedy
  streams are held against the JAX package and its beam stream runs in
  test_torch_transducer.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import DecodeConfig as JDecodeConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.decode.streaming import \
    StreamingTranscriber as JStreamingTranscriber
from conformer_tpu.lm.ngram import build_arpa as j_build_arpa
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.config import Config, DecodeConfig
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.decode import streaming
from conformer_tpu_torch.decode.pipeline import InferencePipeline
from conformer_tpu_torch.decode.streaming import StreamingTranscriber
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
# One window shape for every JAX run (1 s of context + 1 s chunks): one
# compile per decode mode.
CHUNK_S, CONTEXT_S = 1.0, 1.0
SECONDS = {"single": 0.8, "multi": 2.3, "long": 3.2}


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 300 * t)
            + 0.1 * rng.standard_normal(len(t))).astype(np.float32)


AUDIO = {name: _audio(sec, seed=i) for i, (name, sec) in
         enumerate(SECONDS.items())}


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _jax_model():
    jcfg = JConfig(model=JModelConfig.tiny(370)).override(
        **{"optim.compute_dtype": "float32"})
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return jcfg, init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    root = tmp_path_factory.mktemp("streamlm")
    corpus = root / "c.txt"
    corpus.write_text("\n".join(["XIN CHÀO", "CẢM ƠN BẠN", "TẠM BIỆT"] * 5),
                      encoding="utf8")
    path = str(root / "lm.arpa")
    j_build_arpa(str(corpus), path, order=3)
    return path


def _decode_cfgs(arpa):
    kw = dict(beam_width=16, lm_path=arpa, alpha=0.8, beta=1.0)
    return JDecodeConfig(**kw), DecodeConfig(**kw)


@pytest.fixture(scope="module")
def reference(arpa):
    """JAX texts of every utterance, greedy and beam, each decoded by one
    transcriber reset between utterances."""
    jcfg, variables = _jax_model()
    tok = j_load_tokenizer("vi")
    jdec, _ = _decode_cfgs(arpa)
    texts = {}
    for mode in ("greedy", "beam"):
        st = JStreamingTranscriber(jcfg, tok, variables, chunk_s=CHUNK_S,
                                   left_context_s=CONTEXT_S, decode=mode,
                                   decode_cfg=jdec)
        for name, audio in AUDIO.items():
            st.reset()
            st.feed(audio)
            st.finish()
            texts[mode, name] = st.text
    return texts


@pytest.fixture(scope="module")
def port():
    """(port config, the tiny model with the JAX weights, tokenizer)."""
    jcfg, variables = _jax_model()
    cfg = Config.from_dict(jcfg.to_dict()).override(
        **{"model.vocab_size": 370})
    model = Conformer(cfg.model, "float32")
    model.load_state_dict(flax_to_state_dict(variables, cfg.model))
    return cfg, model.eval(), load_tokenizer("vi")


def _transcriber(port, mode="greedy", arpa=None, **kw):
    cfg, model, tok = port
    dcfg = _decode_cfgs(arpa)[1] if arpa else None
    return StreamingTranscriber(cfg, tok, model,
                                chunk_s=kw.pop("chunk_s", CHUNK_S),
                                left_context_s=CONTEXT_S, decode=mode,
                                decode_cfg=dcfg, **kw)


def _run(st, audio, block=None):
    st.reset()
    emitted = ""
    block = block or len(audio)
    for i in range(0, len(audio), block):
        emitted += st.feed(audio[i: i + block])
    emitted += st.finish()
    return emitted, st.text


@pytest.mark.parametrize("name", sorted(SECONDS))
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_texts_equal_the_jax_transcriber(port, reference, arpa, mode, name):
    st = _transcriber(port, mode, arpa)
    emitted, text = _run(st, AUDIO[name])
    assert text == reference[mode, name]
    assert text.strip()
    if mode == "beam":
        assert emitted == text           # finish() returns the hypothesis
        assert st.feed(AUDIO[name]) == ""    # beam hypotheses are revisable


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_block_size_does_not_matter(port, reference, arpa, mode):
    st = _transcriber(port, mode, arpa)
    audio = AUDIO["multi"]
    texts = {_run(st, audio, block)[1] for block in (1000, 7777, len(audio))}
    assert texts == {reference[mode, "multi"]}


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_pipelined_emission_equals_the_synchronous_one(port, arpa, mode):
    audio = AUDIO["long"]
    sync = _run(_transcriber(port, mode, arpa, pipeline_chunks=False), audio,
                4000)
    piped_st = _transcriber(port, mode, arpa)
    piped_st.reset()
    first = piped_st.feed(audio[: int(1.5 * SR)])
    piped = _run(piped_st, audio, 4000)
    assert piped == sync
    # one chunk in and nothing drained yet: emission lags one chunk
    assert first == ""


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_reset_clears_the_carried_state(port, arpa, mode):
    st = _transcriber(port, mode, arpa)
    first = _run(st, AUDIO["multi"])[1]
    st.reset()
    st.feed(AUDIO["long"][: int(1.5 * SR)])   # left mid-utterance
    assert _run(st, AUDIO["multi"])[1] == first
    assert _run(st, AUDIO["single"])[1] != first


def test_a_single_chunk_gives_the_offline_text(port, tmp_path):
    cfg, model, tok = port
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    pipe = InferencePipeline(cfg, tok, weights=str(weights), device="cpu")
    audio = AUDIO["single"]
    st = pipe.streaming_transcriber(chunk_s=2.0, left_context_s=4.0)
    _run(st, audio)
    # offline, padded to the same window
    window = np.zeros((1, 6 * SR), np.float32)
    window[0, : len(audio)] = audio
    assert st.text == pipe.transcribe_batch(window, np.array([len(audio)]))[0]


def test_kept_windows_are_the_offline_log_probs(port, tmp_path):
    """``keep_windows`` keeps each window's log-softmax to its frame length;
    on one window it is the offline run's (``keep_outputs``) on the same
    padded window, bit for bit."""
    cfg, model, tok = port
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    pipe = InferencePipeline(cfg, tok, weights=str(weights), device="cpu")
    audio = AUDIO["single"]
    st = StreamingTranscriber(cfg, tok, pipe.model, pipe.frontend,
                              chunk_s=CHUNK_S, left_context_s=CONTEXT_S,
                              keep_windows=True)
    _run(st, audio)
    window = np.zeros((1, st.ctx + st.chunk), np.float32)
    window[0, : len(audio)] = audio
    pipe.keep_outputs = True
    pipe.run_batch(window, np.array([len(audio)]))
    kept = pipe.batch_log[-1]
    assert np.array_equal(kept["audio"], window)
    assert list(kept["audio_lengths"]) == [len(audio)]
    t = int(kept["lengths"][0])
    assert len(st.windows) == 1 and st.windows[0].shape[0] == t
    assert torch.equal(st.windows[0], kept["log_probs"][0, :t])
    _run(st, AUDIO["long"])              # reset() clears them; one a chunk
    assert len(st.windows) == -(-len(AUDIO["long"]) // st.chunk)


def test_cli_infer_streaming_equals_the_jax_transcriber(port, reference,
                                                        arpa, tmp_path,
                                                        capsys):
    from conformer_tpu_torch.cli.infer import main

    cfg, model, _ = port
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    config = tmp_path / "c.json"
    cfg.to_json(str(config))
    paths = []
    for name in ("single", "multi"):
        path = tmp_path / f"{name}.wav"
        wavfile.write(path, SR, AUDIO[name])    # float32 WAV: the same signal
        paths.append(str(path))
    stream = ["--stream-chunk-seconds", str(CHUNK_S),
              "--stream-context-seconds", str(CONTEXT_S)]
    common = ["--audio", *paths, "--config", str(config), "--weights",
              str(weights), "--device", "cpu", "--streaming", *stream]
    main(common)
    main(common + ["--lm", arpa, "--decode", "beam", "--set",
                   "decode.beam_width=16", "--set", "decode.alpha=0.8",
                   "--set", "decode.beta=1.0"])
    lines = capsys.readouterr().out.splitlines()
    got = [ln.split("\t", 1)[1] for ln in lines if "\t" in ln]
    assert got == [reference["greedy", "single"], reference["greedy", "multi"],
                   reference["beam", "single"], reference["beam", "multi"]]


def test_beam_auto_is_the_host_beam_for_a_stream(port, arpa):
    assert jpipeline.resolve_beam_backend(streaming=True) == "beam"
    cfg = port[0]
    assert streaming.resolve_streaming_decode(cfg, "beam_auto") == "beam"
    assert _transcriber(port, "beam_auto", arpa).decode == "beam"
    with pytest.raises(ValueError, match="beam_auto"):
        _transcriber(port, "nonsense")


def test_beam_auto_follows_the_mesh_for_a_stream(monkeypatch):
    """resolve_streaming_decode / resolve_beam_backend(mesh=, streaming=)
    against the JAX resolve_beam_backend's answers (conformer_tpu/decode/
    pipeline.py:58-88): under a mesh a stream's beam_auto is the device
    beam, on the CPU and on an accelerator alike; without one, the host
    beam; a batch's is the device beam under a mesh or on an
    accelerator."""
    from conformer_tpu.parallel.mesh import make_mesh as j_make_mesh
    from conformer_tpu_torch.decode.pipeline import resolve_beam_backend
    from conformer_tpu_torch.parallel.mesh import Mesh

    cfg = Config()
    mesh = Mesh(2, 2, 0, None, None, torch.device("cpu"))
    jmesh = j_make_mesh(dp=4, tp=2)
    for device, backend in (("cpu", "cpu"), ("cuda", "tpu")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        for stream in (False, True):
            for m, jm in ((None, None), (mesh, jmesh)):
                want = jpipeline.resolve_beam_backend(
                    n_devices=1, mesh=jm, streaming=stream)
                assert resolve_beam_backend(torch.device(device), m,
                                            stream) == want
    assert streaming.resolve_streaming_decode(cfg, "beam_auto", mesh) == \
        "beam_device"
    assert streaming.resolve_streaming_decode(cfg, "beam_auto") == "beam"
    tcfg = cfg.override(**{"model.arch": "transducer"})
    assert streaming.resolve_streaming_decode(tcfg, "beam_auto", mesh) == \
        "beam"


def test_transducer_and_device_beam_raise(port, arpa, tmp_path, capsys):
    """Once refused, the device beam streams: ``decode="beam_device"``
    (word LM, W 8) gives the JAX transcriber's texts whatever the block
    size, through the transcriber and ``cli.infer --streaming``; a
    transducer's beam_device is its beam."""
    import dataclasses

    from conformer_tpu_torch.cli.infer import main

    cfg, model, tok = port
    jcfg, variables = _jax_model()
    jdec, dcfg = (dataclasses.replace(d, beam_width=8)
                  for d in _decode_cfgs(arpa))
    jst = JStreamingTranscriber(jcfg, j_load_tokenizer("vi"), variables,
                                chunk_s=CHUNK_S, left_context_s=CONTEXT_S,
                                decode="beam_device", decode_cfg=jdec)
    st = StreamingTranscriber(cfg, tok, model, chunk_s=CHUNK_S,
                              left_context_s=CONTEXT_S, decode="beam_device",
                              decode_cfg=dcfg)
    want = {}
    for name in ("multi", "long"):
        jst.reset()
        jst.feed(AUDIO[name])
        jst.finish()
        want[name] = jst.text
        for block in (5000, len(AUDIO[name])):
            assert _run(st, AUDIO[name], block) == (want[name], want[name])
        assert want[name]
    tcfg = cfg.override(**{"model.arch": "transducer"})
    assert streaming.resolve_streaming_decode(tcfg, "beam_device") == "beam"
    weights, config = tmp_path / "w.pt", tmp_path / "c.json"
    torch.save(model.state_dict(), weights)
    cfg.to_json(str(config))
    path = tmp_path / "multi.wav"
    wavfile.write(path, SR, AUDIO["multi"])
    main(["--audio", str(path), "--config", str(config), "--weights",
          str(weights), "--device", "cpu", "--streaming", "--decode",
          "beam_device", "--lm", arpa, "--stream-chunk-seconds",
          str(CHUNK_S), "--stream-context-seconds", str(CONTEXT_S),
          "--set", "decode.beam_width=8", "--set", "decode.alpha=0.8",
          "--set", "decode.beta=1.0"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("\t", 1)[1] for ln in lines if "\t" in ln] == \
        [want["multi"]]
