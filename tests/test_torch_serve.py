"""The port's HTTP server (``conformer_tpu_torch.cli.serve``) on the CPU.

The cases of tests/test_serve.py, against the port: the micro-batcher
(shared batches, bucket shapes, the power-of-two batch rungs, warm-up, error
propagation), the stream sessions (pooling, TTL, the session cap, the HTTP
round trip in ``audio/l16`` and ``audio/f32``), concurrent WAV and FLAC
uploads, and the routing front (round robin, session affinity, failover with
cooldown, relayed backend errors). Then the real model: a server built by
``make_server`` at ``ModelConfig.tiny`` (fp32, the JAX weights carried by
``convert.py``) answers WAV, FLAC, stereo and 8 kHz uploads with the JAX
``InferencePipeline``'s texts on the JAX package's decode and resampling of
the same bytes, and a stream session gives the JAX ``StreamingTranscriber``'s
text.
"""

import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.audio import io as jio
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.data.dataset import Batch as JBatch
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.decode.streaming import \
    StreamingTranscriber as JStreamingTranscriber
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.audio.flac import encode_flac_bytes
from conformer_tpu_torch.cli import serve
from conformer_tpu_torch.cli.serve import (MicroBatcher, StreamSessions,
                                           make_handler, make_router_handler)
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000


class FakePipe:
    """Stands in for InferencePipeline: records batch shapes and simulates a
    fixed cost per batch (so batching visibly wins)."""

    def __init__(self, cost_s=0.05):
        self.cost_s = cost_s
        self.batches = []

    def transcribe_batch(self, audio, lengths):
        real = int((lengths > 1).sum())
        self.batches.append((audio.shape, real))
        time.sleep(self.cost_s)
        return [f"UTT{i}" if lengths[i] > 1 else ""
                for i in range(audio.shape[0])]


def _signal(seconds=1.0, value=0.1):
    return np.full(int(seconds * SR), value, np.float32)


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, data=b"", headers=None, timeout=30):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wav_bytes(samples, sr=SR):
    buf = io.BytesIO()
    wavfile.write(buf, sr, samples)
    return buf.getvalue()


class TestMicroBatcher:
    def test_concurrent_requests_share_batches(self):
        pipe = FakePipe()
        mb = MicroBatcher(pipe, [2 * SR, 4 * SR], max_batch=4, window_ms=150)
        results = [None] * 6

        def client(i):
            results[i] = mb.submit(_signal(1.0))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(r is not None and r.startswith("UTT") for r in results)
        assert mb.stats["requests"] == 6
        assert mb.stats["batches"] < 6
        assert mb.stats["batched_requests"] >= 2
        assert mb.stats["max_batch_seen"] >= 2
        for shape, real in pipe.batches:
            assert shape[1] == 2 * SR
            assert shape[0] == mb.size_for(real)

    def test_mixed_buckets_do_not_mix_shapes(self):
        pipe = FakePipe(cost_s=0.01)
        mb = MicroBatcher(pipe, [2 * SR, 4 * SR], max_batch=4, window_ms=100)
        results = {}

        def client(name, seconds):
            results[name] = mb.submit(_signal(seconds))

        threads = [threading.Thread(target=client, args=(f"s{i}", 1.0))
                   for i in range(2)]
        threads += [threading.Thread(target=client, args=(f"l{i}", 3.0))
                    for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 4
        assert {s[1] for s, _ in pipe.batches} == {2 * SR, 4 * SR}
        assert all(s[0] in mb.sizes for s, _ in pipe.batches)

    def test_adaptive_batch_sizes(self):
        pipe = FakePipe(cost_s=0.0)
        mb = MicroBatcher(pipe, [SR], max_batch=8, window_ms=1)
        assert mb.sizes == [1, 2, 4, 8]
        assert mb.submit(_signal(0.5)) == "UTT0"
        assert pipe.batches[-1][0] == (1, SR)
        assert mb.stats["batch_size_hist"]["1"] == 1
        pipe2 = FakePipe(cost_s=0.0)
        mb2 = MicroBatcher(pipe2, [SR], max_batch=8, window_ms=1,
                           adaptive=False)
        assert mb2.submit(_signal(0.5)) == "UTT0"
        assert pipe2.batches[-1][0] == (8, SR)

    def test_warmup_runs_the_ladder_ends(self):
        pipe = FakePipe(cost_s=0.0)
        mb = MicroBatcher(pipe, [SR, 2 * SR], max_batch=8, window_ms=1)
        mb.warmup()
        assert {s for s, _ in pipe.batches} == {(1, SR), (8, SR),
                                                (1, 2 * SR), (8, 2 * SR)}
        pipe.batches.clear()
        mb.warmup(all_sizes=True)
        assert {s[0] for s, _ in pipe.batches} == {1, 2, 4, 8}

    def test_stats_lose_no_update_under_thread_switching(self):
        """64 clients (more than the cores) with a tiny switch interval:
        every request is counted, answered once, and the batches account
        for all of them."""
        import sys

        pipe = FakePipe(cost_s=0.0)
        mb = MicroBatcher(pipe, [SR, 2 * SR], max_batch=8, window_ms=2)
        results = [None] * 64
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda i=i: results.__setitem__(
                    i, mb.submit(_signal(0.5 + (i % 2)), timeout=60)))
                for i in range(64)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert all(r is not None and r.startswith("UTT") for r in results)
        assert mb.stats["requests"] == 64
        assert sum(real for _, real in pipe.batches) == 64
        assert mb.stats["batches"] == len(pipe.batches) \
            == sum(mb.stats["batch_size_hist"].values())

    @pytest.mark.parametrize("max_batch,rungs", [(8, [1, 2, 4, 8]),
                                                 (6, [1, 2, 4, 6]),
                                                 (1, [1])])
    def test_batch_rungs(self, max_batch, rungs):
        assert serve.batch_rungs(max_batch) == rungs
        pipe = FakePipe(cost_s=0.0)
        assert MicroBatcher(pipe, [SR], max_batch=max_batch,
                            window_ms=1).sizes == rungs

    def test_launch_counts_lose_no_count_under_thread_switching(self):
        """The kernel wrappers' counters, shared by a server's threads,
        count under one lock."""
        import sys

        from conformer_tpu_torch.ops.cuda import build

        def wrapper():
            pass

        wrapper.launches = wrapper.window_launches = 0
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                build.count(wrapper, "launches", "window_launches")
                for _ in range(20000)]) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            sys.setswitchinterval(old)
        assert wrapper.launches == wrapper.window_launches == 8 * 20000

    def test_worker_error_propagates(self):
        class BoomPipe:
            def transcribe_batch(self, audio, lengths):
                raise ValueError("device on fire")

        mb = MicroBatcher(BoomPipe(), [SR], max_batch=2, window_ms=5)
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.submit(_signal(0.5))
        # the worker lives on
        mb.pipe = FakePipe(cost_s=0.0)
        assert mb.submit(_signal(0.5)) == "UTT0"


class FakeTranscriber:
    """Stands in for StreamingTranscriber: reports sample counts."""

    built = 0

    def __init__(self):
        FakeTranscriber.built += 1
        self.reset()

    def reset(self):
        self._chunks = []

    def feed(self, audio):
        self._chunks.append(len(audio))
        return f"<{len(audio)}>"

    def finish(self):
        self._chunks.append(0)
        return ""

    @property
    def text(self):
        return "|".join(str(c) for c in self._chunks)


class TestStreamSessions:
    def test_lifecycle_and_pooling(self):
        ss = StreamSessions(FakeTranscriber)
        before = FakeTranscriber.built
        sid = ss.start()
        assert ss.feed(sid, np.zeros(100, np.float32)) == "<100>"
        assert ss.feed(sid, np.zeros(50, np.float32)) == "<50>"
        assert ss.text(sid) == "100|50"
        assert ss.finish(sid) == "100|50|0"
        with pytest.raises(KeyError):
            ss.feed(sid, np.zeros(10, np.float32))
        sid2 = ss.start()      # the pooled transcriber, reset
        assert FakeTranscriber.built == before + 1
        assert ss.text(sid2) == ""

    def test_ttl_reaps_idle_sessions(self):
        ss = StreamSessions(FakeTranscriber, ttl_s=0.01)
        sid = ss.start()
        time.sleep(0.05)
        with pytest.raises(KeyError):
            ss.feed(sid, np.zeros(10, np.float32))
        assert ss.stats["stream_reaped"] == 1

    def test_session_cap(self):
        ss = StreamSessions(FakeTranscriber, max_sessions=2)
        ss.start(), ss.start()
        with pytest.raises(RuntimeError, match="too many"):
            ss.start()

    def test_decode_pcm_l16_and_f32(self):
        pcm = np.array([-32768, 0, 16384, 32767], "<i2")
        np.testing.assert_array_equal(
            serve._decode_pcm(pcm.tobytes(), "audio/l16"),
            pcm.astype(np.float32) / 32768.0)
        np.testing.assert_array_equal(
            serve._decode_pcm(pcm.tobytes(), ""),
            pcm.astype(np.float32) / 32768.0)
        f32 = np.array([0.25, -1.0, 0.5], "<f4")
        np.testing.assert_array_equal(
            serve._decode_pcm(f32.tobytes(), "audio/f32"), f32)

    def test_http_stream_roundtrip(self):
        mb = MicroBatcher(FakePipe(cost_s=0.0), [2 * SR], max_batch=2,
                          window_ms=1)
        server, base = _serve(make_handler(mb, Config(),
                                           StreamSessions(FakeTranscriber)))
        try:
            sid = _post(f"{base}/stream/start")[1]["session"]
            pcm = (np.ones(400) * 16384).astype("<i2").tobytes()
            assert _post(f"{base}/stream/{sid}", pcm,
                         {"Content-Type": "audio/l16"})[1]["text_delta"] \
                == "<400>"
            f32 = np.ones(200, "<f4").tobytes()
            assert _post(f"{base}/stream/{sid}", f32,
                         {"Content-Type": "audio/f32"})[1]["text_delta"] \
                == "<200>"
            assert _get(f"{base}/stream/{sid}/text")["text"] == "400|200"
            assert _post(f"{base}/stream/{sid}/finish")[1]["text"] \
                == "400|200|0"
            stats = _get(f"{base}/stats")
            assert stats["stream_sessions"] == 1
            assert stats["stream_chunks"] == 2
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{base}/stream/{sid}/text")
            assert e.value.code == 404
        finally:
            server.shutdown()
            server.server_close()


class TestHTTPServer:
    def test_concurrent_clients_with_wav_and_flac(self):
        mb = MicroBatcher(FakePipe(), [2 * SR], max_batch=4, window_ms=150)
        server, base = _serve(make_handler(mb, Config()))
        try:
            ints = (np.ones(SR) * 1000).astype(np.int16)
            payloads = [_wav_bytes(ints), encode_flac_bytes(ints, SR)] * 3
            codes, bodies = [None] * 6, [None] * 6

            def client(i):
                codes[i], bodies[i] = _post(f"{base}/transcribe", payloads[i])

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert codes == [200] * 6
            assert all(b["text"].startswith("UTT") for b in bodies)
            assert all(b["audio_seconds"] == 1.0 for b in bodies)
            stats = _get(f"{base}/stats")
            assert stats["requests"] == 6
            assert stats["batches"] < 6
            assert _get(f"{base}/healthz") == {"status": "ok"}
            for path, body in (("/transcribe", b"OggS" + b"\x00" * 40),
                               ("/nowhere", b"")):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(base + path, body)
                want = 500 if path == "/transcribe" else 404
                assert e.value.code == want
                assert "error" in json.loads(e.value.read())
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/stream/start")     # streaming disabled
            assert e.value.code == 404
        finally:
            server.shutdown()
            server.server_close()


class TestRouter:
    """The routing front over in-process backends of fakes: the router sees
    only HTTP, as across hosts."""

    def _backend(self):
        mb = MicroBatcher(FakePipe(cost_s=0.0), [2 * SR], max_batch=2,
                          window_ms=5)
        server, _ = _serve(make_handler(mb, Config(),
                                        StreamSessions(FakeTranscriber)))
        return server, mb.pipe

    def _router(self, backends, **kw):
        urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in backends]
        return _serve(make_router_handler(urls, **kw))

    def _wav(self):
        return _wav_bytes((np.ones(SR) * 1000).astype(np.int16))

    def test_round_robin_and_stats(self):
        (b1, p1), (b2, p2) = self._backend(), self._backend()
        router, base = self._router([b1, b2])
        try:
            for _ in range(6):
                code, payload = _post(f"{base}/transcribe", self._wav())
                assert code == 200 and payload["text"].startswith("UTT")
            assert sum(r for _, r in p1.batches) == 3
            assert sum(r for _, r in p2.batches) == 3
            stats = _get(f"{base}/stats")
            assert stats["router"]["routed"] == 6
            assert sum(b["requests"] for b in stats["backends"]) == 6
            assert _get(f"{base}/healthz")["backends_up"] == 2
        finally:
            for s in (router, b1, b2):
                s.shutdown()

    def test_stream_session_affinity(self):
        (b1, _), (b2, _) = self._backend(), self._backend()
        router, base = self._router([b1, b2])
        try:
            sids = [_post(f"{base}/stream/start")[1]["session"]
                    for _ in range(2)]
            assert {s.split("-")[0] for s in sids} == {"b0", "b1"}
            pcm = (np.ones(400) * 1000).astype("<i2").tobytes()
            for sid in sids:
                assert _post(f"{base}/stream/{sid}", pcm,
                             {"Content-Type": "audio/l16"})[1] \
                    == {"text_delta": "<400>"}
            sid = sids[0]
            _post(f"{base}/stream/{sid}",
                  (np.ones(200) * 1000).astype("<i2").tobytes(),
                  {"Content-Type": "audio/l16"})
            assert _get(f"{base}/stream/{sid}/text")["text"] == "400|200"
            assert _post(f"{base}/stream/{sid}/finish")[1]["text"] \
                == "400|200|0"
        finally:
            for s in (router, b1, b2):
                s.shutdown()

    def test_failover_and_cooldown(self):
        (b1, _), (b2, p2) = self._backend(), self._backend()
        router, base = self._router([b1, b2], cooldown_s=30.0, timeout_s=2.0)
        try:
            b1.shutdown()
            b1.server_close()
            for _ in range(4):
                code, payload = _post(f"{base}/transcribe", self._wav())
                assert code == 200 and payload["text"].startswith("UTT")
            assert sum(r for _, r in p2.batches) == 4
            assert _get(f"{base}/healthz")["backends_up"] == 1
            assert _get(f"{base}/stats")["backends"][0] == {
                "error": "backend in cooldown"}
        finally:
            router.shutdown()
            b2.shutdown()

    def test_unroutable_session_404(self):
        b1, _ = self._backend()
        router, base = self._router([b1])
        try:
            for path in ("/stream/nonsense/text", "/stream/b7-s000001/text"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(base + path)
                assert e.value.code == 404
        finally:
            router.shutdown()
            b1.shutdown()

    def test_backend_http_errors_are_relayed_not_an_outage(self):
        b1, _ = self._backend()
        router, base = self._router([b1], cooldown_s=60.0)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/transcribe", b"not audio at all")
            assert e.value.code == 500
            assert "error" in json.loads(e.value.read())
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/stream/b0-nonsense/finish")
            assert e.value.code == 404
            code, payload = _post(f"{base}/transcribe", self._wav())
            assert code == 200 and payload["text"].startswith("UTT")
            assert _get(f"{base}/healthz")["backends_up"] == 1
        finally:
            router.shutdown()
            b1.shutdown()

    def test_make_server_builds_a_router_without_a_model(self):
        b1, _ = self._backend()
        url = f"http://127.0.0.1:{b1.server_address[1]}"
        router = serve.make_server(serve.parse_args(
            ["--route-to", url + "/", "--port", "0"]))
        threading.Thread(target=router.serve_forever, daemon=True).start()
        try:
            assert router.backends == [url]
            base = f"http://127.0.0.1:{router.server_address[1]}"
            assert _post(f"{base}/transcribe", self._wav())[0] == 200
        finally:
            router.shutdown()
            router.server_close()
            b1.shutdown()


# ---------------------------------------------------------------------------
# The real model at ModelConfig.tiny against the JAX package

CHUNK_S, CONTEXT_S = 1.0, 2.0


@functools.lru_cache(maxsize=None)
def _jax_pipeline(directory):
    jcfg = JConfig(model=JModelConfig.tiny(370)).override(
        **{"optim.compute_dtype": "float32",
           "train.checkpoint_dir": str(directory / "none")})
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: init(key)):
        return jpipeline.InferencePipeline(jcfg, j_load_tokenizer("vi"))


def _uploads():
    """name -> upload bytes: 16 kHz int16 WAV, its FLAC twin, an int16
    stereo WAV, an 8 kHz WAV and a 22.05 kHz FLAC."""
    rng = np.random.default_rng(5)
    sig = lambda n: np.clip(rng.standard_normal(n) * 0.1, -1, 1)
    q = lambda x: np.round(x * 32767).astype(np.int16)
    mono = q(sig(int(1.3 * SR)))
    stereo = q(sig(2 * int(0.9 * SR)).reshape(-1, 2))
    return {"wav": _wav_bytes(mono),
            "flac": encode_flac_bytes(mono.astype(np.int64), SR),
            "stereo": _wav_bytes(stereo),
            "wav_8k": _wav_bytes(q(sig(int(1.6 * 8000))), 8000),
            "flac_22k": encode_flac_bytes(
                q(sig(int(0.7 * 22050))).astype(np.int64), 22050)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A server from make_server at the tiny width with the JAX pipeline's
    weights (2 s buckets, batches of up to 8, streaming 1 s chunks with
    2 s of context), and the JAX pipeline."""
    directory = tmp_path_factory.mktemp("serve")
    jpipe = _jax_pipeline(directory)
    cfg = Config.from_dict(jpipe.cfg.to_dict())
    variables = {"params": jpipe.state.params,
                 "batch_stats": jpipe.state.batch_stats}
    torch.save(flax_to_state_dict(variables, cfg.model), directory / "w.pt")
    cfg.to_json(str(directory / "c.json"))
    server = serve.make_server(serve.parse_args(
        ["--config", str(directory / "c.json"), "--weights",
         str(directory / "w.pt"), "--device", "cpu", "--port", "0",
         "--buckets", "2.0", "--window-ms", "300",
         "--stream-chunk-seconds", str(CHUNK_S),
         "--stream-context-seconds", str(CONTEXT_S)]))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server, f"http://127.0.0.1:{server.server_address[1]}", jpipe
    server.shutdown()
    server.server_close()


def test_transcribe_gives_the_jax_pipeline_texts(served):
    server, base, jpipe = served
    uploads = _uploads()
    names = sorted(uploads)
    bodies = {}

    def client(name):
        bodies[name] = _post(f"{base}/transcribe", uploads[name])[1]

    threads = [threading.Thread(target=client, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the JAX package's decode and resampling of the same bytes, in one
    # batch padded to the 2 s bucket
    signals = []
    for name in names:
        sig, sr = jio.decode_audio_bytes(uploads[name])
        if sig.ndim == 2:
            sig = sig.mean(axis=0)
        signals.append(jio.resample(sig, sr, SR))
    audio = np.zeros((8, 2 * SR), np.float32)
    lengths = np.ones((8,), np.int32)
    for i, sig in enumerate(signals):
        audio[i, : len(sig)] = sig
        lengths[i] = len(sig)
    want = jpipe.transcribe_batch(JBatch(audio, lengths,
                                         np.zeros((8, 1), np.int32),
                                         np.zeros((8,), np.int32)))
    got = [bodies[n]["text"] for n in names]
    assert got == want[: len(names)]
    assert all(got)
    assert bodies["wav"]["text"] == bodies["flac"]["text"]
    for name, sig in zip(names, signals):
        assert bodies[name]["audio_seconds"] == round(len(sig) / SR, 3)
    stats = _get(f"{base}/stats")
    assert stats["requests"] == len(names)
    assert stats["max_batch_seen"] > 1
    assert server.pipe.batch_log[-1]["batch_size"] in (1, 2, 4, 8)


def test_stream_sessions_give_the_jax_transcriber_text(served):
    server, base, jpipe = served
    rng = np.random.default_rng(9)
    audio = np.clip(rng.standard_normal(int(3.4 * SR)) * 0.1, -1, 1)
    l16 = np.round(audio * 32767).astype("<i2")
    f32 = audio.astype("<f4")
    want = {}
    st = JStreamingTranscriber(jpipe.cfg, jpipe.tok,
                               {"params": jpipe.state.params,
                                "batch_stats": jpipe.state.batch_stats},
                               chunk_s=CHUNK_S, left_context_s=CONTEXT_S)
    for name, sig in (("l16", l16.astype(np.float32) / 32768.0),
                      ("f32", f32.astype(np.float32))):
        st.reset()
        st.feed(sig)
        live = st.text        # every whole chunk, the remainder unfed
        st.finish()
        want[name] = (live, st.text)
    results = {}

    def session(name, pcm, ctype):
        sid = _post(f"{base}/stream/start")[1]["session"]
        block = int(0.5 * SR) * pcm.itemsize
        raw = pcm.tobytes()
        deltas = ""
        for i in range(0, len(raw), block):
            deltas += _post(f"{base}/stream/{sid}", raw[i: i + block],
                            {"Content-Type": ctype})[1]["text_delta"]
        live = _get(f"{base}/stream/{sid}/text")["text"]
        results[name] = (deltas, live,
                         _post(f"{base}/stream/{sid}/finish")[1]["text"])

    threads = [threading.Thread(target=session, args=a) for a in
               (("l16", l16, "audio/l16"), ("f32", f32, "audio/f32"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in ("l16", "f32"):
        deltas, live, final = results[name]
        assert (live, final) == want[name]
        assert final and deltas
    stats = _get(f"{base}/stats")
    assert stats["stream_sessions"] == 2 and stats["stream_active"] == 0


def test_beam_auto_on_the_card_raises_as_infer_does():
    """Offline on the card beam_auto means the device beam search, which
    no longer raises: a server with ``--decode beam_device`` (here on the
    CPU, the port's eager search, W 8) serves /transcribe with the texts
    its pipeline gives the same padded batch, and its stream sessions run
    the device search window by window; beam_auto on the CPU is the host
    search."""
    from conformer_tpu_torch.decode.pipeline import resolve_beam_backend

    assert resolve_beam_backend(torch.device("cuda")) == "beam_device"
    tiny = ["--device", "cpu", "--port", "0", "--buckets", "2.0",
            "--window-ms", "10", "--stream-chunk-seconds", "1.0",
            "--stream-context-seconds", "1.0", "--set", "model.n_blocks=1",
            "--set", "model.d_model=64", "--set", "model.n_heads=2",
            "--set", "model.kernel_size=7", "--set", "decode.beam_width=8"]
    server = serve.make_server(serve.parse_args(
        ["--decode", "beam_device", *tiny]))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert server.pipe.decode == "beam_device"
        sig = np.clip(np.random.default_rng(4).standard_normal(SR) * 0.1,
                      -1, 1).astype(np.float32)
        body = _post(f"{base}/transcribe",
                     _wav_bytes((sig * 32767).astype(np.int16)))[1]
        padded = np.zeros((1, 2 * SR), np.float32)
        padded[0, :SR] = np.round(sig * 32767) / 32768.0
        assert body["text"] == server.pipe.transcribe_batch(
            padded, np.array([SR]))[0]
        sid = _post(f"{base}/stream/start")[1]["session"]
        pcm = np.round(np.tile(sig, 3) * 32767).astype("<i2").tobytes()
        assert _post(f"{base}/stream/{sid}", pcm,
                     {"Content-Type": "audio/l16"})[1]["text_delta"] == ""
        final = _post(f"{base}/stream/{sid}/finish")[1]["text"]
        assert isinstance(final, str)
    finally:
        server.shutdown()
        server.server_close()
    auto = serve.make_server(serve.parse_args(["--decode", "beam_auto",
                                               *tiny]))
    assert auto.pipe.decode == "beam" and auto.pipe._beam is not None
    auto.server_close()
