"""HTTP transcription server (stdlib only) with request micro-batching,
streaming sessions and a routing front (counterpart of
conformer_tpu/cli/serve.py), on the GPU unless ``--device cpu`` is given.

POST a WAV or FLAC to /transcribe, get JSON back. Concurrent requests are
assembled into batches by a background worker: the first request opens a
short batching window, and requests of the same audio bucket that arrive
within it ride the same forward, padded to the bucket and to a power-of-two
batch rung.

    python -m conformer_tpu_torch.cli.serve --weights w.pt --port 8000
    curl -s --data-binary @utt.wav localhost:8000/transcribe
    curl -s localhost:8000/stats       # {"requests": N, "batches": M, ...}

Streaming sessions (incremental transcription over plain HTTP):

    curl -sX POST localhost:8000/stream/start          # {"session": ID}
    curl -s --data-binary @chunk.pcm \\
         -H 'Content-Type: audio/l16' localhost:8000/stream/ID
                                                       # {"text_delta": ...}
    curl -s localhost:8000/stream/ID/text              # live hypothesis
    curl -sX POST localhost:8000/stream/ID/finish      # final text

Chunk bodies are raw PCM at the server's sample rate: little-endian int16
(``audio/l16``, the default) or float32 (``audio/f32``). Each session holds a
pooled ``StreamingTranscriber`` over the server's one model, ``reset()``
between sessions.

Across hosts: one serve process per host, and a routing front with
``--route-to http://h1:8000 http://h2:8000 ...``: round-robin /transcribe
with failover, session-pinned /stream/*, aggregated /stats.

``--weights`` takes a state dict (``conformer_tpu_torch.convert``),
``--checkpoint-dir`` a training checkpoint directory; with neither the model
has seeded random weights. ``--decode beam_auto`` means the device beam
search for /transcribe on the GPU (``beam_device``, CUDA graphs) and the
host beam search for streams, as in the JAX package.

The model's functions run under ``torch.inference_mode`` in each thread that
calls them (the batching worker and the stream handlers): the mode is
thread-local, so they carry it themselves (``train/steps.py``,
``decode/streaming.py``).
"""

from __future__ import annotations

import argparse
import json
import queue
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List

import numpy as np

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            lm_decode, load_config,
                                            load_tokenizer_from_args,
                                            refuse_mesh)


def batch_rungs(max_batch: int) -> List[int]:
    """The batch axis's rungs: the powers of two below ``max_batch``, then
    ``max_batch``."""
    sizes = []
    s = 1
    while s < max_batch:
        sizes.append(s)
        s *= 2
    return sizes + [max_batch]


class MicroBatcher:
    """Assembles concurrent transcription requests into fixed-shape batches.

    The audio axis is padded to the request's bucket, the batch axis to the
    smallest power-of-two rung (1, 2, 4, ..., ``max_batch``) that fits the
    assembled requests, so a lone request rides a batch of 1 and the set of
    shapes stays small; ``adaptive=False`` always pads to ``max_batch``.
    Padding rows have length 1. ``pipe`` is an ``InferencePipeline`` (or
    anything with its ``transcribe_batch(audio, lengths)``)."""

    def __init__(self, pipe, bucket_samples, max_batch: int = 8,
                 window_ms: float = 15.0, adaptive: bool = True):
        self.pipe = pipe
        self.buckets = sorted(bucket_samples)
        self.max_batch = max_batch
        self.sizes = batch_rungs(max_batch) if adaptive else [max_batch]
        self.window_s = window_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "max_batch_seen": 0,
                      "batch_size_hist": {str(s): 0 for s in self.sizes}}
        self._lock = threading.Lock()
        threading.Thread(target=self._run, daemon=True).start()

    def bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.buckets[-1])

    def size_for(self, n: int) -> int:
        return next((s for s in self.sizes if n <= s), self.max_batch)

    def warmup(self, all_sizes: bool = False) -> None:
        """Run each bucket's shapes once before serving (the kernels' builds
        and the allocator's first blocks): the smallest and largest batch
        rung per bucket, or with ``all_sizes`` every rung."""
        sizes = self.sizes if all_sizes else sorted(
            {self.sizes[0], self.sizes[-1]})
        for b in self.buckets:
            for nb in sizes:
                self.pipe.transcribe_batch(np.zeros((nb, b), np.float32),
                                           np.full((nb,), b, np.int64))

    def submit(self, signal: np.ndarray, timeout: float = 120.0) -> str:
        """Blocks until the signal's transcript is ready."""
        ev = threading.Event()
        slot: dict = {}
        with self._lock:
            self.stats["requests"] += 1
        self.q.put((signal, ev, slot))
        if not ev.wait(timeout):
            raise TimeoutError("transcription timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["text"]

    def _run(self) -> None:
        while True:
            items = [self.q.get()]
            bucket = self.bucket_for(len(items[0][0]))
            deadline = time.monotonic() + self.window_s
            requeue = []
            while len(items) < self.max_batch:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    item = self.q.get(timeout=budget)
                except queue.Empty:
                    break
                if self.bucket_for(len(item[0])) == bucket:
                    items.append(item)
                else:
                    requeue.append(item)   # another shape: the next batch
            for item in requeue:
                self.q.put(item)
            self._process(items, bucket)

    def _process(self, items, bucket: int) -> None:
        try:
            nb = self.size_for(len(items))
            audio = np.zeros((nb, bucket), np.float32)
            lengths = np.ones((nb,), np.int64)     # padding rows: length 1
            for i, (sig, _, _) in enumerate(items):
                n = min(len(sig), bucket)
                audio[i, :n] = sig[:n]
                lengths[i] = n
            texts = self.pipe.transcribe_batch(audio, lengths)
            with self._lock:
                self.stats["batches"] += 1
                if len(items) > 1:
                    self.stats["batched_requests"] += len(items)
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(items))
                self.stats["batch_size_hist"][str(nb)] += 1
            for i, (_, ev, slot) in enumerate(items):
                slot["text"] = texts[i]
                ev.set()
        except Exception as e:  # noqa: BLE001 -- the worker must not die
            for _, ev, slot in items:
                slot["error"] = f"{type(e).__name__}: {e}"
                ev.set()


class StreamSessions:
    """Pooled streaming sessions for the HTTP server.

    ``make_transcriber()`` builds a ``StreamingTranscriber``; a finished or
    expired session's transcriber goes back to a pool after ``reset()``.
    Idle sessions are reaped after ``ttl_s`` seconds (lazily, on access)."""

    def __init__(self, make_transcriber, ttl_s: float = 300.0,
                 max_sessions: int = 64, pool_size: int = 8):
        self._make = make_transcriber
        self.ttl_s = ttl_s
        self.max_sessions = max_sessions
        self._pool: list = []
        self._pool_size = pool_size
        self._sessions: dict = {}   # id -> [transcriber, lock, last_seen]
        self._lock = threading.Lock()
        self._counter = 0
        self.stats = {"stream_sessions": 0, "stream_chunks": 0,
                      "stream_active": 0, "stream_reaped": 0}

    def _reap_locked(self) -> None:
        now = time.monotonic()
        for sid in [s for s, v in self._sessions.items()
                    if now - v[2] > self.ttl_s]:
            self._release(self._sessions.pop(sid)[0])
            self.stats["stream_reaped"] += 1
        self.stats["stream_active"] = len(self._sessions)

    def _release(self, st) -> None:
        try:
            st.reset()
        except Exception:  # noqa: BLE001 -- a broken transcriber is dropped
            return
        if len(self._pool) < self._pool_size:
            self._pool.append(st)

    def start(self) -> str:
        with self._lock:
            self._reap_locked()
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError("too many active streaming sessions")
            st = self._pool.pop() if self._pool else self._make()
            self._counter += 1
            sid = f"s{self._counter:06d}"
            self._sessions[sid] = [st, threading.Lock(), time.monotonic()]
            self.stats["stream_sessions"] += 1
            self.stats["stream_active"] = len(self._sessions)
        return sid

    def _get(self, sid: str):
        with self._lock:
            self._reap_locked()
            if sid not in self._sessions:
                raise KeyError(f"unknown or expired session {sid!r}")
            entry = self._sessions[sid]
            entry[2] = time.monotonic()
            return entry

    def feed(self, sid: str, audio: np.ndarray) -> str:
        st, lock, _ = self._get(sid)
        with lock:
            delta = st.feed(audio)
        with self._lock:
            self.stats["stream_chunks"] += 1
        return delta

    def text(self, sid: str) -> str:
        st, lock, _ = self._get(sid)
        with lock:
            return st.text

    def finish(self, sid: str) -> str:
        st, lock, _ = self._get(sid)
        with lock:
            st.finish()
            final = st.text
        with self._lock:
            if self._sessions.pop(sid, None) is not None:
                self._release(st)
            self.stats["stream_active"] = len(self._sessions)
        return final


def _decode_pcm(raw: bytes, content_type: str) -> np.ndarray:
    """A raw streaming chunk -> float32 signal: little-endian float32 for
    'audio/f32', little-endian int16 (audio/l16) otherwise."""
    if "f32" in (content_type or ""):
        return np.frombuffer(raw, dtype="<f4").astype(np.float32)
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


class _JsonHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def make_handler(batcher: MicroBatcher, cfg, sessions: StreamSessions = None):
    """-> the request handler class of a serve process."""
    sr = cfg.audio.sample_rate

    class Handler(_JsonHandler):
        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                with batcher._lock:
                    stats = dict(batcher.stats)
                if sessions is not None:
                    with sessions._lock:
                        stats.update(sessions.stats)
                self._reply(200, stats)
            elif (sessions is not None and self.path.startswith("/stream/")
                    and self.path.endswith("/text")):
                try:
                    sid = self.path[len("/stream/"):-len("/text")]
                    self._reply(200, {"text": sessions.text(sid)})
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
            else:
                self._reply(404, {"error": "unknown path"})

        def _do_stream(self):
            if sessions is None:
                self._reply(404, {"error": "streaming disabled "
                                           "(--no-streaming)"})
                return
            path = self.path[len("/stream/"):]
            try:
                if path in ("start", "start/"):
                    self._reply(200, {"session": sessions.start()})
                elif path.endswith("/finish"):
                    sid = path[: -len("/finish")]
                    self._reply(200, {"text": sessions.finish(sid)})
                else:
                    n = int(self.headers.get("Content-Length", 0))
                    audio = _decode_pcm(self.rfile.read(n),
                                        self.headers.get("Content-Type", ""))
                    self._reply(200, {"text_delta": sessions.feed(path,
                                                                  audio)})
            except KeyError as e:
                self._reply(404, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- the server must not die
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            if self.path.startswith("/stream/"):
                self._do_stream()
                return
            if self.path != "/transcribe":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                from conformer_tpu_torch.audio.io import (decode_audio_bytes,
                                                          resample)

                n = int(self.headers.get("Content-Length", 0))
                # WAV (int16/int32/uint8/float, scaled as read_wav scales)
                # or FLAC, sniffed by magic bytes
                signal, file_sr = decode_audio_bytes(self.rfile.read(n))
                if signal.ndim == 2:   # (channels, samples) -> mono
                    signal = signal.mean(axis=0)
                signal = resample(signal, file_sr, sr)
                t0 = time.perf_counter()
                text = batcher.submit(signal)
                elapsed = time.perf_counter() - t0
                audio_s = len(signal) / sr
                self._reply(200, {
                    "text": text,
                    "audio_seconds": round(audio_s, 3),
                    "decode_seconds": round(elapsed, 4),
                    "rtf": round(elapsed / max(audio_s, 1e-6), 4),
                })
            except Exception as e:  # noqa: BLE001 -- the server must not die
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_router_handler(backends, cooldown_s: float = 5.0,
                        timeout_s: float = 120.0):
    """A thin routing front over serve processes: round-robin /transcribe
    with failover, /stream/* pinned to the backend that created the session
    (routed ids look like "b3-<backend sid>"), aggregated /stats. A backend
    whose transport fails is cooled down for ``cooldown_s`` and a stateless
    request retries the next; an HTTP error status from a live backend is a
    response to relay, not an outage.

    backends: base URLs ("http://host:port")."""
    state = {"rr": 0, "down_until": [0.0] * len(backends),
             "routed": 0, "retries": 0, "lock": threading.Lock()}
    sid_re = re.compile(r"^b(\d+)-(.*)$")

    def pick():
        """-> the next healthy backend's index (round-robin), or None."""
        now = time.monotonic()
        with state["lock"]:
            for _ in range(len(backends)):
                i = state["rr"] % len(backends)
                state["rr"] += 1
                if state["down_until"][i] <= now:
                    return i
        return None

    def mark_down(i):
        with state["lock"]:
            state["down_until"][i] = time.monotonic() + cooldown_s

    def forward(i, method, path, body=None, content_type=None, timeout=None):
        """-> (status, payload). A backend's 4xx/5xx is returned; only
        transport failures (URLError, OSError) propagate."""
        req = urllib.request.Request(backends[i] + path, data=body,
                                     method=method)
        if content_type:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req,
                                        timeout=timeout or timeout_s) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except ValueError:
                payload = {"error": f"backend returned HTTP {e.code}"}
            return e.code, payload

    class RouterHandler(_JsonHandler):
        def _route_stateless(self, method, path, body=None, ctype=None):
            """Forward to the next healthy backend; fail over on transport
            errors only."""
            last_err = "no healthy backends"
            for _ in range(len(backends)):
                i = pick()
                if i is None:
                    break
                try:
                    code, payload = forward(i, method, path, body, ctype)
                    with state["lock"]:
                        state["routed"] += 1
                    return i, code, payload
                except (urllib.error.URLError, OSError, ValueError) as e:
                    mark_down(i)
                    with state["lock"]:
                        state["retries"] += 1
                    last_err = f"{type(e).__name__}: {e}"
            return None, 502, {"error": f"all backends failed: {last_err}"}

        def _route_session(self, method, routed_path, body=None, ctype=None):
            """Forward /stream/<routed sid>... to its pinned backend."""
            rest = routed_path[len("/stream/"):]
            m = sid_re.match(rest)
            if not m:
                self._reply(404, {"error": f"unroutable session id: {rest}"})
                return
            i = int(m.group(1))
            if i >= len(backends):
                self._reply(404, {"error": f"unknown backend b{i}"})
                return
            try:
                code, payload = forward(i, method, "/stream/" + m.group(2),
                                        body, ctype)
                self._reply(code, payload)   # relayed 4xx/5xx included
            except (urllib.error.URLError, OSError, ValueError) as e:
                mark_down(i)
                self._reply(502, {"error": f"backend b{i} failed: "
                                           f"{type(e).__name__}: {e}"})

        def do_GET(self):
            if self.path == "/healthz":
                now = time.monotonic()
                with state["lock"]:
                    up = sum(1 for t in state["down_until"] if t <= now)
                self._reply(200 if up else 503,
                            {"status": "ok" if up else "all backends down",
                             "backends_up": up, "backends": len(backends)})
            elif self.path == "/stats":
                per = []
                now = time.monotonic()
                for i in range(len(backends)):
                    with state["lock"]:
                        down = state["down_until"][i] > now
                    if down:   # a dead host does not stall the stats
                        per.append({"error": "backend in cooldown"})
                        continue
                    try:
                        per.append(forward(i, "GET", "/stats",
                                           timeout=5.0)[1])
                    except (urllib.error.URLError, OSError, ValueError) as e:
                        per.append({"error": f"{type(e).__name__}: {e}"})
                with state["lock"]:
                    router = {"routed": state["routed"],
                              "retries": state["retries"]}
                self._reply(200, {"router": router, "backends": per})
            elif self.path.startswith("/stream/"):
                self._route_session("GET", self.path)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else None
            ctype = self.headers.get("Content-Type")
            if self.path == "/transcribe":
                _, code, payload = self._route_stateless(
                    "POST", "/transcribe", body, ctype)
                self._reply(code, payload)
            elif self.path in ("/stream/start", "/stream/start/"):
                i, code, payload = self._route_stateless(
                    "POST", "/stream/start", body, ctype)
                if code == 200 and "session" in payload:
                    payload["session"] = f"b{i}-{payload['session']}"
                self._reply(code, payload)
            elif self.path.startswith("/stream/"):
                self._route_session("POST", self.path, body, ctype)
            else:
                self._reply(404, {"error": "unknown path"})

    return RouterHandler


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--weights", default=None,
                   help="torch state dict (see conformer_tpu_torch.convert)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="training checkpoint directory (its config.json too)")
    p.add_argument("--route-to", nargs="+", default=None, metavar="URL",
                   help="run as a routing front over serve processes "
                        "(round-robin /transcribe, session-pinned "
                        "/stream/*); no model is loaded")
    p.add_argument("--port", type=int, default=8000,
                   help="0 takes a free port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--decode", choices=["greedy", "beam", "beam_device",
                                        "beam_auto"], default="greedy")
    p.add_argument("--lm", default=None,
                   help="ARPA n-gram LM for the beam search")
    p.add_argument("--buckets", type=float, nargs="+",
                   default=[2.0, 4.0, 8.0, 16.0, 30.0],
                   help="audio-second buckets requests are padded to")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest micro-batch (the batch axis's top rung)")
    p.add_argument("--window-ms", type=float, default=15.0,
                   help="batching window opened by the first request")
    p.add_argument("--warmup", action="store_true",
                   help="run each bucket's smallest and largest batch rung "
                        "before serving")
    p.add_argument("--warmup-all", action="store_true",
                   help="with --warmup: every batch rung")
    p.add_argument("--no-adaptive-batch", action="store_true",
                   help="always pad the batch axis to --max-batch instead "
                        "of the smallest power-of-two rung that fits")
    p.add_argument("--no-streaming", action="store_true",
                   help="disable the /stream/* session endpoints")
    p.add_argument("--stream-chunk-seconds", type=float, default=2.0)
    p.add_argument("--stream-context-seconds", type=float, default=6.0)
    p.add_argument("--stream-ttl", type=float, default=300.0,
                   help="idle seconds before a streaming session is reaped")
    p.add_argument("--max-stream-sessions", type=int, default=64)
    args = p.parse_args(argv)
    refuse_mesh(args, "cli.serve")
    return args


def make_server(args: argparse.Namespace) -> ThreadingHTTPServer:
    """-> the server ``args`` describe, bound and ready, not yet serving
    (``serve_forever`` in a thread; ``port`` 0 takes a free port). A serve
    process's server carries ``pipe``, ``batcher`` and ``sessions``."""
    if args.route_to:
        backends = [u.rstrip("/") for u in args.route_to]
        server = ThreadingHTTPServer((args.host, args.port),
                                     make_router_handler(backends))
        server.backends = backends
        return server
    cfg = load_config(args)
    cfg, decode = lm_decode(args, cfg)
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             checkpoint_dir=args.checkpoint_dir,
                             decode=decode, device=args.device)
    sr = cfg.audio.sample_rate
    batcher = MicroBatcher(pipe, [int(b * sr) for b in args.buckets],
                           max_batch=args.max_batch, window_ms=args.window_ms,
                           adaptive=not args.no_adaptive_batch)
    if args.warmup:
        t0 = time.perf_counter()
        batcher.warmup(all_sizes=args.warmup_all)
        print(f"warmed {len(args.buckets)} bucket shapes "
              f"in {time.perf_counter() - t0:.1f}s")
    sessions = None
    if not args.no_streaming:
        sessions = StreamSessions(
            lambda: pipe.streaming_transcriber(
                chunk_s=args.stream_chunk_seconds,
                left_context_s=args.stream_context_seconds),
            ttl_s=args.stream_ttl, max_sessions=args.max_stream_sessions)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(batcher, pipe.cfg, sessions))
    server.pipe, server.batcher, server.sessions = pipe, batcher, sessions
    return server


def main(argv=None) -> None:
    args = parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    if args.route_to:
        print(f"routing on http://{host}:{port} -> {len(server.backends)} "
              f"backends: {', '.join(server.backends)}")
    else:
        print(f"serving on http://{host}:{port} "
              "(POST /transcribe /stream/*, GET /healthz /stats)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
