"""Streaming transcription: a chunked encoder with left-context carry and
frame-synchronous emission (counterpart of conformer_tpu/decode/streaming.py).

Each chunk is encoded together with the trailing ``left_context_s`` seconds
of audio already seen; the context half of the output is dropped, and the
CTC collapse state (the last emitted token) carries across chunk
boundaries, so emission is incremental and exact with respect to this
chunk's framewise argmax. An utterance no longer than one chunk takes the
offline path (the same mel, mask and collapse), so its text is the offline
text; longer audio sees a finite left context instead of global attention.
The chunk advance is a multiple of the total subsampling stride, so emitted
frames align across chunks.

``decode="beam"`` replaces the collapse with the host prefix beam search
(``decode/beam_search.py::BeamStream``) fed each chunk's log-softmax: the
beams persist across chunks, so the search over the streamed frames is the
offline search. Beam hypotheses are revisable: ``feed`` returns "" and the
live hypothesis is ``.text``.

Double buffering (``pipeline_chunks=True``, the default): ``feed`` enqueues
the current chunk on the device and only then reads the previous chunk's
outputs, so the host's emission overlaps the device's next chunk. On the
card each chunk's outputs are copied without blocking into pinned host
memory behind a CUDA event, and the host waits on the previous chunk's
event alone (a blocking copy would wait for the chunk just enqueued too).
Finalized text lags one chunk; ``.text`` and ``finish()`` drain it.
``pipeline_chunks=False`` emits each chunk at once.

``decode="beam_device"`` (CTC) runs the device prefix beam search
(ops/beam_search_device.py, CUDA graphs on the card) on each window's
log-softmax from its first new frame, with word-level fusion and hotwords
from ``decode.lm_path`` (or token-level from ``decode.device_lm_path``):
the raw ``BeamState`` stays on the device from window to window, so the
stream is the offline search over the streamed frames. The best beam is
read only by ``.text``.

The transducer (``model.arch='transducer'``) decodes each window greedily
on the device from its first new frame (``rnnt_greedy_decode(start_frames=,
return_carry=True)``, at most ``max(chunk frames * 4, 8)`` tokens a window)
and carries the prediction network's (state, pred) on the device into the
next window, so its label history is exact across windows; ``reset()``
starts it again from ``predict_init(1)``. With ``decode="beam"`` (or
``"beam_device"``) it runs the RNN-T beam search instead
(``rnnt_beam_search(init_beams=, return_beams=True)``, token-level fusion
from ``decode.device_lm_path``), the raw beams carried on the device from
window to window. A device beam's hypothesis is revisable: ``feed``
returns "" and the live hypothesis is ``.text``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config, DecodeConfig
from conformer_tpu_torch.decode.pipeline import (device_lm_kwargs,
                                                 resolve_beam_backend)
from conformer_tpu_torch.ops.beam_search_device import ctc_beam_search_device
from conformer_tpu_torch.ops.rnnt import rnnt_beam_search, rnnt_greedy_decode
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.train.steps import make_forward


def resolve_streaming_decode(cfg: Config, decode: str, mesh=None) -> str:
    """-> the decode mode a stream runs: ``beam_auto`` is the backend
    decode/pipeline.py::resolve_beam_backend picks for a stream, as the JAX
    ``resolve_beam_backend(mesh=, streaming=True)`` does: the host beam
    search ("beam"; at batch 1 it wins) without a mesh, the device search
    ("beam_device") under one. A transducer's ``beam_device`` is its beam
    ("beam"), which already runs on the device."""
    if decode == "beam_auto":
        decode = resolve_beam_backend(torch.device("cpu"), mesh,
                                      streaming=True)
    if decode not in ("greedy", "beam", "beam_device"):
        raise ValueError(f"decode must be greedy|beam|beam_device|beam_auto, "
                         f"got {decode!r}")
    if cfg.model.arch == "transducer" and decode == "beam_device":
        decode = "beam"
    return decode


class StreamingTranscriber:
    """Feed audio incrementally; read back text as it becomes final.

        st = StreamingTranscriber(cfg, tokenizer, pipe.model, pipe.frontend)
        for block in microphone():        # any block sizes
            print(st.feed(block), end="")
        print(st.finish())

    ``model`` is a ``Conformer`` or a ``Transducer`` on its device
    (``InferencePipeline.model``); ``frontend`` a ``MelFrontend`` on the
    same device (one is built when none is given). ``chunk_s``: audio
    emitted per encoder call; ``left_context_s``: audio already seen that
    each chunk attends to. ``keep_windows``: keep each encoded window's
    fp32 log-softmax (CTC) or emitted token ids (transducer greedy), one
    row on the host, in ``windows``, for checks that hold the streamed
    outputs against an offline run (the device beams keep none).
    """

    def __init__(self, cfg: Config, tokenizer: GraphemeTokenizer,
                 model: torch.nn.Module,
                 frontend: Optional[MelFrontend] = None,
                 chunk_s: float = 2.0, left_context_s: float = 6.0,
                 decode: str = "greedy",
                 decode_cfg: Optional[DecodeConfig] = None,
                 pipeline_chunks: bool = True, keep_windows: bool = False):
        self.decode = decode = resolve_streaming_decode(cfg, decode)
        self.cfg = cfg
        self.tok = tokenizer
        self.sr = cfg.audio.sample_rate
        stride = 4 * cfg.audio.hop_length   # two stride-2 convolutions
        self.chunk = int(chunk_s * self.sr) // stride * stride
        self.ctx = int(left_context_s * self.sr) // stride * stride
        if self.chunk <= 0:
            raise ValueError("chunk_s too small for the subsampling stride")
        self.device = next(model.parameters()).device
        frontend = frontend or MelFrontend(cfg.audio, device=self.device)
        self._forward = make_forward(cfg, model, frontend)
        self._model = model
        self._transducer = cfg.model.arch == "transducer"
        self._max_per_chunk = max(self.chunk // stride * 4, 8)
        self._beam = self._device_search = None
        dcfg = decode_cfg or cfg.decode
        if self._transducer and decode == "beam":
            lm = device_lm_kwargs(dataclasses.replace(cfg, decode=dcfg),
                                  tokenizer, self.device)
            self._device_search = functools.partial(
                rnnt_beam_search, beam_width=dcfg.beam_width,
                top_k=dcfg.rnnt_top_k, max_symbols=dcfg.rnnt_max_symbols,
                max_len=cfg.data.max_tokens, unk_id=tokenizer.unk_id,
                scan_unroll=dcfg.device_scan_unroll, return_beams=True, **lm)
        elif decode == "beam_device":
            lm = device_lm_kwargs(dataclasses.replace(cfg, decode=dcfg),
                                  tokenizer, self.device, word_fallback=True)
            self._device_search = functools.partial(
                ctc_beam_search_device, beam_width=dcfg.beam_width,
                top_k=dcfg.device_top_k, blank_id=tokenizer.pad_id,
                unk_id=tokenizer.unk_id, max_len=cfg.data.max_tokens,
                scan_unroll=dcfg.device_scan_unroll, return_state=True, **lm)
        elif decode == "beam":
            from conformer_tpu_torch.decode.beam_search import \
                BeamSearchDecoder

            self._beam = BeamSearchDecoder(tokenizer,
                                           decode_cfg or DecodeConfig())
        self._pipeline = pipeline_chunks
        self._keep_windows = keep_windows
        self.reset()

    def reset(self) -> None:
        """Clear all carried state for a fresh utterance, keeping the model
        (servers pool transcribers across sessions)."""
        self._buffer = np.zeros((0,), np.float32)   # audio not yet encoded
        self._context = np.zeros((0,), np.float32)  # audio already encoded
        self._prev_id = -1                          # CTC collapse carry
        self._carry = None                          # transducer (state, pred)
        if self._transducer:
            with torch.inference_mode():
                self._carry = self._model.predict_init(1, self.device)
        self._pieces: List[str] = []
        self._pending = None   # (host outputs, host length, event, start)
        self.windows: List[torch.Tensor] = []
        # the host beam search starts a fresh search; its LM stays loaded
        self._stream = self._beam.stream() if self._beam is not None else None
        self._beams = None          # a device search's raw beams
        self._best = None           # and its best (tokens, count), on device

    def _sub_frames(self, n_samples: int) -> int:
        """Samples -> subsampled encoder frames."""
        mel = n_samples // self.cfg.audio.hop_length + 1
        return ((mel - 1) // 2 - 1) // 2

    def _decode_transducer(self, enc, enc_len, start: int):
        """Greedy tokens of frames [start:] of the one row, carrying the
        prediction network's (state, pred) on into the next window."""
        joint_fn, pred_step_fn = self._model.greedy_fns()
        ids, count, self._carry = rnnt_greedy_decode(
            joint_fn, enc, enc_len, pred_step_fn, self._carry,
            max_symbols=self.cfg.decode.rnnt_max_symbols,
            max_len=self._max_per_chunk,
            start_frames=torch.tensor([start], dtype=torch.int32,
                                      device=self.device),
            return_carry=True)
        if self._keep_windows:
            self.windows.append(ids[0, : int(count[0])].cpu())
        return ids[0], count

    @torch.inference_mode()
    def _enqueue(self, audio: np.ndarray, start: int):
        """Encode ``audio`` padded to one window on the device; -> (outputs,
        length, event): framewise argmax ids (greedy), fp32 log-softmax
        (beam) or, for the transducer, the tokens emitted from frame
        ``start`` and their count, of the one row, copied to pinned host
        memory without blocking on the card, with the event that marks the
        copy done."""
        window = self.ctx + self.chunk
        padded = np.zeros((1, max(len(audio), window)), np.float32)
        padded[0, : len(audio)] = audio
        x = torch.from_numpy(padded).to(self.device)
        n = torch.tensor([len(audio)], dtype=torch.int64, device=self.device)
        logits, out_len = self._forward(x, n)
        if self._transducer:      # "logits" are the encodings here
            out, out_len = self._decode_transducer(logits, out_len, start)
        else:
            if self._keep_windows:
                self.windows.append(torch.log_softmax(logits[0], dim=-1)
                                    [: int(out_len[0])].float().cpu())
            out = (torch.log_softmax(logits[0], dim=-1)
                   if self._stream is not None
                   else logits[0].argmax(dim=-1).to(torch.int32))
        if self.device.type != "cuda":
            return out, out_len, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host_len = torch.empty(out_len.shape, dtype=out_len.dtype,
                               pin_memory=True)
        host.copy_(out, non_blocking=True)
        host_len.copy_(out_len, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, host_len, event

    @torch.inference_mode()
    def _search_window(self, audio: np.ndarray, start: int) -> None:
        """Encode ``audio`` padded to one window and advance the device
        search's beams over its frames from ``start``, all on the device."""
        window = self.ctx + self.chunk
        padded = np.zeros((1, max(len(audio), window)), np.float32)
        padded[0, : len(audio)] = audio
        x = torch.from_numpy(padded).to(self.device)
        n = torch.tensor([len(audio)], dtype=torch.int64, device=self.device)
        out, out_len = self._forward(x, n)
        start_frames = torch.tensor([start], dtype=torch.int64,
                                    device=self.device)
        if self._transducer:        # "out" are the encodings here
            joint_fn, pred_step_fn = self._model.beam_fns()
            prefixes, plens, _, self._beams = self._device_search(
                joint_fn, out, out_len, pred_step_fn,
                self._model.predict_init(1, self.device),
                start_frames=start_frames, init_beams=self._beams)
        else:
            prefixes, plens, _, self._beams = self._device_search(
                torch.log_softmax(out.float(), dim=-1), out_len,
                start_frames=start_frames, init_state=self._beams)
        self._best = (prefixes[0, 0], plens[0, 0])

    def _run_window(self, audio: np.ndarray, emit_from_sample: int) -> str:
        """Encode ``audio``; emit the collapsed text (greedy) or advance the
        beams (beam) for the frames at and after the subsampled position of
        ``emit_from_sample``, one chunk late when pipelined."""
        start = self._sub_frames(emit_from_sample) if emit_from_sample else 0
        if self._device_search is not None:
            self._search_window(audio, start)
            return ""
        enqueued = self._enqueue(audio, start)
        piece = self._drain_pending()
        self._pending = (*enqueued, start)
        if not self._pipeline:
            piece += self._drain_pending()
        return piece

    def _drain_pending(self) -> str:
        """Wait for the pending chunk's outputs (its event alone) and run
        its host emission; "" when nothing is pending."""
        if self._pending is None:
            return ""
        out, out_len, event, start = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        out = out.numpy()
        n = int(out_len[0])
        if self._transducer:
            return "".join(self.tok.vocab[int(c)] for c in out[:n]
                           if int(c) not in (self.tok.pad_id, self.tok.unk_id))
        if self._stream is not None:
            self._stream.feed(out[start:n])
            return ""
        return self._emit(out[:n], start)

    def _emit(self, ids: np.ndarray, start: int) -> str:
        """Collapse frames [start:], carrying the last emitted token across
        chunk boundaries; blank and unk leave the carry as the offline
        collapse does."""
        out: List[int] = []
        prev = self._prev_id
        for c in ids[start:]:
            c = int(c)
            if c == self.tok.pad_id or c == self.tok.unk_id:
                continue
            if c != prev:
                out.append(c)
            prev = c
        self._prev_id = prev
        return "".join(self.tok.vocab[c] for c in out)

    def _window(self, chunk: np.ndarray) -> np.ndarray:
        ctx = self._context[-self.ctx:] if self.ctx else \
            np.zeros((0,), np.float32)
        return np.concatenate([ctx, chunk]), len(ctx)

    def feed(self, audio: np.ndarray) -> str:
        """Add samples; -> newly finalized text (may be empty)."""
        self._buffer = np.concatenate([self._buffer,
                                       np.asarray(audio, np.float32)])
        emitted = ""
        while len(self._buffer) >= self.chunk:
            chunk, self._buffer = (self._buffer[: self.chunk],
                                   self._buffer[self.chunk:])
            window, n_ctx = self._window(chunk)
            piece = self._run_window(window, emit_from_sample=n_ctx)
            self._context = np.concatenate([self._context, chunk])[-self.ctx:]
            if piece:
                self._pieces.append(piece)
                emitted += piece
        return emitted

    def finish(self) -> str:
        """Flush the remainder; -> the last newly emitted text (greedy) or
        the whole final hypothesis (beam)."""
        emitted = ""
        if len(self._buffer) > 0:
            window, n_ctx = self._window(self._buffer)
            piece = self._run_window(window, emit_from_sample=n_ctx)
            self._buffer = np.zeros((0,), np.float32)
            if piece:
                self._pieces.append(piece)
                emitted = piece
        tail = self._drain_pending()
        if tail:
            self._pieces.append(tail)
            emitted += tail
        if self._stream is not None or self._device_search is not None:
            return self.text
        return emitted

    @property
    def text(self) -> str:
        """The whole transcript so far. Greedy: the delimiter as a space,
        spec-decoded (GraphemeTokenizer.collapsed_ids_to_text's assembly);
        beam: the current best hypothesis, revisable until finish()."""
        tail = self._drain_pending()
        if tail:
            self._pieces.append(tail)
        if self._stream is not None:
            return self._stream.text()
        if self._device_search is not None:
            if self._best is None:
                return ""
            ids, n = self._best       # the only host read of a device beam
            return self.tok.collapsed_ids_to_text(ids.cpu().numpy(),
                                                  int(n)).strip()
        raw = "".join(self._pieces).replace(self.tok.delim_token, " ")
        return self.tok.spec_decode(raw).strip()
