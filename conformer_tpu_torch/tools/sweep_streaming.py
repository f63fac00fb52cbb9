"""The streaming chunk-size trade-off (counterpart of
tools/sweep_streaming.py): RTF and divergence from the offline decode per
(chunk_s, left_context_s), in one process.

Every row is set against one offline greedy decode of the same audio with
the same weights in the same run (host clocks move between runs, so only
comparisons inside a run mean anything). The divergence is the character
error rate of the streamed transcript against the offline one (0 =
equal). Seeded weights (Config()) and seeded noise audio; the
``StreamingTranscriber`` of the port, greedy CTC, the host beam (``beam``)
or the device beam (``beam_device``).

    python -m conformer_tpu_torch.tools.sweep_streaming [--total-s 60]
        [--decode greedy|beam|beam_device] [--chunks 0.5 1 2 4]
        [--contexts 2 6] [--device cuda|cpu]

Prints the card's name and power limit first, then one JSON object a line:
the offline decode's RTF, then a row per pair (context shorter than the
chunk skipped). A pair the transcriber refuses (a ValueError) gets a row
with its ``error``; any other failure, a kernel's included, stops the run.
``main`` returns the rows, with the texts.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from conformer_tpu_torch.tools.timing import sync


def offline_text(cfg, tok, model, audio: np.ndarray,
                 device: torch.device) -> "tuple[str, float]":
    """One full-utterance greedy decode -> (text, wall seconds of a warm
    call)."""
    from conformer_tpu_torch.ops.ctc import greedy_decode
    from conformer_tpu_torch.train.steps import make_forward

    forward = make_forward(cfg, model)
    aud = torch.from_numpy(audio[None, :]).to(device)
    ln = torch.tensor([len(audio)], dtype=torch.int32, device=device)

    def decode():
        logits, out_lengths = forward(aud, ln)
        return greedy_decode(logits, out_lengths)

    decode()                                       # warm
    sync(device)
    t0 = time.perf_counter()
    ids, n = decode()
    ids, n = ids.cpu().numpy(), n.cpu().numpy()
    seconds = time.perf_counter() - t0
    return tok.collapsed_ids_to_text(ids[0, : int(n[0])]), seconds


def stream_text(cfg, tok, model, audio: np.ndarray, chunk_s: float,
                ctx_s: float, decode: str, block: int) -> "tuple[str, float]":
    """The audio fed in blocks of ``block`` samples to a transcriber warmed
    on a throwaway instance -> (text, wall seconds)."""
    from conformer_tpu_torch.decode.streaming import StreamingTranscriber

    sr = cfg.audio.sample_rate
    st = StreamingTranscriber(cfg, tok, model, chunk_s=chunk_s,
                              left_context_s=ctx_s, decode=decode)
    st.feed(audio[: int((chunk_s + ctx_s + 1) * sr)])
    st.finish()
    st = StreamingTranscriber(cfg, tok, model, chunk_s=chunk_s,
                              left_context_s=ctx_s, decode=decode)
    t0 = time.perf_counter()
    parts = [st.feed(audio[i: i + block])
             for i in range(0, len(audio), block)]
    parts.append(st.finish())
    return "".join(parts), time.perf_counter() - t0


def sweep(cfg, tok, model, audio: np.ndarray, chunks, contexts,
          decode: str = "greedy", block_ms: float = 100.0,
          device: torch.device = torch.device("cuda")) -> List[dict]:
    """-> the offline row, then a row per (chunk, context), each printed as
    one JSON line without its text."""
    from conformer_tpu_torch.text.metrics import cer

    sr = cfg.audio.sample_rate
    total_s = len(audio) / sr
    block = int(block_ms / 1e3 * sr)
    model = model.to(device).eval()

    def emit(row: dict) -> None:
        print(json.dumps({k: v for k, v in row.items() if k != "text"}),
              flush=True)
        rows.append(row)

    rows: List[dict] = []
    text, seconds = offline_text(cfg, tok, model, audio, device)
    emit({"offline_greedy_rtf": round(seconds / total_s, 6),
          "total_s": total_s, "decode": decode,
          "offline_chars": len(text), "text": text})
    for chunk_s in chunks:
        for ctx_s in contexts:
            if ctx_s < chunk_s:
                continue
            try:
                streamed, dt = stream_text(cfg, tok, model, audio, chunk_s,
                                           ctx_s, decode, block)
            except ValueError as e:
                emit({"chunk_s": chunk_s, "left_context_s": ctx_s,
                      "error": f"{type(e).__name__}: {str(e)[:160]}"})
                continue
            div = cer([streamed], [text]) if text else 0.0
            emit({"chunk_s": chunk_s, "left_context_s": ctx_s,
                  "rtf": round(dt / total_s, 6),
                  "divergence_cer_vs_offline": round(float(div), 4),
                  "streamed_chars": len(streamed), "text": streamed})
    return rows


def noise(total_s: float, sr: int) -> np.ndarray:
    """The JAX tool's audio: seeded noise at 0.1."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal(int(total_s * sr)) * 0.1).astype(np.float32)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--total-s", type=float, default=60.0)
    ap.add_argument("--block-ms", type=float, default=100.0)
    ap.add_argument("--decode", default="greedy",
                    choices=["greedy", "beam", "beam_device"])
    ap.add_argument("--chunks", type=float, nargs="+",
                    default=[0.5, 1.0, 2.0, 4.0])
    ap.add_argument("--contexts", type=float, nargs="+", default=[2.0, 6.0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("sweep_streaming needs a CUDA device (or "
                             "--device cpu)")
        from conformer_tpu_torch.tools.trace_step import card

        print(card(), flush=True)

    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    tok = load_tokenizer("vi")
    cfg = Config().override(**{"model.vocab_size": tok.vocab_size})
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
    return sweep(cfg, tok, model, noise(args.total_s, cfg.audio.sample_rate),
                 args.chunks, args.contexts, args.decode, args.block_ms,
                 torch.device(args.device))


if __name__ == "__main__":
    main()
