"""Pseudo-labelling: transcribe unlabelled audio into a manifest
(counterpart of conformer_tpu/cli/pseudo_label.py), on the GPU unless
``--device cpu`` is given.

The model's own transcripts (greedy, or the host or device beam search
with an LM) become the labels, filtered by confidence: the mean over an
utterance's frames of the largest log-probability, so that only utterances
the model is sure of enter retraining.

    python -m conformer_tpu_torch.cli.pseudo_label --manifest unlabeled.csv \\
        --checkpoint-dir ckpt --output labeled.csv [--min-confidence -1.0]

Writes a CSV of (path, text, confidence) rows, the text lower-cased and the
confidence rounded to 4 places; utterances with an empty transcript are
left out. ``--weights`` takes a state dict instead of a checkpoint
directory; with neither the model has seeded random weights. A transducer
(``model.arch='transducer'``) raises: the confidence needs a CTC model's
per-frame log-probabilities, which the transducer's greedy decode does not
give (the JAX package's CLI fails on it too, reading ``log_probs`` from the
transducer eval step, which has none).
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            lm_decode, load_config,
                                            load_tokenizer_from_args,
                                            refuse_mesh)

TRANSDUCER_NOT_SUPPORTED = (
    "pseudo-labelling needs a CTC model: its confidence is the mean of the "
    "per-frame log-probabilities, which the transducer (model.arch="
    "'transducer') does not give; see ROADMAP.md §3")


def main(argv=None) -> int:
    """Run the CLI; -> the number of utterances kept."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--manifest", required=True, help="CSV with a path column")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--weights", default=None,
                   help="torch state dict (see conformer_tpu_torch.convert)")
    p.add_argument("--output", required=True)
    p.add_argument("--decode", choices=["greedy", "beam", "beam_device",
                                        "beam_auto"], default="greedy")
    p.add_argument("--lm", default=None)
    p.add_argument("--min-confidence", type=float, default=None,
                   help="drop utterances whose mean frame log-prob is lower")
    p.add_argument("--batch-size", type=int, default=8)
    args = p.parse_args(argv)
    refuse_mesh(args, "cli.pseudo_label")

    cfg = load_config(args)
    if cfg.model.arch == "transducer":
        raise NotImplementedError(TRANSDUCER_NOT_SUPPORTED)
    cfg, decode = lm_decode(args, cfg)
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.audio.io import load_audio
    from conformer_tpu_torch.data.dataset import load_manifest
    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             checkpoint_dir=args.checkpoint_dir,
                             decode=decode, device=args.device)
    paths = [row["path"] for row in load_manifest(args.manifest)]
    sr = cfg.audio.sample_rate
    rows = []
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i: i + args.batch_size]
        signals = [load_audio(pth, sr) for pth in chunk]
        size = max(max(len(s) for s in signals), cfg.audio.hop_length)
        audio = np.zeros((len(chunk), size), np.float32)
        lengths = np.zeros((len(chunk),), np.int64)
        for j, s in enumerate(signals):
            audio[j, : len(s)] = s
            lengths[j] = len(s)
        out, texts = pipe.run_batch(audio, lengths)
        log_probs = out["log_probs"].float().cpu().numpy()
        out_lengths = out["lengths"].cpu().numpy()
        for j, (pth, text) in enumerate(zip(chunk, texts)):
            n = max(int(out_lengths[j]), 1)
            conf = float(log_probs[j, :n].max(axis=-1).mean())
            if not text:
                continue
            if args.min_confidence is not None and conf < args.min_confidence:
                continue
            rows.append({"path": pth, "text": text.lower(),
                         "confidence": round(conf, 4)})

    with open(args.output, "w", newline="", encoding="utf8") as f:
        w = csv.DictWriter(f, fieldnames=["path", "text", "confidence"])
        w.writeheader()
        w.writerows(rows)
    print(f"pseudo-labeled {len(rows)}/{len(paths)} utterances -> "
          f"{args.output}")
    return len(rows)


if __name__ == "__main__":
    main()
