"""Evaluate a trained model: corpus WER/CER (x100) and the CTC loss with
greedy decoding, on the GPU unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.test --manifest eval.csv \
        --checkpoint-dir ./checkpoints [--results results.csv]

The manifest is a CSV of (path, text) rows pointing at WAV files. Weights
come from the newest checkpoint in ``--checkpoint-dir`` (written by
``conformer_tpu_torch.cli.train``, whose ``config.json`` there also sets the
model) or from a state dict (``--weights``). ``--results`` writes the
(label, prediction) pairs as CSV. Beam search (``--decode beam``,
``beam_device``, ``beam_auto``) and LM fusion (``--lm``) are not ported yet
and raise.
"""

from __future__ import annotations

import argparse
import csv

from conformer_tpu_torch.cli.common import (add_common_args, load_config,
                                            load_tokenizer_from_args,
                                            refuse_lm_decode)


def main(argv=None) -> dict:
    """Run the CLI; returns the metrics {wer, cer, loss}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--weights", default=None,
                   help="torch state dict (see conformer_tpu_torch.convert)")
    p.add_argument("--decode", choices=["auto", "greedy", "beam", "beam_device",
                                        "beam_auto"], default="auto")
    p.add_argument("--lm", default=None, help="not ported: refused")
    p.add_argument("--results", default=None,
                   help="CSV path for the (label, prediction) pairs")
    args = p.parse_args(argv)

    cfg = load_config(args)
    refuse_lm_decode(args, cfg)
    decode = "greedy" if args.decode == "auto" else args.decode
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             decode=decode, device=args.device,
                             checkpoint_dir=args.checkpoint_dir)
    metrics, pairs = pipe.evaluate(args.manifest)
    print(f"WER: {metrics['wer']:.2f}%  CER: {metrics['cer']:.2f}%  "
          f"loss: {metrics['loss']:.4f}")
    if args.results:
        with open(args.results, "w", newline="", encoding="utf8") as f:
            w = csv.writer(f)
            w.writerow(["label", "prediction"])
            w.writerows(pairs)
        print(f"wrote {len(pairs)} rows to {args.results}")
    return metrics


if __name__ == "__main__":
    main()
