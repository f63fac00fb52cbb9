"""Transcribe audio files or a CSV manifest with greedy CTC decoding, on the
GPU unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.infer --audio a.wav b.wav --weights w.pt
    python -m conformer_tpu_torch.cli.infer --manifest batch.csv --output out.csv

``--weights`` takes a state dict written by ``conformer_tpu_torch.convert``;
without it the model has seeded random weights. Beam search, LM fusion and
streaming are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import csv

from conformer_tpu_torch.cli.common import (add_common_args, load_config,
                                            load_tokenizer_from_args,
                                            refuse_lm_decode)


def read_manifest(path: str):
    """CSV with a ``path`` column (and optional ``start``/``end`` seconds)
    -> (paths, segments or None)."""
    with open(path, newline="", encoding="utf8") as f:
        rows = list(csv.DictReader(f))
    paths = [r["path"] for r in rows]
    segments = None
    if rows and "start" in rows[0] and "end" in rows[0]:
        segments = [(float(r["start"]), float(r["end"])) for r in rows]
    return paths, segments


def main(argv=None):
    """Run the CLI; returns the InferencePipeline it used (its
    ``batch_log`` holds per-batch timings)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--audio", nargs="*", default=[], help="audio file(s)")
    p.add_argument("--manifest", default=None,
                   help="CSV manifest with a path column")
    p.add_argument("--weights", default=None,
                   help="torch state dict (see conformer_tpu_torch.convert)")
    p.add_argument("--decode", choices=["auto", "greedy", "beam",
                                        "beam_device", "beam_auto"],
                   default="auto")
    p.add_argument("--lm", default=None)
    p.add_argument("--output", default=None, help="CSV output")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--channel", type=int, default=None,
                   help="channel of multi-channel recordings")
    p.add_argument("--long", action="store_true",
                   help="chunked transcription for long recordings")
    p.add_argument("--chunk-seconds", type=float, default=24.0)
    p.add_argument("--streaming", action="store_true")
    args = p.parse_args(argv)

    if not args.audio and not args.manifest:
        raise SystemExit("need --audio files or --manifest")
    if args.streaming:
        raise NotImplementedError(
            "--streaming: streaming decode is not ported yet (a later slice)")
    cfg = load_config(args)
    refuse_lm_decode(args, cfg)
    decode = "greedy" if args.decode == "auto" else args.decode
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             decode=decode, device=args.device)
    paths = list(args.audio)
    segments = None
    if args.manifest:
        manifest_paths, manifest_segments = read_manifest(args.manifest)
        if manifest_segments is not None and not paths:
            segments = manifest_segments
        paths.extend(manifest_paths)

    if args.long:
        texts = [pipe.transcribe_long(p_, chunk_s=args.chunk_seconds,
                                      channel=args.channel) for p_ in paths]
    else:
        texts = pipe.transcribe_files(paths, batch_size=args.batch_size,
                                      channel=args.channel, segments=segments)
    for path, text in zip(paths, texts):
        print(f"{path}\t{text}")
    if args.output:
        with open(args.output, "w", newline="", encoding="utf8") as f:
            w = csv.writer(f)
            w.writerow(["path", "prediction"])
            w.writerows(zip(paths, texts))
    return pipe


if __name__ == "__main__":
    main()
