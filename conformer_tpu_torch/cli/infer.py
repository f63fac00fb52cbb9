"""Transcribe audio files or a CSV or parquet manifest with greedy decoding
or a beam search fused with an n-gram LM (``--lm lm.arpa --decode beam``:
the host search; ``--decode beam_device``: the device search), on the GPU
unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.infer --audio a.wav b.flac --weights w.pt
    python -m conformer_tpu_torch.cli.infer --audio a.wav --checkpoint-dir ck
    python -m conformer_tpu_torch.cli.infer --manifest m.parquet --output out.csv
    python -m conformer_tpu_torch.cli.infer --audio long.wav --streaming

``--checkpoint-dir`` restores the newest checkpoint of a training run (and
reads its ``config.json`` unless ``--config`` is given); ``--weights``
takes a state dict written by ``conformer_tpu_torch.convert``; with neither
the model has seeded random weights. A manifest has a ``path`` column; with
``start`` and ``end`` columns (seconds) and no ``--audio``, each row is that
segment of its file. ``--decode auto`` is greedy without an LM and
``beam_auto`` with one, which offline on the GPU means the device beam
search (through CUDA graphs) and for ``--streaming`` the host beam search;
a transducer runs its RNN-T beam search for any beam mode. ``--streaming``
feeds each file through a ``StreamingTranscriber`` (decode/streaming.py) in
chunks of ``--stream-chunk-seconds`` with ``--stream-context-seconds`` of
left context.
"""

from __future__ import annotations

import argparse
import csv

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            load_config, lm_decode,
                                            load_tokenizer_from_args,
                                            refuse_mesh)


def main(argv=None):
    """Run the CLI; returns the InferencePipeline it used (its
    ``batch_log`` holds per-batch timings)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--audio", nargs="*", default=[], help="audio file(s)")
    p.add_argument("--manifest", default=None,
                   help="CSV or parquet manifest with a path column")
    source = p.add_mutually_exclusive_group()
    source.add_argument("--checkpoint-dir", default=None,
                        help="restore the newest checkpoint of this "
                             "training directory")
    source.add_argument("--weights", default=None,
                        help="torch state dict (see "
                             "conformer_tpu_torch.convert)")
    p.add_argument("--decode", choices=["auto", "greedy", "beam",
                                        "beam_device", "beam_auto"],
                   default="auto")
    p.add_argument("--lm", default=None,
                   help="ARPA n-gram LM for the beam search")
    p.add_argument("--output", default=None, help="CSV output")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--channel", type=int, default=None,
                   help="channel of multi-channel recordings")
    p.add_argument("--long", action="store_true",
                   help="chunked transcription for long recordings")
    p.add_argument("--chunk-seconds", type=float, default=24.0)
    p.add_argument("--streaming", action="store_true",
                   help="stateful streaming decode (left-context-carry "
                        "encoder chunks, incremental emission)")
    p.add_argument("--stream-chunk-seconds", type=float, default=2.0)
    p.add_argument("--stream-context-seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    refuse_mesh(args, "cli.infer")

    if not args.audio and not args.manifest:
        raise SystemExit("need --audio files or --manifest")
    cfg = load_config(args)
    cfg, decode = lm_decode(args, cfg)
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    if args.streaming:
        from conformer_tpu_torch.decode.streaming import \
            resolve_streaming_decode

        decode = resolve_streaming_decode(cfg, decode)
    # streaming decodes in its transcriber; the pipeline then only holds
    # the model
    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             checkpoint_dir=args.checkpoint_dir,
                             decode="greedy" if args.streaming else decode,
                             device=args.device)
    paths = list(args.audio)
    segments = None
    if args.manifest:
        from conformer_tpu_torch.data.dataset import load_manifest

        rows = load_manifest(args.manifest)
        if rows and {"start", "end"} <= set(rows[0]) and not paths:
            # one row per (path, start, end) span of a recording
            segments = [(r["start"], r["end"]) for r in rows]
        paths.extend(r["path"] for r in rows)

    if args.streaming:
        from conformer_tpu_torch.audio.io import load_audio

        st = pipe.streaming_transcriber(
            chunk_s=args.stream_chunk_seconds,
            left_context_s=args.stream_context_seconds, decode=decode)
        texts = []
        for p_ in paths:
            st.reset()
            st.feed(load_audio(p_, cfg.audio.sample_rate,
                               channel=args.channel))
            st.finish()
            texts.append(st.text)
    elif args.long:
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
