"""Evaluate a trained model: corpus WER/CER (x100) and the loss, with
greedy decoding or a beam search fused with an n-gram LM, on the GPU
unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.test --manifest eval.csv \
        --checkpoint-dir ./checkpoints [--results results.csv] \
        [--lm lm.arpa --decode beam]

The manifest is a CSV of (path, text) rows pointing at WAV files. Weights
come from the newest checkpoint in ``--checkpoint-dir`` (written by
``conformer_tpu_torch.cli.train``, whose ``config.json`` there also sets the
model) or from a state dict (``--weights``). ``--results`` writes the
(label, prediction) pairs as CSV. ``--lm`` takes an ARPA file (see
``conformer_tpu_torch.cli.create_lm``) and ``--decode beam`` the host beam
search at ``decode.*``'s operating point (beam 190, alpha 2.1, beta 9.2,
``--set decode.hotwords='["..."]'``). ``--decode auto`` is greedy without an
LM (``decode.lm_path`` or ``decode.device_lm_path``) and ``beam_auto``
with one, which on the GPU means the device beam search (``--decode
beam_device``: ops/beam_search_device.py through CUDA graphs, word-level
fusion and hotwords from ``--lm``, token-level from
``decode.device_lm_path``) and on the CPU the host one. A transducer
checkpoint runs its RNN-T beam search for any beam mode.

Over several ranks, one process each, a (dp, tp) mesh (decode/pipeline.py:
each data rank evaluates its stripe of every batch, the n-gram table's
buckets split over the model group):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m conformer_tpu_torch.cli.test --dp 2 --tp 2 --manifest ... \
        [--lm lm.arpa --decode beam_device]

with ``--device cpu`` over gloo (the device search's frame steps then run
eagerly: gloo's sums go through the host), or one card a rank over NCCL
(the frame steps in CUDA graphs, the sums captured). Every rank computes the
same metrics; rank 0 alone prints them and writes ``--results``.
"""

from __future__ import annotations

import argparse
import csv

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            load_config, lm_decode,
                                            load_tokenizer_from_args,
                                            setup_mesh)


def main(argv=None) -> dict:
    """Run the CLI; returns the metrics {wer, cer, loss}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--weights", default=None,
                   help="torch state dict (see conformer_tpu_torch.convert)")
    p.add_argument("--decode", choices=["auto", "greedy", "beam", "beam_device",
                                        "beam_auto"], default="auto",
                   help="'auto' = greedy without an LM, beam_auto with one")
    p.add_argument("--lm", default=None,
                   help="ARPA n-gram LM for the beam search")
    p.add_argument("--results", default=None,
                   help="CSV path for the (label, prediction) pairs")
    args = p.parse_args(argv)

    cfg = load_config(args)
    cfg, decode = lm_decode(args, cfg)
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import (InferencePipeline,
                                                     resolve_device)
    from conformer_tpu_torch.parallel.mesh import local_device

    resolve_device(args.device)       # no GPU and no --device cpu: raise now
    device = local_device(args.device)
    mesh = setup_mesh(args, device)
    if mesh is not None:
        cfg = cfg.override(**{"parallel.dp": mesh.dp, "parallel.tp": mesh.tp})
    pipe = InferencePipeline(cfg, tokenizer, weights=args.weights,
                             decode=decode, device=device,
                             checkpoint_dir=args.checkpoint_dir, mesh=mesh)
    if mesh is not None:
        from conformer_tpu_torch.parallel.collectives import capturable

        # the device searches' frame steps on the card: a sum over a gloo
        # model group goes through the host, which no CUDA graph holds
        eager = mesh.tp > 1 and not capturable(mesh.model_group)
        pipe.print(f"[test] mesh dp {mesh.dp} x tp {mesh.tp}, frame steps "
                   f"{'eager' if eager else 'graph'}")
    metrics, pairs = pipe.evaluate(args.manifest)
    if not pipe.lead:
        return metrics
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
