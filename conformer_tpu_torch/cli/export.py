"""Export a trained checkpoint to ``torch.export`` programs, one per audio
bucket, on the GPU unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.export --checkpoint-dir ckpt \
        --out exported [--batch-size 1 --audio-seconds 8 24]

The flags are those of ``conformer_tpu.cli.export`` plus ``--device``.
Weights come from the newest checkpoint in ``--checkpoint-dir`` (written by
``conformer_tpu_torch.cli.train``, whose ``config.json`` there also sets
the model). A CTC program gives (logits, lengths), a transducer program
(greedy tokens, counts); ``--decode beam`` bakes the device beam search
(CTC or RNN-T) into each program, fused with ``decode.device_lm_path``
(token level) or ``decode.lm_path`` and ``decode.hotwords`` (word level),
which then gives the best beam's (tokens, counts).
``conformer_tpu_torch.export.ExportedModel`` runs them.

    python -m conformer_tpu_torch.cli.export --checkpoint-dir ckpt \
        --out exported --decode beam --set decode.lm_path=lm/lm.arpa \
        --set decode.beam_width=190 --set 'decode.hotwords=["XIN CHÀO"]'
"""

from __future__ import annotations

import argparse

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            load_config,
                                            load_tokenizer_from_args,
                                            refuse_mesh)


def main(argv=None):
    """Run the CLI; -> the program files written."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--audio-seconds", type=float, nargs="+", default=[8.0])
    p.add_argument("--decode", choices=["logits", "beam"], default="logits",
                   help="'beam' bakes the LM-fused device beam search into "
                        "the program: (tokens, counts) of the best beam")
    args = p.parse_args(argv)
    refuse_mesh(args, "cli.export")

    cfg = load_config(args)
    tokenizer = load_tokenizer_from_args(args, cfg)
    cfg = cfg.override(**{"model.vocab_size": tokenizer.vocab_size})

    from conformer_tpu_torch.decode.pipeline import resolve_device
    from conformer_tpu_torch.export import export_model
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    mgr = CheckpointManager(args.checkpoint_dir)
    if mgr.latest_step() is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=None)
    step, _ = mgr.restore(model)
    files = export_model(cfg, model.to(device), args.out,
                         batch_size=args.batch_size,
                         audio_seconds=tuple(args.audio_seconds),
                         decode=args.decode, tokenizer=tokenizer)
    print(f"exported step {step} to {args.out}:")
    for f in files:
        print(" ", f)
    return files


if __name__ == "__main__":
    main()
