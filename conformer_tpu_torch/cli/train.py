"""Train the Conformer CTC model or the transducer (``model.arch``), on the
GPU unless ``--device cpu`` is given.

    python -m conformer_tpu_torch.cli.train --train-manifest data.csv \
        --set train.num_epochs=10 --set data.batch_size=32

The flags are those of ``conformer_tpu.cli.train`` plus ``--device``. The
manifest is a CSV of (path, text) rows pointing at WAV files. Checkpoints,
``config.json`` and ``metrics.jsonl`` go to ``--checkpoint-dir``; a second
run with the same directory resumes from the newest checkpoint.
``--init-encoder-from DIR`` (with ``--init-method wav2vec2|byol``) starts
the encoder from the newest checkpoint of a ``cli.pretrain`` run, unless a
supervised checkpoint is resumed. ``--wandb`` is refused (not installed).

Over several ranks, one process each, a (dp, tp) mesh (parallel/mesh.py):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m conformer_tpu_torch.cli.train --dp 2 --tp 2 --train-manifest ... \
        [--set parallel.zero=true] [--set model.seq_shard=true]

with ``--device cpu`` over gloo, or one card a rank (LOCAL_RANK) over NCCL.
Its checkpoints are in the single-device format: a run resumes under
another mesh or none, and ``cli.test`` reads them.
"""

from __future__ import annotations

import argparse

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            load_config,
                                            load_tokenizer_from_args,
                                            save_config, setup_mesh)


def main(argv=None):
    """Run the CLI; returns the Trainer it used."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--train-manifest", default=None)
    p.add_argument("--val-manifest", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--wandb", action="store_true",
                   help="not available: refused")
    p.add_argument("--init-encoder-from", default=None,
                   help="a cli.pretrain checkpoint directory: start the "
                        "encoder from its newest checkpoint")
    p.add_argument("--init-method", choices=["wav2vec2", "byol"], default=None)
    args = p.parse_args(argv)

    cfg = load_config(args)
    overrides = {}
    if args.train_manifest:
        overrides["data.train_manifest"] = args.train_manifest
    if args.val_manifest:
        overrides["data.val_manifest"] = args.val_manifest
    if args.checkpoint_dir:
        overrides["train.checkpoint_dir"] = args.checkpoint_dir
    if args.init_encoder_from:
        overrides["train.init_encoder_from"] = args.init_encoder_from
    if args.init_method:
        overrides["train.init_encoder_method"] = args.init_method
    if overrides:
        cfg = cfg.override(**overrides)
    if not cfg.data.train_manifest:
        raise SystemExit("--train-manifest (or data.train_manifest) is required")
    tokenizer = load_tokenizer_from_args(args, cfg)

    from conformer_tpu_torch.decode.pipeline import resolve_device
    from conformer_tpu_torch.parallel.mesh import local_device
    from conformer_tpu_torch.train.logging import MetricsLogger
    from conformer_tpu_torch.train.trainer import Trainer

    resolve_device(args.device)       # no GPU and no --device cpu: raise now
    device = local_device(args.device)
    mesh = setup_mesh(args, device)
    cfg = cfg.override(**{"parallel.dp": mesh.dp if mesh else 1,
                          "parallel.tp": mesh.tp if mesh else 1})
    lead = mesh is None or mesh.rank == 0
    logger = MetricsLogger(cfg.train.checkpoint_dir if lead else None,
                           use_wandb=args.wandb)
    save_config(cfg, cfg.train.checkpoint_dir)
    trainer = Trainer(cfg, tokenizer, logger=logger, device=device, mesh=mesh,
                      multihost=args.multihost)
    trainer.fit()
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
