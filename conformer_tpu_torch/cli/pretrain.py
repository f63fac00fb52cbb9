"""Self-supervised pretraining (wav2vec2 contrastive or BYOL) on unlabelled
audio, on the GPU unless ``--device cpu`` is given (counterpart of
conformer_tpu/cli/pretrain.py).

    python -m conformer_tpu_torch.cli.pretrain --manifest unlabelled.csv \\
        --method wav2vec2 --checkpoint-dir ./pretrain_ckpt

The manifest (CSV or parquet) needs only a ``path`` column. Checkpoints,
``config.json`` and ``metrics.jsonl`` (``pretrain/`` metrics) go to
``--checkpoint-dir``; a second run with the same directory resumes from the
newest checkpoint. ``cli.train --init-encoder-from <dir> --init-method
<method>`` then starts supervised training from the pretrained encoder.
"""

from __future__ import annotations

import argparse

from conformer_tpu_torch.cli.common import (add_common_args, load_config,
                                            load_tokenizer_from_args,
                                            save_config)


def main(argv=None):
    """Run the CLI; returns the Pretrainer it used."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--method", choices=["wav2vec2", "byol"], default=None)
    p.add_argument("--checkpoint-dir", default=None)
    args = p.parse_args(argv)

    cfg = load_config(args)
    overrides = {"data.train_manifest": args.manifest}
    if args.method:
        overrides["pretrain.method"] = args.method
    if args.checkpoint_dir:
        overrides["train.checkpoint_dir"] = args.checkpoint_dir
    cfg = cfg.override(**overrides)

    from conformer_tpu_torch.decode.pipeline import resolve_device
    from conformer_tpu_torch.train.logging import MetricsLogger
    from conformer_tpu_torch.train.pretrain import Pretrainer

    resolve_device(args.device)       # no GPU and no --device cpu: raise now
    tokenizer = load_tokenizer_from_args(args, cfg)   # batch plumbing only
    save_config(cfg, cfg.train.checkpoint_dir)
    logger = MetricsLogger(cfg.train.checkpoint_dir)
    try:
        runner = Pretrainer(cfg, tokenizer, logger=logger, device=args.device)
        runner.fit()
    finally:
        logger.close()
    return runner


if __name__ == "__main__":
    main()
