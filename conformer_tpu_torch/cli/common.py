"""Shared CLI plumbing: ``--config`` JSON plus dotted ``--set`` overrides,
the tokenizer choice and the device (counterpart of the single-device part
of conformer_tpu/cli/common.py)."""

from __future__ import annotations

import argparse
import json

from conformer_tpu_torch.config import Config


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="path to a Config JSON")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set model.d_model=256")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer spec name or path (vi, en, or a JSON "
                        "path); defaults to train.tokenizer_path, then 'vi'")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; fails without a GPU), "
                        "'cuda:N' or 'cpu'")


def parse_value(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def load_config(args: argparse.Namespace) -> Config:
    """--config (or the defaults), then the --set overrides."""
    cfg = Config.from_json(args.config) if args.config else Config()
    overrides = {}
    for item in args.overrides:
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, raw = item.split("=", 1)
        overrides[key] = parse_value(raw)
    return cfg.override(**overrides) if overrides else cfg


def load_tokenizer_from_args(args: argparse.Namespace, cfg: Config):
    """CLI flag, then ``cfg.train.tokenizer_path``, then 'vi'."""
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    return load_tokenizer(args.tokenizer or cfg.train.tokenizer_path or "vi")
