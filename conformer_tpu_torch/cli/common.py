"""Shared CLI plumbing: ``--config`` JSON plus dotted ``--set`` overrides,
the tokenizer choice and the device (counterpart of the single-device part
of conformer_tpu/cli/common.py)."""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

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
    """--config wins; otherwise <checkpoint-dir>/config.json when the CLI has
    a checkpoint directory and training wrote one (see save_config);
    otherwise the defaults. Then the --set overrides."""
    path = args.config
    ck_dir = getattr(args, "checkpoint_dir", None)
    if path is None and ck_dir:
        cand = os.path.join(ck_dir, "config.json")
        if os.path.exists(cand):
            path = cand
            print(f"[config] using {cand}")
    cfg = Config.from_json(path) if path else Config()
    overrides = {}
    for item in args.overrides:
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, raw = item.split("=", 1)
        overrides[key] = parse_value(raw)
    return cfg.override(**overrides) if overrides else cfg


def save_config(cfg: Config, directory: Optional[str]) -> None:
    """Write the composed config next to the checkpoints, so that a resumed
    run and the other CLIs rebuild the same model."""
    if not directory:
        return
    os.makedirs(directory, exist_ok=True)
    cfg.to_json(os.path.join(directory, "config.json"))


def load_tokenizer_from_args(args: argparse.Namespace, cfg: Config):
    """CLI flag, then ``cfg.train.tokenizer_path``, then 'vi'."""
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    return load_tokenizer(args.tokenizer or cfg.train.tokenizer_path or "vi")


def lm_decode(args: argparse.Namespace, cfg: Config) -> "tuple[Config, str]":
    """-> (cfg with ``--lm`` as decode.lm_path, the decode mode): ``--decode
    auto`` is greedy without an LM (decode.lm_path or
    decode.device_lm_path) and beam_auto with one, as in the JAX CLIs."""
    if args.lm:
        cfg = cfg.override(**{"decode.lm_path": args.lm})
    decode = args.decode
    if decode == "auto":
        has_lm = cfg.decode.lm_path or cfg.decode.device_lm_path
        decode = "beam_auto" if has_lm else "greedy"
    return cfg, decode
