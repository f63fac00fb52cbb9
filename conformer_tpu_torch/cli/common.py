"""Shared CLI plumbing: ``--config`` JSON plus dotted ``--set`` overrides,
the tokenizer choice, the device and the mesh (counterpart of
conformer_tpu/cli/common.py)."""

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


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = the ranks there are / "
                        "tp)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size")
    p.add_argument("--multihost", action="store_true",
                   help="a launch over several nodes: initialise from the "
                        "launcher's environment and give each node its "
                        "stripe of the manifest")


def refuse_mesh(args: argparse.Namespace, cli: str) -> None:
    """The JAX CLIs take ``--dp``/``--tp``/``--multihost`` everywhere but
    build a mesh only in train, test and pretrain; the others run on one
    device. The port's take the flags too, and refuse a mesh rather than
    ignore one."""
    if max(args.dp, 1) * args.tp > 1 or args.multihost:
        raise SystemExit(f"{cli} runs on one device; --dp, --tp and "
                         "--multihost are for cli.train, cli.test and "
                         "cli.pretrain")


def setup_mesh(args: argparse.Namespace, device):
    """-> the (dp, tp) mesh over the launcher's ranks, or None for one rank
    (counterpart of the JAX setup_mesh). One process per rank, as
    ``torch.distributed.run`` starts them: the default process group comes
    from its environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; NCCL
    for a CUDA device, gloo for the CPU) unless the caller initialised one.
    ``--multihost`` insists on that environment (the counterpart of
    ``jax.distributed.initialize``). A world size other than dp * tp
    raises."""
    from conformer_tpu_torch.parallel.mesh import (init_process_group,
                                                   make_mesh, world_size)

    if args.multihost and "RANK" not in os.environ:
        raise SystemExit("--multihost needs a launcher's environment "
                         "(MASTER_ADDR, RANK, WORLD_SIZE): launch with "
                         "torch.distributed.run")
    init_process_group(device)
    n = world_size()
    dp = args.dp or max(n // args.tp, 1)
    if dp * args.tp == 1 and n == 1:
        return None
    return make_mesh(dp, args.tp, device)


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
    run and the other CLIs rebuild the same model (under a mesh, rank 0
    writes it)."""
    import torch.distributed as dist

    if not directory or (dist.is_initialized() and dist.get_rank() != 0):
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
