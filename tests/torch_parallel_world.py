"""One rank of the gloo world that tests/test_torch_parallel.py spawns: runs
every mesh case of ``cases.json`` (in the directory given) through the
port's train step and writes what the test compares.

    python tests/torch_parallel_world.py DIR RANK WORLD PORT

``DIR/cases.json`` lists the cases: name, config overrides, dp, tp, steps,
the batch (an ``.npz`` in DIR) and the weights (a state_dict ``.pt`` in
DIR), and for the dropout case the seed words of every site. Rank 0 writes
``DIR/results.pt``: per case the global losses, the single-device
state_dict after the first and the last step, and every rank's shapes of
the tensors Adam updates; plus the message of a mesh that does not fit the
world.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def run_case(case, directory):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models import encoder
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.parallel.mesh import (batch_stripe,
                                                   full_state_dict, make_mesh,
                                                   shard_model)
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    cfg = Config().override(**case["overrides"])
    mesh = make_mesh(case["dp"], case["tp"], "cpu")
    model = build_model(cfg.model, "float32", seed=None)
    model.load_state_dict(torch.load(os.path.join(directory, case["weights"])))
    shard_model(model, mesh, cfg.model)
    opt = make_optimizer(cfg.optim, model.parameters(), 10, mesh,
                         zero=cfg.parallel.zero)
    step = make_train_step(cfg, model, opt, mesh=mesh)
    words = case.get("dropout_words")
    if words is not None:       # every forward draws these seed words
        encoder.dropout_seed_words = lambda seed, n: (words[0], words[1])
    batch = np.load(os.path.join(directory, case["batch"]))
    arrays = batch_stripe([batch[k] for k in ("audio", "audio_lengths",
                                              "tokens", "token_lengths")],
                          mesh)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    args[1:] = [a.long() for a in args[1:]]
    losses, states = [], []
    for i in range(case["steps"]):
        metrics = step(*args, i)
        losses.append(float(metrics["loss"]))
        states.append({k: v.clone() for k, v in
                       full_state_dict(model, mesh).items()})
    shapes = [(tuple(p.shape), tuple(t.shape))
              for p, t in zip(opt.params, opt.targets)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, shapes)
    return {"losses": losses, "first": states[0], "last": states[-1],
            "shapes": every, "zero_dims": opt.zero_dims}


def main():
    directory, rank, world, port = sys.argv[1], *map(int, sys.argv[2:5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from conformer_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(directory, "cases.json"), encoding="utf8") as f:
        cases = json.load(f)
    results = {}
    for case in cases:
        results[case["name"]] = run_case(case, directory)
    try:
        make_mesh(3, 1, "cpu")
        results["misfit"] = None
    except ValueError as e:
        results["misfit"] = str(e)
    if rank == 0:
        tmp = os.path.join(directory, "results.pt.tmp")
        torch.save(results, tmp)
        os.replace(tmp, os.path.join(directory, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
