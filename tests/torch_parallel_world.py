"""One rank of the gloo world that tests/test_torch_parallel.py spawns: runs
every mesh case of ``cases.json`` (in the directory given) through the
port's train step, sharded searches, eval step or pretraining steps, and
writes what the test compares.

    python tests/torch_parallel_world.py DIR RANK WORLD PORT

``DIR/cases.json`` lists the cases: name, config overrides, dp, tp, steps,
the batch (an ``.npz`` in DIR) and the weights (a state_dict ``.pt`` in
DIR), and for the dropout case the seed words of every site. Rank 0 writes
``DIR/results.pt``: per case the global losses, the single-device
state_dict after the first and the last step, and every rank's shapes of
the tensors Adam updates; plus the message of a mesh that does not fit the
world. The other kinds of case (``kind``): ``ctc_search`` and
``rnnt_search`` (the sharded searches on the inputs of an ``.npz`` and an
ARPA, the table whole or as the rank's part), ``eval_beam`` (the
transducer eval step with ``decode="beam"``) and ``pretrain`` (wav2vec2 or
BYOL steps on the JAX step's draws, which the test writes to
``draws_<name>.npz`` while the world runs: the rank waits for the file)
write every rank's outputs.
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


def _gather(obj):
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def _lm_kwargs(case, directory, mesh, data):
    from conformer_tpu_torch.lm.device_table import (DeviceHotwords,
                                                     DeviceNgramTable,
                                                     DeviceWordVocab)

    cpu = torch.device("cpu")
    table = DeviceNgramTable.from_arpa(os.path.join(directory, case["arpa"]))
    part = (mesh.model_index, mesh.tp) if case.get("part") else None
    kw = dict(case["kw"], lm_tables=table.device_arrays(cpu, part),
              lm_bos_id=int(table.bos_id), lm_unk_logp=float(table.unk_logp),
              lm_order=int(table.order))
    if "tok2lm" in data:
        kw["tok2lm"] = torch.from_numpy(data["tok2lm"]).long()
    if case.get("words"):
        kw["word_arrays"] = DeviceWordVocab.build(
            case["words"], table.vocab).device_arrays(cpu)
    if case.get("hotwords"):
        kw["hot_arrays"] = DeviceHotwords.build(
            case["hotwords"]).device_arrays(cpu)
    return kw


def _toy_rnnt(data):
    """tests/test_transducer.py's toy joint and prediction step in torch
    (the port's state format: a list of (c, h) pairs)."""
    w1 = torch.from_numpy(data["w1"])
    emb = torch.from_numpy(data["emb"])

    def joint_fn(enc_t, pred):
        return torch.tanh(torch.cat([enc_t, pred], -1)) @ w1 * 2.0

    def pred_step_fn(state, tok):
        new = torch.tanh(state[0][0] * 0.7 + emb[tok])
        return [(new, new)], new

    return joint_fn, pred_step_fn


def run_search(case, directory):
    from conformer_tpu_torch.ops.beam_search_device import \
        ctc_beam_search_device_sharded
    from conformer_tpu_torch.ops.rnnt import rnnt_beam_search_sharded
    from conformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(case["dp"], case["tp"], "cpu")
    data = np.load(os.path.join(directory, case["inputs"]))
    kw = _lm_kwargs(case, directory, mesh, data)
    lengths = torch.from_numpy(data["lengths"]).long()
    if case["kind"] == "ctc_search":
        out = ctc_beam_search_device_sharded(
            torch.from_numpy(data["log_probs"]), lengths, mesh=mesh, **kw)
    else:
        joint_fn, pred_step_fn = _toy_rnnt(data)
        enc = torch.from_numpy(data["enc"])
        state0 = torch.zeros((enc.shape[0], data["emb"].shape[1]))
        out = rnnt_beam_search_sharded(joint_fn, enc, lengths, pred_step_fn,
                                       ([(state0, state0)], state0),
                                       mesh=mesh, **kw)
    return {"ranks": _gather({"data_index": mesh.data_index,
                              "out": [x.numpy() for x in out]})}


def run_eval_beam(case, directory):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.parallel.mesh import (batch_stripe, make_mesh,
                                                   shard_model)
    from conformer_tpu_torch.train.steps import make_transducer_eval_step

    cfg = Config().override(**case["overrides"])
    mesh = make_mesh(case["dp"], case["tp"], "cpu")
    model = build_model(cfg.model, "float32", seed=None)
    model.load_state_dict(torch.load(os.path.join(directory, case["weights"])))
    shard_model(model, mesh, cfg.model)
    data = np.load(os.path.join(directory, case["inputs"]))
    step = make_transducer_eval_step(
        cfg, model, decode="beam", lm_kwargs=_lm_kwargs(case, directory,
                                                        mesh, data),
        mesh=mesh)
    batch = np.load(os.path.join(directory, case["batch"]))
    arrays = batch_stripe([batch[k] for k in ("audio", "audio_lengths",
                                              "tokens", "token_lengths")],
                          mesh)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    args[1:] = [a.long() for a in args[1:]]
    out = step(*args)
    return {"ranks": _gather({"data_index": mesh.data_index,
                              "out": {k: v.numpy() for k, v in out.items()}})}


def _wait_for(path, seconds=600):
    import time

    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > seconds:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.5)
    return np.load(path)


def run_pretrain(case, directory):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models import quantizer, wav2vec2
    from conformer_tpu_torch.parallel.mesh import (batch_stripe,
                                                   full_state_dict, make_mesh,
                                                   shard_model)
    from conformer_tpu_torch.train.pretrain import (build_pretrain_model,
                                                    make_pretrain_step)
    from conformer_tpu_torch.train.state import make_optimizer

    cfg = Config().override(**case["overrides"])
    mesh = make_mesh(case["dp"], case["tp"], "cpu")
    model = build_pretrain_model(cfg, seed=None)
    model.load_state_dict(torch.load(os.path.join(directory, case["weights"])))
    shard_model(model, mesh, cfg.model)
    opt = make_optimizer(cfg.optim, model.parameters(), 10, mesh,
                         zero=cfg.parallel.zero)
    step = make_pretrain_step(cfg, model, opt, mesh=mesh)
    batch = np.load(os.path.join(directory, case["batch"]))
    audio, lengths = batch_stripe([batch["audio"], batch["audio_lengths"]],
                                  mesh)
    audio = torch.from_numpy(np.ascontiguousarray(audio))
    lengths = torch.from_numpy(lengths).long()
    if case.get("meshless"):
        # the port's own draws, against its one-device step on this rank
        return {"mesh": _own_steps(step, model, mesh, audio, lengths,
                                   case["steps"]),
                "meshless": _meshless_pretrain(case, directory, batch)}
    draws = _wait_for(os.path.join(directory, f"draws_{case['name']}.npz"))
    losses = []
    for i in range(case["steps"]):
        # the JAX step's draws, all of the global batch's rows
        for module, name, key in ((wav2vec2, "sample_mask_starts", "starts"),
                                  (quantizer, "gumbel_noise", "gumbels"),
                                  (wav2vec2, "sample_negatives",
                                   "negatives")):
            if f"{key}{i}" in draws:
                value = torch.from_numpy(draws[f"{key}{i}"])
                setattr(module, name, lambda *a, v=value: v)
        losses.append(float(step(audio, lengths, i)["loss"]))
    return {"losses": losses, "last": {k: v.clone() for k, v in
                                       full_state_dict(model, mesh).items()}}


def _own_steps(step, model, mesh, audio, lengths, steps):
    from conformer_tpu_torch.parallel.mesh import full_state_dict

    losses = [float(step(audio, lengths, i)["loss"]) for i in range(steps)]
    return {"losses": losses, "last": {k: v.clone() for k, v in
                                       full_state_dict(model, mesh).items()}}


def _meshless_pretrain(case, directory, batch):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.train.pretrain import (build_pretrain_model,
                                                    make_pretrain_step)
    from conformer_tpu_torch.train.state import make_optimizer

    cfg = Config().override(**case["overrides"])
    model = build_pretrain_model(cfg, seed=None)
    model.load_state_dict(torch.load(os.path.join(directory, case["weights"])))
    opt = make_optimizer(cfg.optim, model.parameters(), 10)
    step = make_pretrain_step(cfg, model, opt)
    return _own_steps(step, model, None, torch.from_numpy(batch["audio"]),
                      torch.from_numpy(batch["audio_lengths"]).long(),
                      case["steps"])


RUNNERS = {"ctc_search": run_search, "rnnt_search": run_search,
           "eval_beam": run_eval_beam, "pretrain": run_pretrain}


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
        run = RUNNERS.get(case.get("kind"), run_case)
        results[case["name"]] = run(case, directory)
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
