"""The port's training path against the JAX package on the CPU.

- ``ops/ctc.py::ctc_loss`` against JAX's ``ctc_loss`` (fp32, rtol 1e-5),
  with ``row_mask`` and a row no alignment fits;
- ``audio/augment.py::spec_augment``: the structure of its masks (the
  generators differ, so the values cannot);
- ``train/state.py``: learning rates and five Adam/AdamW updates with
  clipping against optax (atol 1e-6);
- one train step of the tiny fp32 config (dropout 0, SpecAugment off)
  against ``make_train_step(..., donate=False)``, one and two
  micro-batches: loss and grad norm to 1e-5 relative, every BatchNorm
  statistic to 1e-6, every parameter within 5e-3 of the learning rate;
- per-block remat against none: the same loss, gradients and statistics;
- ``BucketedLoader`` batches against the JAX loader's on a CSV manifest;
- ``cli.train --device cpu``: two steps, checkpoints, resume to step 3; and
  ``--device cuda`` without a GPU raises.
"""

import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import DataConfig as JDataConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.config import OptimConfig as JOptimConfig
from conformer_tpu.data import dataset as jdata
from conformer_tpu.ops.ctc import ctc_loss as j_ctc_loss
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.state import TrainState
from conformer_tpu.train.state import make_optimizer as j_make_optimizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu.train.steps import make_train_step as j_make_train_step
from conformer_tpu_torch.audio.augment import spec_augment
from conformer_tpu_torch.config import AugmentConfig, Config, DataConfig, OptimConfig
from conformer_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from conformer_tpu_torch.data import dataset as tdata
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.ops.ctc import ctc_loss
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.train.state import lr_at_step, make_optimizer
from conformer_tpu_torch.train.steps import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 370


# ---------------------------------------------------------------------------
# CTC loss
# ---------------------------------------------------------------------------

def _ctc_case():
    rng = np.random.default_rng(0)
    b, t, v, n = 5, 12, 7, 6
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logit_lengths = np.array([12, 10, 3, 12, 9], np.int32)
    label_lengths = np.array([5, 4, 6, 0, 3], np.int32)     # row 2: 6 > 3 frames
    labels = rng.integers(1, v, (b, n)).astype(np.int32)
    labels[np.arange(n)[None] >= label_lengths[:, None]] = 0
    return logits, logit_lengths, labels, label_lengths


def test_ctc_loss_matches_jax_with_row_mask():
    logits, ll, labels, lab = _ctc_case()
    t = torch.from_numpy
    for mask in (np.array([1, 1, 0, 0, 1], bool), np.array([1, 1, 0, 1, 1], bool)):
        want = j_ctc_loss(jnp.asarray(logits), jnp.asarray(ll),
                          jnp.asarray(labels), jnp.asarray(lab),
                          row_mask=jnp.asarray(mask))
        got = ctc_loss(t(logits), t(ll), t(labels), t(lab), row_mask=t(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ctc_loss_zeroes_the_infeasible_row():
    """Row 2 has more labels than frames. The port's zero_infinity zeroes it;
    the JAX lattice's finite log-zero leaves it at ~1e5 (ROADMAP.md §4), so
    the means agree once that row's JAX loss is set to 0."""
    logits, ll, labels, lab = _ctc_case()
    t = torch.from_numpy
    j_rows = np.array([float(j_ctc_loss(jnp.asarray(logits), jnp.asarray(ll),
                                        jnp.asarray(labels), jnp.asarray(lab),
                                        row_mask=jnp.asarray(np.arange(5) == i)))
                       for i in range(5)])
    assert j_rows[2] > 1e4
    t_rows = np.array([float(ctc_loss(t(logits), t(ll), t(labels), t(lab),
                                      row_mask=t(np.arange(5) == i)))
                       for i in range(5)])
    assert t_rows[2] == 0.0
    np.testing.assert_allclose(np.delete(t_rows, 2), np.delete(j_rows, 2),
                               rtol=1e-5)
    mean = float(ctc_loss(t(logits), t(ll), t(labels), t(lab)))
    np.testing.assert_allclose(mean, np.where(np.arange(5) == 2, 0.0,
                                              j_rows).mean(), rtol=1e-5)


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

def test_spec_augment_masks_whole_rows_and_columns_within_their_widths():
    cfg = AugmentConfig(n_time_masks=2, time_mask_param=10, n_freq_masks=2,
                        freq_mask_param=5)
    mel = torch.randn(6, 50, 80, generator=torch.Generator().manual_seed(0)) + 3
    out = spec_augment(torch.Generator().manual_seed(1), mel, cfg)
    again = spec_augment(torch.Generator().manual_seed(1), mel, cfg)
    assert torch.equal(out, again)                  # the generator decides
    masked = out == 0
    for i in range(6):
        t_cols = masked[i].all(dim=1)               # whole time frames
        f_rows = masked[i].all(dim=0)               # whole mel channels
        # every masked cell lies in a masked frame or channel
        assert torch.equal(masked[i], t_cols[:, None] | f_rows[None, :])
        assert int(t_cols.sum()) <= 2 * 10 and int(f_rows.sum()) <= 2 * 5
        assert torch.equal(out[i][~masked[i]], mel[i][~masked[i]])
    assert masked.any()
    # prob caps each width at prob * axis length: 0.04 * 50 -> 2 frames
    capped = spec_augment(torch.Generator().manual_seed(1), mel,
                          AugmentConfig(n_freq_masks=0, time_mask_param=10,
                                        prob=0.04))
    assert int((capped == 0).all(dim=2).sum(dim=1).max()) <= 2 * 2
    mean_fill = spec_augment(torch.Generator().manual_seed(1), mel,
                             AugmentConfig(zero_masking=False))
    changed = mean_fill != mel
    assert torch.allclose(mean_fill[0][changed[0]],
                          mel[0].mean().expand(int(changed[0].sum())))
    assert spec_augment(None, mel, AugmentConfig(enabled=False)) is mel


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-2, weight_decay=0.01, grad_clip_norm=1.0,
           warmup_steps=2, lr_decay_every_steps=2, lr_decay_gamma=0.5)


def test_learning_rate_schedule_is_optaxs():
    cfg = OptimConfig(**OPT)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 1e-2, 2),
         optax.exponential_decay(1e-2, 2, 0.5, staircase=True)], [2])
    for step in range(10):
        np.testing.assert_allclose(lr_at_step(cfg, step), float(sched(step)),
                                   rtol=1e-6)
    # per-epoch decay when no interval is set
    cfg = OptimConfig(learning_rate=1.0, lr_decay_gamma=0.5)
    assert [lr_at_step(cfg, s, steps_per_epoch=3) for s in (0, 2, 3, 7)] == \
        [1.0, 1.0, 0.5, 0.25]


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_updates_match_optax(weight_decay):
    opt_kw = dict(OPT, weight_decay=weight_decay)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "unused": (2,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = j_make_optimizer(JOptimConfig(**opt_kw))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = make_optimizer(OptimConfig(**opt_kw), t_params.values())
    for step in range(5):
        scale = 0.3 if step % 2 else 3.0            # clipped on even steps
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        grads["unused"][:] = 0.0                    # no gradient in torch
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for k in ("a", "b"):
            t_params[k].grad = torch.from_numpy(grads[k].copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(t_params[k].detach().numpy(),
                                       np.asarray(j_params[k]), atol=1e-6,
                                       err_msg=f"{k} at step {step}")


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

LR = 1e-3


def _configs(accum: int):
    over = {"optim.compute_dtype": "float32", "augment.enabled": False,
            "optim.learning_rate": LR, "optim.accum_steps": accum,
            "optim.grad_clip_norm": 5.0, "optim.eps": 1e-3}
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


@functools.lru_cache(maxsize=None)
def _variables():
    """Flax-initialised tiny weights (scan-stacked blocks), jitted once."""
    jcfg, _ = _configs(1)
    jcfg = jcfg.override(**{"model.use_scan_layers": True})
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3)))


@functools.lru_cache(maxsize=None)
def _train_setup(accum: int):
    """(JAX config, port config, flax variables, JAX step outputs) for one
    step; cached, the flax step compiled once per accumulation count
    (scanned blocks: the quickest compile)."""
    jcfg, tcfg = _configs(accum)
    jcfg = jcfg.override(**{"model.use_scan_layers": True})
    variables = _variables()
    tx = j_make_optimizer(jcfg.optim)
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    args = (state, *(jnp.asarray(x) for x in _batch()),
            jax.random.PRNGKey(0))
    # LLVM's optimisation passes off: most of the compile on the CPU, and
    # they change no value compared here
    new_state, metrics = j_make_train_step(jcfg, tx, donate=False).lower(
        *args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)
    out = jax.tree_util.tree_map(np.asarray, (new_state.params,
                                              new_state.batch_stats, metrics))
    return jcfg, tcfg, variables, out


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX side of the train-step comparison, compiled once per module:
    accumulation count -> _train_setup."""
    return {accum: _train_setup(accum) for accum in (1, 2)}


def _batch():
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((4, 16000)) * 0.1).astype(np.float32)
    audio_lengths = np.array([16000, 12000, 16000, 9000], np.int32)
    audio[np.arange(16000)[None] >= audio_lengths[:, None]] = 0.0
    token_lengths = np.array([8, 5, 0, 6], np.int32)       # row 2: a dummy row
    tokens = rng.integers(1, VOCAB, (4, 10)).astype(np.int32)
    tokens[np.arange(10)[None] >= token_lengths[:, None]] = 0
    return audio, audio_lengths, tokens, token_lengths


def _port_model(tcfg, variables, remat: bool = False):
    cfg = tcfg.override(**{"model.use_remat": remat})
    model = Conformer(cfg.model, "float32")
    model.load_state_dict(flax_to_state_dict(variables, cfg.model))
    return cfg, model


@pytest.mark.parametrize("accum", [1, 2])
def test_one_train_step_matches_jax(accum, jax_reference):
    """Adam's first update is lr * g / (|g| + eps): with eps at 1e-8 it is
    lr * sign(g), which a gradient element near zero flips between the two
    frameworks. With eps 1e-3 it moves by at most lr * dg / eps for a
    gradient difference dg; the gradients agree to a few 1e-6 (fp32 sums
    in another order), so the params agree to 5e-3 of the learning rate."""
    jcfg, tcfg, variables, (j_params, j_stats, j_metrics) = jax_reference[accum]
    cfg, model = _port_model(tcfg, variables)
    opt = make_optimizer(cfg.optim, model.parameters())
    metrics = make_train_step(cfg, model, opt)(
        *(torch.from_numpy(x) for x in _batch()), 0)
    np.testing.assert_allclose(float(metrics["loss"]), j_metrics["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               j_metrics["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["audio_seconds"]),
                               j_metrics["audio_seconds"], rtol=1e-6)
    got = state_dict_to_flax(model.state_dict(), cfg.model, scan=True)
    for path, want in jax.tree_util.tree_leaves_with_path(j_stats):
        have = got["batch_stats"]
        for key in path:
            have = have[key.key]
        np.testing.assert_allclose(have, want, atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    worst = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(j_params):
        have = got["params"]
        for key in path:
            have = have[key.key]
        worst = max(worst, float(np.abs(have - want).max()))
    assert worst <= 5e-3 * LR, worst


def test_remat_changes_nothing_but_memory():
    """Checkpointed blocks (recomputed in the backward, dropout on) give the
    same loss, gradients and BatchNorm statistics as plain ones; the
    recomputation does not move the statistics a second time."""
    _, tcfg = _configs(1)
    variables = _variables()
    tcfg = tcfg.override(**{"model.dropout_rate": 0.1,
                            "optim.learning_rate": 0.0})
    runs = []
    for remat in (False, True):
        cfg, model = _port_model(tcfg, variables, remat)
        opt = make_optimizer(cfg.optim, model.parameters())
        metrics = make_train_step(cfg, model, opt)(
            *(torch.from_numpy(x) for x in _batch()), 5)
        runs.append((float(metrics["loss"]),
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6, msg=n)
    for n in s0:
        torch.testing.assert_close(s1[n], s0[n], rtol=0, atol=0, msg=n)


def test_training_after_serving_in_one_process():
    """Tables built while serving (inference mode) are reused by training."""
    from conformer_tpu_torch.train.steps import make_forward

    _, tcfg = _configs(1)
    variables = _variables()
    cfg, model = _port_model(tcfg, variables)
    audio, audio_lengths, tokens, token_lengths = (torch.from_numpy(x)
                                                   for x in _batch())
    make_forward(cfg, model)(audio, audio_lengths)
    opt = make_optimizer(cfg.optim, model.parameters())
    metrics = make_train_step(cfg, model, opt)(audio, audio_lengths, tokens,
                                               token_lengths, 0)
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

TEXTS = ["xin chào", "việt nam", "một hai ba", "hôm nay trời đẹp", "bốn",
         "chúng tôi đi học"]


def _manifest(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "m.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, sec in enumerate([0.4, 1.3, 0.7, 1.9, 2.6, 0.9]):
            wav = tmp_path / f"u{i}.wav"
            sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), TEXTS[i]])
    return str(path)


@pytest.mark.parametrize("training", [True, False])
def test_bucketed_loader_batches_match_the_jax_loader(tmp_path, training):
    manifest = _manifest(tmp_path)
    kw = dict(batch_size=2, bucket_boundaries_s=(1.0, 2.0), max_audio_s=2.0,
              num_workers=0, seed=4)
    j_loader = jdata.BucketedLoader(jdata.ManifestDataset(manifest),
                                    j_load_tokenizer("vi"), JDataConfig(**kw),
                                    training=training)
    t_loader = tdata.BucketedLoader(tdata.ManifestDataset(manifest),
                                    load_tokenizer("vi"), DataConfig(**kw),
                                    training=training)
    for epoch in (0, 1):
        want = list(j_loader.epoch(epoch))
        got = list(t_loader.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for field in ("audio", "audio_lengths", "tokens", "token_lengths"):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field))
            assert g.texts == w.texts
    # the same rows as a parquet manifest give the same batches
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = tdata.load_manifest(manifest)
    pq.write_table(pa.Table.from_pylist(rows), str(tmp_path / "m.parquet"))
    p_loader = tdata.BucketedLoader(
        tdata.ManifestDataset(str(tmp_path / "m.parquet")),
        load_tokenizer("vi"), DataConfig(**kw), training=training)
    got, want = list(p_loader.epoch(0)), list(t_loader.epoch(0))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("audio", "audio_lengths", "tokens", "token_lengths"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY = ["--set", "model.n_blocks=2", "--set", "model.d_model=64",
        "--set", "model.n_heads=2", "--set", "model.kernel_size=7",
        "--set", "model.lstm_hidden_dim=80", "--set", "data.batch_size=2",
        "--set", "data.num_workers=0", "--set", "train.log_every_steps=1",
        "--set", "train.checkpoint_every_steps=1",
        "--set", "train.num_epochs=10"]


def test_cli_train_on_cpu_checkpoints_and_resumes(tmp_path):
    from conformer_tpu_torch.cli.train import main

    manifest = _manifest(tmp_path)
    ck = tmp_path / "ck"
    argv = ["--train-manifest", manifest, "--checkpoint-dir", str(ck),
            "--device", "cpu", *TINY]
    first = main(argv + ["--set", "train.num_steps=2"])
    assert (first.start_step, first.step) == (0, 2)
    assert (ck / "config.json").exists()
    assert sorted(p.name for p in ck.glob("ckpt_*.pt")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    saved = {n: p.detach().clone() for n, p in first.model.named_parameters()}
    second = main(argv + ["--set", "train.num_steps=3"])
    assert (second.start_step, second.step) == (2, 3)
    assert second.optimizer.count == 3
    assert (ck / "ckpt_00000003.pt").exists()
    # the resumed run started from the saved weights, then took a step
    moved = [not torch.equal(p.detach(), saved[n])
             for n, p in second.model.named_parameters()]
    assert any(moved)
    lines = (ck / "metrics.jsonl").read_text().splitlines()
    assert [eval(ln.replace("NaN", "None"))["step"] for ln in lines
            if "train/ctc_loss" in ln] == [1, 2, 3]


def test_cli_train_refuses_a_missing_gpu_and_unported_options(monkeypatch,
                                                              tmp_path):
    from conformer_tpu_torch.cli.train import main

    manifest = _manifest(tmp_path)
    base = ["--train-manifest", manifest, "--checkpoint-dir",
            str(tmp_path / "ck"), *TINY]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(base + ["--device", "cuda"])
    with pytest.raises(NotImplementedError):
        main(base + ["--device", "cpu", "--wandb"])
    # a mesh is ported (tests/test_torch_parallel.py); one process is a
    # world of one rank, which a 1 x 2 mesh does not fit
    with pytest.raises(ValueError, match="ranks"):
        main(base + ["--device", "cpu", "--tp", "2"])
    # the encoder transfer is ported: a directory with no checkpoint raises
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(base + ["--device", "cpu", "--init-encoder-from",
                     str(tmp_path / "pre")])


# ---------------------------------------------------------------------------
# Asynchronous checkpoints
# ---------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    """Parameters, BatchNorm statistics and Adam moments, all of which a
    train step changes in place."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(6, 4)
        self.norm = torch.nn.BatchNorm1d(4)

    def forward(self, x):
        return self.norm(self.lin(x))


def _tiny_step(model, optimizer, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (5, 6)).astype(np.float32))
    optimizer.zero_grad()
    model.train()
    model(x).square().mean().backward()
    optimizer.step()


def _tiny_trained(seed=0):
    torch.manual_seed(seed)
    model = _Tiny()
    optimizer = make_optimizer(OptimConfig(), model.parameters())
    _tiny_step(model, optimizer, seed)
    return model, optimizer


def _state(model, optimizer):
    """Every tensor of the model's and the optimizer's state, copied."""
    opt = optimizer.state_dict()
    out = {f"model.{k}": v.clone() for k, v in model.state_dict().items()}
    for i, entry in opt["opt"]["state"].items():
        out.update({f"opt.{i}.{k}": torch.as_tensor(v).clone()
                    for k, v in entry.items()})
    out["count"] = torch.tensor(opt["count"])
    return out


def _gated_save(monkeypatch):
    """Make torch.save wait for the returned event, so that a write is
    still in flight while the test goes on."""
    import threading

    gate = threading.Event()
    real = torch.save

    def save(*args, **kwargs):
        gate.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "save", save)
    return gate


def test_checkpoint_is_a_snapshot_of_the_state_at_the_save(tmp_path,
                                                          monkeypatch):
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    model, optimizer = _tiny_trained()
    gate = _gated_save(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    want = _state(model, optimizer)
    mgr.save(model, optimizer, step=1)
    assert not list((tmp_path / "ck").glob("ckpt_*.pt"))   # not yet written
    _tiny_step(model, optimizer, 1)     # every tensor changes in place
    moved = _state(model, optimizer)
    assert all(not torch.equal(moved[k], want[k]) for k in want
               if not k.endswith("num_batches_tracked"))
    gate.set()
    mgr.wait()
    fresh, fresh_opt = _tiny_trained(seed=5)
    assert mgr.restore(fresh, fresh_opt) == (1, 0)
    got = _state(fresh, fresh_opt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_checkpoint_keeps_the_newest_n_and_reads_wait_for_the_write(
        tmp_path, monkeypatch):
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    model, optimizer = _tiny_trained()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(model, optimizer, step=step, epoch=step // 2)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert [e["step"] for e in mgr.log] == [1, 2, 3, 4]
    assert all(e["bytes"] > 0 and e["write_s"] >= 0 for e in mgr.log)
    # a read right after a save waits for that write
    gate = _gated_save(monkeypatch)
    mgr.save(model, optimizer, step=5, epoch=3)
    import threading

    threading.Timer(0.2, gate.set).start()
    assert mgr.latest_step() == 5
    mgr.save(model, optimizer, step=6, epoch=3)
    assert mgr.restore(_tiny_trained()[0]) == (6, 3)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["ckpt_00000005.pt", "ckpt_00000006.pt"]


def test_a_failed_checkpoint_write_raises_and_leaves_no_file(tmp_path):
    import shutil

    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    model, optimizer = _tiny_trained()
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck))
    shutil.rmtree(ck)          # the write has nowhere to go
    mgr.save(model, optimizer, step=1)
    with pytest.raises(RuntimeError, match="writing a checkpoint"):
        mgr.wait()
    mgr.wait()                 # raised once
    mgr.save(model, optimizer, step=2)
    with pytest.raises(RuntimeError, match="writing a checkpoint"):
        mgr.save(model, optimizer, step=3)      # the next save raises it
    ck.mkdir()
    mgr.save(model, optimizer, step=4)
    mgr.close()
    assert sorted(p.name for p in ck.iterdir()) == ["ckpt_00000004.pt"]


def test_trainer_waits_for_its_last_write_also_when_it_raises(tmp_path,
                                                             monkeypatch):
    """cli.train returns with every write on disk (torch.save held back so
    the writes are in flight when the loop ends), resumes from them, and a
    loop that raises still leaves only whole files."""
    import threading

    from conformer_tpu_torch.cli.train import main
    from conformer_tpu_torch.train.trainer import Trainer

    manifest = _manifest(tmp_path)
    ck = tmp_path / "ck"
    argv = ["--train-manifest", manifest, "--checkpoint-dir", str(ck),
            "--device", "cpu", *TINY]
    gate = _gated_save(monkeypatch)
    threading.Timer(0.3, gate.set).start()
    first = main(argv + ["--set", "train.num_steps=2"])
    assert [e["step"] for e in first.ckpt.log] == [1, 2, 2]
    assert all("write_s" in e for e in first.ckpt.log)
    assert sorted(p.name for p in ck.glob("ckpt_*")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt"]

    def save_then_raise(self):
        self.step += 1
        self.save(0)
        raise ValueError("stop")

    gate.clear()
    threading.Timer(0.3, gate.set).start()
    monkeypatch.setattr(Trainer, "_fit", save_then_raise)
    with pytest.raises(ValueError, match="stop"):
        main(argv + ["--set", "train.num_steps=3"])
    assert sorted(p.name for p in ck.glob("ckpt_*")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt", "ckpt_00000003.pt"]
