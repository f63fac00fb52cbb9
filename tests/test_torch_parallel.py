"""The port's multi-device training against the JAX package on the CPU.

One gloo world of 4 ranks (tests/torch_parallel_world.py, spawned once for
the module) runs every mesh case through the port's train step while this
process computes the JAX references; the tests only compare. The config is
tests/test_parallel.py's tiny one (vocab 40, 2 blocks, d_model 64, 2 heads,
kernel 7, LSTM 64, fp32, dropout 0, no SpecAugment), without remat, at a
learning rate of 1e-3 with Adam's eps at 1e-3: with eps 1e-8 Adam's first
update is lr * sign(g), which flips for a gradient element near zero
between two summation orders, and at the default rate of 2e-5 the
parameters would move by less than the tolerance; the batch is
test_parallel.py's 8 rows of 160 * 63 samples with seed 7, with at most 6
tokens a row instead of 16, so that an alignment fits every row (its 7 to
15 frames hold no 16 tokens: there the JAX loss keeps ~1e5 and the port's is
0, ROADMAP.md §3). The weights are the port's seeded ones, carried to the
JAX package by convert.py.

Cases, losses to rtol 2e-4 and every parameter through convert.py to atol
1e-5 unless stated: dp 4 against JAX meshless; dp 2 x tp 2 (TP); the same
with ``model.seq_shard`` (SP), and SP at dp 1 x tp 4 (2 heads over 4 ranks:
the attention runs whole on each, L 15 padded to 16); dp 4 with
``parallel.zero`` (each rank holds a quarter of the moments); BatchNorm
statistics after one step at dp 4 (atol 1e-5); ``accum_steps 2`` with
``conv_norm=group`` at dp 2 x tp 2 against the JAX step's two
micro-batches of the same rows (each data rank's stripe in halves; rtol
5e-4, atol 1e-4, as test_parallel.py's accumulation test); ``conv_impl=pallas`` at
dp 2 x tp 2 (K4's plain versions on channel shards); the transducer at dp 2
x tp 2; a stripe whose transcripts are all empty; and hash dropout 0.1 with
``attention_impl=pallas`` at dp 2 x tp 2 against the JAX package under its
own dp 2 x tp 2 mesh (the K1 interpret kernels inside its shard_map), both
given the same seed words for every dropout site: the attention seed's
mixing with the mesh indices and the global coordinates of every mask.

The world also runs, at dp 2 x tp 2, the sharded searches against the JAX
package's meshless ones on the same numpy inputs (tests/test_device_lm.py's
and tests/test_transducer.py's tiny cases: CTC b 4, t 9, v 12, W 6, K 4
with a token 3-gram, and with a word 2-gram and a hotword at v 5; the
RNN-T toy joint, b 4, t 5, v 4, W 8, token 3-gram; the table passed whole
or as each rank's part): every rank's stripe equals the JAX rows, prefixes
and lengths, scores to 1e-5; the transducer eval step with
``decode="beam"`` (token LM) against the JAX one; and two wav2vec2 and
two BYOL steps (fp32, dropout 0, SpecAugment off, ZeRO-1 and SP) against
the JAX steps given the same weights, on the draws the JAX steps made
(tests/test_parallel.py's limits: losses to rtol 2e-4, every parameter,
the BYOL target's too, to atol 1e-5).

Also: ``cli.train --dp 2 --tp 2 --device cpu`` through
``torch.distributed.run`` (ZeRO-1 and SP), resumed at ``--dp 1``, resumed
again on the mesh, and scored by ``cli.test --lm --decode beam_device``
in one process and on the 2 x 2 mesh (the same metrics and results file),
its checkpoints in the single-device format; ``cli.pretrain --dp 2 --tp
2``, resumed at ``--dp 1``, then ``cli.train --init-encoder-from`` it; the
refusals (a world of another size than dp * tp, ``--device cuda`` or a
mesh without a GPU); the
partitioning rules and ZeRO-1's dimension; hash_keep's offsets against
the JAX global mask; and K1/K2's plain versions with a rank's heads (packed
D/tp, the whole position width) against the JAX kernels in interpret mode,
as its shard_map body calls them, with the kernel selector and geometry at
those shapes.
"""

import csv
import functools
import json
import os
import pickle
import shlex
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.data.dataset import synthetic_batch
from conformer_tpu.models import dropout as jdropout
from conformer_tpu.ops.pallas import sincos_attention as jsa
from conformer_tpu.parallel.mesh import (make_mesh as j_make_mesh,
                                         make_opt_state_shardings,
                                         make_param_shardings,
                                         shard_batch_tree)
from conformer_tpu.lm.device_table import (DeviceHotwords as JDeviceHotwords,
                                           DeviceNgramTable as JDeviceNgramTable,
                                           DeviceWordVocab as JDeviceWordVocab)
from conformer_tpu.lm.ngram import build_arpa
from conformer_tpu.ops.beam_search_device import \
    ctc_beam_search_device as j_ctc_beam_search_device
from conformer_tpu.ops.rnnt import rnnt_beam_search as j_rnnt_beam_search
from conformer_tpu.train import pretrain as jpretrain
from conformer_tpu.train.state import TrainState
from conformer_tpu.train.state import make_optimizer as j_make_optimizer
from conformer_tpu.train.steps import make_train_step as j_make_train_step
from conformer_tpu.train.steps import \
    make_transducer_eval_step as j_make_transducer_eval_step
from conformer_tpu.utils.masking import subsampled_length as j_subsampled_length
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import state_dict_to_flax
from conformer_tpu_torch.models import dropout as tdropout
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.ops.cuda import sincos_attention as tsa
from conformer_tpu_torch.parallel import mesh as tmesh
from conformer_tpu_torch.train.pretrain import build_pretrain_model

ROOT = Path(__file__).resolve().parents[1]
WORLD = Path(__file__).resolve().parent / "torch_parallel_world.py"
RANKS = 4

BASE = {"model.vocab_size": 40, "model.n_blocks": 2, "model.d_model": 64,
        "model.n_heads": 2, "model.kernel_size": 7,
        "model.lstm_hidden_dim": 64, "model.dropout_rate": 0.0,
        "optim.compute_dtype": "float32", "augment.enabled": False,
        "model.use_remat": False, "optim.learning_rate": 1e-3,
        "optim.eps": 1e-3}
GROUP = {**BASE, "model.conv_norm": "group"}
TRANSDUCER = {**BASE, "model.arch": "transducer", "model.pred_embed_dim": 32,
              "model.pred_hidden_dim": 32, "model.joint_dim": 32}
DROPOUT = {**BASE, "model.dropout_rate": 0.1, "model.use_scan_layers": False}
SITES = 7                 # dropout sites of a block (models/encoder.py)
JAX_SITES = {("ffn1", "Dropout_0"): 0, ("ffn1", "Dropout_1"): 1,
             ("mhsa", "Dropout_0"): 3, ("conv", "Dropout_0"): 4,
             ("ffn2", "Dropout_0"): 5, ("ffn2", "Dropout_1"): 6}
ATTENTION_SITE = 2
STEPS = 2

# (case, config overrides, dp, tp, steps, batch, weights)
CASES = (("dp4", BASE, 4, 1, STEPS, "batch", "ctc"),
         ("tp", BASE, 2, 2, STEPS, "batch", "ctc"),
         ("sp", {**BASE, "model.seq_shard": True}, 2, 2, STEPS, "batch", "ctc"),
         ("sp_tp4", {**BASE, "model.seq_shard": True}, 1, 4, STEPS, "batch",
          "ctc"),
         ("zero", {**BASE, "parallel.zero": True}, 4, 1, STEPS, "batch", "ctc"),
         ("accum_group", {**GROUP, "optim.accum_steps": 2}, 2, 2, 1, "batch",
          "group"),
         ("pallas_conv", {**BASE, "model.conv_impl": "pallas"}, 2, 2, STEPS,
          "batch", "ctc"),
         ("transducer", TRANSDUCER, 2, 2, STEPS, "batch", "transducer"),
         ("empty_stripe", BASE, 4, 1, STEPS, "empty", "ctc"),
         ("dropout", DROPOUT, 2, 2, STEPS, "batch", "ctc"))


# the searches, the eval beam and the pretraining steps (kind, name, ...)
EVAL_BEAM = {**TRANSDUCER, "decode.beam_width": 4, "decode.rnnt_top_k": 3,
             "decode.rnnt_max_symbols": 2, "data.max_tokens": 8}
PRETRAIN = {**BASE, "pretrain.num_vars": 16, "pretrain.proj_dim": 32,
            "pretrain.num_negatives": 8, "pretrain.predictor_hidden": 32,
            "model.use_scan_layers": True}
PRETRAIN_MESH = {"parallel.zero": True, "model.seq_shard": True}
WORD_TOKENS = ["", "A", "B", "C", " "]
SEARCH_KW = {
    "ctc_token": dict(beam_width=6, top_k=4, lm_alpha=0.7, lm_beta=0.0),
    "ctc_word": dict(beam_width=6, top_k=4, hot_weight=2.0, lm_alpha=1.1,
                     lm_beta=0.4, delim_id=4),
    "rnnt_token": dict(beam_width=8, top_k=3, max_symbols=4, max_len=4,
                       lm_alpha=0.8)}
LM_ALPHA = 0.8


def _arpas(d: Path):
    """A token 3-gram over A..D and tests/test_transducer.py's word 2-gram
    over AB, BA, A, CAB (built by the JAX package's build_arpa)."""
    rng = np.random.default_rng(2)
    (d / "tok.txt").write_text("\n".join(
        " ".join(rng.choice(["A", "B", "C", "D"], 5)) for _ in range(150)),
        encoding="utf8")
    build_arpa(str(d / "tok.txt"), str(d / "tok.arpa"), order=3)
    rng = np.random.default_rng(4)
    (d / "word.txt").write_text("\n".join(
        " ".join(rng.choice(["AB", "BA", "A", "CAB"], rng.integers(1, 4)))
        for _ in range(300)), encoding="utf8")
    build_arpa(str(d / "word.txt"), str(d / "word.arpa"), order=2)


def _search_inputs(d: Path):
    """The searches' numpy inputs, each written to ``<name>.npz``."""
    table = JDeviceNgramTable.from_arpa(str(d / "tok.arpa"))
    ids = sorted(table.vocab.values())
    rng = np.random.default_rng(5)
    lp = rng.standard_normal((4, 9, 12)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    tok2lm = np.array([-1] + [rng.choice(ids) for _ in range(11)], np.int64)
    inputs = {"ctc_token": dict(log_probs=lp, lengths=np.array([9, 7, 9, 5]),
                                tok2lm=tok2lm)}
    rng = np.random.default_rng(6)
    lp = rng.standard_normal((4, 9, 5)).astype(np.float32) * 2.0
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    inputs["ctc_word"] = dict(log_probs=lp, lengths=np.array([9, 8, 6, 9]))
    rng = np.random.default_rng(3)
    w1 = rng.standard_normal((8 + 5, 4)).astype(np.float32)
    emb = rng.standard_normal((4, 5)).astype(np.float32)
    enc = rng.standard_normal((4, 5, 8)).astype(np.float32)
    rnnt_tok2lm = np.full((4,), -1, np.int64)
    for i, word in enumerate(["A", "B", "C"]):
        rnnt_tok2lm[i + 1] = table.vocab[word]
    inputs["rnnt_token"] = dict(w1=w1, emb=emb, enc=enc,
                                lengths=np.array([5, 3, 5, 4]),
                                tok2lm=rnnt_tok2lm)
    rng = np.random.default_rng(8)
    inputs["eval_beam"] = dict(tok2lm=np.array(
        [-1] + [rng.choice(ids) for _ in range(39)], np.int64))
    for name, arrays in inputs.items():
        np.savez(d / f"{name}.npz", **arrays)
    return inputs


def _extra_cases():
    base = {"dp": 2, "tp": 2}
    return [
        {**base, "kind": "ctc_search", "name": "ctc_token",
         "inputs": "ctc_token.npz", "arpa": "tok.arpa", "part": True,
         "kw": SEARCH_KW["ctc_token"]},
        {**base, "kind": "ctc_search", "name": "ctc_word",
         "inputs": "ctc_word.npz", "arpa": "word.arpa",
         "words": WORD_TOKENS, "hotwords": ["AB"], "kw": SEARCH_KW["ctc_word"]},
        {**base, "kind": "rnnt_search", "name": "rnnt_token",
         "inputs": "rnnt_token.npz", "arpa": "tok.arpa",
         "kw": SEARCH_KW["rnnt_token"]},
        {**base, "kind": "eval_beam", "name": "eval_beam",
         "inputs": "eval_beam.npz", "arpa": "tok.arpa", "part": True,
         "kw": {"lm_alpha": LM_ALPHA}, "overrides": EVAL_BEAM,
         "weights": "transducer_eval.pt", "batch": "batch.npz"},
    ] + [{**base, "kind": "pretrain", "name": method, "steps": STEPS,
          "overrides": {**PRETRAIN, **PRETRAIN_MESH,
                        "pretrain.method": method},
          "weights": f"{method}.pt", "batch": "batch.npz"}
         for method in ("wav2vec2", "byol")] + [
        {**base, "kind": "pretrain", "name": "byol_dropout", "steps": 1,
         "meshless": True, "overrides": {
             **PRETRAIN, **PRETRAIN_MESH, "pretrain.method": "byol",
             "model.dropout_rate": 0.1, "model.use_remat": True,
             "model.attention_impl": "xla"},
         "weights": "byol.pt", "batch": "batch.npz"}]


def _batch():
    b = synthetic_batch(8, 160 * 63, 40, max_tokens=6, seed=7)
    return {"audio": b.audio, "audio_lengths": b.audio_lengths,
            "tokens": b.tokens, "token_lengths": b.token_lengths}


def _empty_stripe(batch):
    """Rank 1's stripe at dp 4 (rows 2 and 3) without transcripts."""
    out = {k: v.copy() for k, v in batch.items()}
    out["tokens"][2:4] = 0
    out["token_lengths"][2:4] = 0
    return out


def _weights(over):
    cfg = Config().override(**over)
    return build_model(cfg.model, "float32", seed=0).state_dict()


def _dropout_words():
    """Seed words of every dropout site: the input projection's, then each
    block's SITES."""
    rng = np.random.default_rng(11)
    words = [[int(w) for w in row]
             for row in rng.integers(0, 2 ** 32, (1 + 2 * SITES, 2))]
    return words[0], [words[1 + i * SITES:1 + (i + 1) * SITES]
                      for i in range(2)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The JAX references.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(over_items):
    """(config, optimizer, train step) of a config, the step jitted once."""
    jcfg = JConfig().override(**dict(over_items))
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10)
    return jcfg, tx, j_make_train_step(jcfg, tx, donate=False)


def _jax_run(over, weights, batch, steps, mesh=None):
    """-> losses, and (params, batch_stats) as numpy after each step."""
    jcfg, tx, step = _jax_step(tuple(sorted(over.items())))
    variables = state_dict_to_flax(
        weights, Config.from_dict(jcfg.to_dict()).model,
        scan=jcfg.model.use_scan_layers)
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              tx)
    args = tuple(batch[k] for k in ("audio", "audio_lengths", "tokens",
                                    "token_lengths"))
    if mesh is not None:
        state = jax.device_put(state, TrainState(
            step=NamedSharding(mesh, P()),
            params=make_param_shardings(mesh, state.params, tp_enabled=True),
            batch_stats=jax.tree_util.tree_map(
                lambda _: NamedSharding(mesh, P()), state.batch_stats),
            opt_state=make_opt_state_shardings(mesh, state.opt_state,
                                               state.params, tp_enabled=True)))
        args = jax.device_put(args, shard_batch_tree(mesh, args))
    losses, states = [], []
    for _ in range(steps):
        if mesh is not None:
            with jax.set_mesh(mesh):
                state, metrics = step(state, *args, jax.random.PRNGKey(5))
        else:
            state, metrics = step(state, *args, jax.random.PRNGKey(5))
        losses.append(float(metrics["loss"]))
        states.append(jax.tree_util.tree_map(
            np.asarray, (state.params, state.batch_stats)))
    return losses, states


def _patched_dropout(words):
    """JAX dropout with the seed words of the table instead of the module's
    RNG: its Dropout sites by module path, the attention kernel's seed (a
    randint, once a block in trace order), and the K1/K2 interpret kernels
    inside the shard_map (on the CPU the JAX package otherwise takes its XLA
    fallback, whose dropout is not the hash)."""
    input_words, block_words = words
    table = {("encoder", "Dropout_0"): input_words}
    for i, block in enumerate(block_words):
        for (module, name), site in JAX_SITES.items():
            table[("encoder", f"block_{i}", module, name)] = block[site]
    calls = []
    randint = jax.random.randint

    def seeded_randint(key, shape, minval, maxval, dtype=jnp.int32):
        if shape != ():
            return randint(key, shape, minval, maxval, dtype)
        block = block_words[len(calls) % len(block_words)]
        calls.append(1)
        return jnp.asarray(block[ATTENTION_SITE][0] & 0x7FFFFFFF, dtype)

    def call(self, x, deterministic):
        if deterministic or self.rate == 0.0:
            return x
        seed = jnp.asarray(np.array(table[tuple(self.scope.path)], np.uint32))
        keep = jdropout.hash_keep(x.shape, seed, self.rate)
        scale = jnp.asarray(1.0 / (1.0 - self.rate), x.dtype)
        return jnp.where(keep, x * scale, jnp.zeros((), x.dtype))

    mp = pytest.MonkeyPatch()
    mp.setattr(jdropout.Dropout, "__call__", call)
    mp.setattr(jax.random, "randint", seeded_randint)
    mp.setattr(jsa, "rel_attention_sincos_sharded",
               functools.partial(jsa.rel_attention_sincos_sharded,
                                 interpret=True))
    return mp


def _jax_lm_kwargs(d: Path, name: str, inputs: dict) -> dict:
    arpa = "word.arpa" if name == "ctc_word" else "tok.arpa"
    table = JDeviceNgramTable.from_arpa(str(d / arpa))
    kw = dict(lm_tables=table.device_arrays(), lm_bos_id=int(table.bos_id),
              lm_unk_logp=float(table.unk_logp), lm_order=int(table.order))
    if "tok2lm" in inputs:
        kw["tok2lm"] = jnp.asarray(inputs["tok2lm"].astype(np.int32))
    if name == "ctc_word":
        kw["word_arrays"] = JDeviceWordVocab.build(
            WORD_TOKENS, table.vocab).device_arrays()
        kw["hot_arrays"] = JDeviceHotwords.build(("AB",)).device_arrays()
    return kw


def _jax_searches(d: Path, inputs: dict, weights, batch) -> dict:
    """The JAX meshless searches and eval step on the world's inputs."""
    out = {}
    for name in ("ctc_token", "ctc_word"):
        x = inputs[name]
        out[name] = j_ctc_beam_search_device(
            jnp.asarray(x["log_probs"]), jnp.asarray(x["lengths"], jnp.int32),
            **SEARCH_KW[name], **_jax_lm_kwargs(d, name, x))
    x = inputs["rnnt_token"]
    w1, emb = jnp.asarray(x["w1"]), jnp.asarray(x["emb"])
    joint_fn = lambda e, p: jnp.tanh(jnp.concatenate([e, p], -1)) @ w1 * 2.0

    def pred_step_fn(state, tok):
        new = jnp.tanh(state * 0.7 + emb[tok])
        return new, new

    state0 = jnp.zeros((4, 5), jnp.float32)
    out["rnnt_token"] = j_rnnt_beam_search(
        joint_fn, jnp.asarray(x["enc"]), jnp.asarray(x["lengths"], jnp.int32),
        pred_step_fn, (state0, state0), **SEARCH_KW["rnnt_token"],
        **_jax_lm_kwargs(d, "rnnt_token", x))
    jcfg = JConfig().override(**EVAL_BEAM)
    variables = state_dict_to_flax(weights, Config.from_dict(
        jcfg.to_dict()).model, scan=jcfg.model.use_scan_layers)
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              j_make_optimizer(jcfg.optim, steps_per_epoch=10))
    step = j_make_transducer_eval_step(
        jcfg, decode="beam", lm_kwargs=dict(
            lm_alpha=LM_ALPHA, **_jax_lm_kwargs(d, "eval_beam",
                                                inputs["eval_beam"])))
    out["eval_beam"] = step(state, *(batch[k] for k in (
        "audio", "audio_lengths", "tokens", "token_lengths")))
    return jax.tree_util.tree_map(np.asarray, out)


def _eval_weights(weights: dict) -> dict:
    """The transducer's weights with its joint sharpened and the blank
    lowered, so that the beam emits 2 to 3 tokens a row (at the seeded
    init the best beam of every row is empty)."""
    out = {k: v.clone() for k, v in weights.items()}
    out["joint.out.weight"] *= 6.0
    out["joint.out.bias"][0] = -3.0
    return out


def _pretrain_weights(method: str) -> dict:
    cfg = Config().override(**{**PRETRAIN, "pretrain.method": method})
    return build_pretrain_model(cfg, seed=0).state_dict()


def _jax_pretrain(d: Path, method: str, weights, batch) -> tuple:
    """STEPS of the JAX step from the port's weights -> (losses, the last
    params (and the BYOL target's)); its draws (mask starts, Gumbel noise,
    negatives, each step's, caught or drawn again from its keys) go to
    ``draws_<method>.npz`` for the world."""
    jcfg = JConfig().override(**{**PRETRAIN, "pretrain.method": method})
    tcfg = Config.from_dict(jcfg.to_dict())
    scan = jcfg.model.use_scan_layers
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10)
    audio, lengths = batch["audio"], batch["audio_lengths"]
    rng = jax.random.PRNGKey(0)
    losses, draws = [], {}
    if method == "wav2vec2":
        v = state_dict_to_flax(weights, tcfg.model, scan, "wav2vec2")
        state = TrainState.create(v["params"], v["batch_stats"], tx)
        caught = []
        gumbel = jax.random.gumbel

        def spy(key, shape=(), dtype=jnp.float64, *args, **kwargs):
            out = gumbel(key, shape, dtype, *args, **kwargs)
            jax.debug.callback(lambda x: caught.append(np.asarray(x)), out)
            return out

        step = jpretrain.make_wav2vec2_step(jcfg, tx, donate=False)
        t_sub = j_subsampled_length(1 + audio.shape[1] // jcfg.audio.hop_length)
        k = jcfg.pretrain.num_negatives
        with mock.patch.object(jax.random, "gumbel", spy):
            for i in range(STEPS):
                state, metrics = step(state, audio, lengths, rng,
                                      jpretrain.gumbel_temperature_at(jcfg, i))
                losses.append(float(metrics["loss"]))
                mask_key, _, neg_key, _ = jax.random.split(
                    jax.random.fold_in(rng, i), 4)
                draws[f"starts{i}"] = np.asarray(jax.random.bernoulli(
                    mask_key, jcfg.pretrain.mask_prob, (len(audio), t_sub)))
                raw = jax.vmap(lambda r: jax.random.randint(
                    r, (t_sub, k), 0, t_sub - 1))(
                    jax.random.split(neg_key, len(audio)))
                draws[f"negatives{i}"] = np.asarray(
                    raw + (raw >= jnp.arange(t_sub)[:, None])).astype(np.int64)
        for i, g in enumerate(caught):
            draws[f"gumbels{i}"] = g
        params = (state.params,)
    else:
        online = {k[7:]: w for k, w in weights.items()
                  if k.startswith("online.")}
        target = {k[7:]: w for k, w in weights.items()
                  if k.startswith("target.")}
        ov = state_dict_to_flax(online, tcfg.model, scan, "byol")
        tv = state_dict_to_flax(target, tcfg.model, scan, "byol_target")
        state = jpretrain.BYOLState(
            step=jnp.zeros((), jnp.int32), params=ov["params"],
            target_params=tv["params"], batch_stats=ov["batch_stats"],
            target_batch_stats=tv["batch_stats"],
            opt_state=tx.init(ov["params"]))
        step = jpretrain.make_byol_step(jcfg, tx, donate=False)
        for _ in range(STEPS):
            state, metrics = step(state, audio, lengths, rng)
            losses.append(float(metrics["loss"]))
        params = (state.params, state.target_params)
    tmp = d / f"draws_{method}.tmp.npz"
    np.savez(tmp, **draws)
    os.replace(tmp, d / f"draws_{method}.npz")
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _jax_references(batch, empty, weights, d: Path, inputs: dict):
    # the pretraining steps first: the world waits for their draws
    pretrain = {m: _jax_pretrain(d, m, weights[m], batch)
                for m in ("wav2vec2", "byol")}
    searches = _jax_searches(d, inputs, weights["transducer_eval"], batch)
    base_losses, base = _jax_run(BASE, weights["ctc"], batch, STEPS)
    empty_losses, empty_states = _jax_run(BASE, weights["ctc"], empty, STEPS)
    # the mesh's micro-batches: each data rank's stripe in halves, rows
    # {0, 1, 4, 5} then {2, 3, 6, 7}; the JAX step splits the batch into
    # halves in order
    order = [0, 1, 4, 5, 2, 3, 6, 7]
    group_losses, group = _jax_run(
        {**GROUP, "optim.accum_steps": 2}, weights["group"],
        {k: v[order] for k, v in batch.items()}, 1)
    rnnt_losses, rnnt = _jax_run(TRANSDUCER, weights["transducer"], batch,
                                 STEPS)
    return {"base": (base_losses, base), "empty": (empty_losses, empty_states),
            "group": (group_losses, group), "transducer": (rnnt_losses, rnnt),
            "pretrain": pretrain, "searches": searches}


def jax_dropout_reference(directory: str) -> None:
    """The hash-dropout case's JAX reference under its own 2 x 2 mesh (the
    K1/K2 interpret kernels, the slowest reference), written to
    ``jax_dropout.pkl``: the fixture runs it in a process of its own,
    beside the others."""
    d = Path(directory)
    mp = _patched_dropout(_dropout_words())
    try:
        mesh = j_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
        out = _jax_run(DROPOUT, torch.load(d / "ctc.pt"),
                       dict(np.load(d / "batch.npz")), STEPS, mesh)
    finally:
        mp.undo()
    with open(d / "jax_dropout.pkl.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(d / "jax_dropout.pkl.tmp", d / "jax_dropout.pkl")


# ---------------------------------------------------------------------------
# The CLI run: cli.train on a 2 x 2 mesh, resumed at dp 1 and on the mesh
# again, then cli.test.
# ---------------------------------------------------------------------------

TEXTS = ["xin chào", "việt nam", "một hai ba", "hôm nay trời đẹp", "bốn",
         "chúng tôi đi học"]
TINY = ["--set", "model.n_blocks=2", "--set", "model.d_model=64",
        "--set", "model.n_heads=2", "--set", "model.kernel_size=7",
        "--set", "model.lstm_hidden_dim=80", "--set", "data.batch_size=4",
        "--set", "data.num_workers=0", "--set", "train.log_every_steps=1",
        "--set", "train.checkpoint_every_steps=1",
        "--set", "train.num_epochs=10", "--set", "model.use_remat=false"]
MESH = ["--dp", "2", "--tp", "2", "--set", "parallel.zero=true",
        "--set", "model.seq_shard=true"]


def _manifest(directory: Path) -> str:
    rng = np.random.default_rng(2)
    path = directory / "m.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, sec in enumerate([0.4, 1.3, 0.7, 1.9, 1.6, 0.9]):
            wav = directory / f"u{i}.wav"
            sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), TEXTS[i]])
    return str(path)


PT = ["--set", "model.n_blocks=2", "--set", "model.d_model=64",
      "--set", "model.n_heads=2", "--set", "model.kernel_size=7",
      "--set", "data.batch_size=4", "--set", "data.num_workers=0",
      "--set", "pretrain.proj_dim=32", "--set", "pretrain.num_vars=16",
      "--set", "pretrain.predictor_hidden=64",
      "--set", "train.log_every_steps=1",
      "--set", "train.checkpoint_every_steps=1",
      "--set", "train.num_epochs=10", "--set", "model.use_remat=false"]


def _chain(directory: Path, runs, tag: str) -> str:
    return " && ".join(" ".join(shlex.quote(a) for a in run) + " > "
                       + shlex.quote(str(directory / f"{tag}{i}.log"))
                       + " 2>&1" for i, run in enumerate(runs))


def _cli_chain(directory: Path) -> str:
    """cli.train on the mesh, resumed at dp 1 and on the mesh again, then
    cli.test --lm --decode beam_device in one process and on the mesh."""
    manifest = _manifest(directory)
    (directory / "corpus.txt").write_text("\n".join(t.upper() for t in TEXTS),
                                          encoding="utf8")
    build_arpa(str(directory / "corpus.txt"), str(directory / "lm.arpa"),
               order=3)
    ck = str(directory / "ck")
    train = ["--train-manifest", manifest, "--checkpoint-dir", ck,
             "--device", "cpu", *TINY]
    py = sys.executable
    launch = [py, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(RANKS), "-m"]
    test = ["-m", "conformer_tpu_torch.cli.test", "--manifest", manifest,
            "--checkpoint-dir", ck, "--device", "cpu", "--lm",
            str(directory / "lm.arpa"), "--decode", "beam_device",
            "--set", "decode.beam_width=8", "--set", "decode.hotwords=[]",
            # fp32: bf16 logits differ between layouts (another summation
            # order, other CPU kernels for another batch size) by more than
            # a random model's beam margins
            "--set", "optim.compute_dtype=float32"]
    runs = [launch + ["conformer_tpu_torch.cli.train"] + train + MESH
            + ["--val-manifest", manifest, "--set", "train.num_steps=2"],
            [py, "-m", "conformer_tpu_torch.cli.train", "--dp", "1"] + train
            + ["--set", "train.num_steps=3"],
            launch + ["conformer_tpu_torch.cli.train"] + train + MESH
            + ["--set", "train.num_steps=4"],
            [py] + test + ["--results", str(directory / "results.csv")],
            launch[:-1] + test + ["--dp", "2", "--tp", "2", "--results",
                                  str(directory / "results_mesh.csv")]]
    return _chain(directory, runs, "run")


def _pretrain_chain(directory: Path) -> str:
    """cli.pretrain on the mesh, resumed at dp 1, then cli.train from its
    encoder."""
    manifest = str(directory / "m.csv")
    pre, py = str(directory / "pre"), sys.executable
    common = ["--manifest", manifest, "--method", "wav2vec2",
              "--checkpoint-dir", pre, "--device", "cpu", *PT]
    runs = [[py, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(RANKS), "-m",
             "conformer_tpu_torch.cli.pretrain"] + common + MESH
            + ["--set", "train.num_steps=2"],
            [py, "-m", "conformer_tpu_torch.cli.pretrain", "--dp", "1"]
            + common + ["--set", "train.num_steps=3"],
            [py, "-m", "conformer_tpu_torch.cli.train", "--train-manifest",
             manifest, "--checkpoint-dir", str(directory / "ck_init"),
             "--device", "cpu", "--init-encoder-from", pre,
             "--init-method", "wav2vec2", *PT,
             "--set", "train.num_steps=1"]]
    return _chain(directory, runs, "pre")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the world and the CLI chains, compute the JAX references
    meanwhile, then wait for them all."""
    d = tmp_path_factory.mktemp("mesh")
    batch = _batch()
    empty = _empty_stripe(batch)
    np.savez(d / "batch.npz", **batch)
    np.savez(d / "empty.npz", **empty)
    weights = {"ctc": _weights(BASE), "group": _weights(GROUP),
               "transducer": _weights(TRANSDUCER),
               "transducer_eval": _eval_weights(_weights(TRANSDUCER)),
               "wav2vec2": _pretrain_weights("wav2vec2"),
               "byol": _pretrain_weights("byol")}
    for name, state in weights.items():
        torch.save(state, d / f"{name}.pt")
    _arpas(d)
    inputs = _search_inputs(d)
    words = _dropout_words()
    cases = [{"name": name, "overrides": over, "dp": dp, "tp": tp,
              "steps": steps, "batch": f"{b}.npz", "weights": f"{w}.pt",
              **({"dropout_words": words} if name == "dropout" else {})}
             for name, over, dp, tp, steps, b, w in CASES]
    (d / "cases.json").write_text(json.dumps(cases + _extra_cases()))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = _free_port()
    logs = [open(d / f"rank{r}.log", "w") for r in range(RANKS)]
    world = [subprocess.Popen([sys.executable, str(WORLD), str(d), str(r),
                               str(RANKS), str(port)], env=env, cwd=d,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    cli_dir = d / "cli"
    cli_dir.mkdir()
    cli = subprocess.Popen(["bash", "-c", _cli_chain(cli_dir)], env=env,
                           cwd=cli_dir)
    pre = subprocess.Popen(["bash", "-c", _pretrain_chain(cli_dir)], env=env,
                           cwd=cli_dir)
    drop_log = open(d / "jax_dropout.log", "w")
    drop = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import test_torch_parallel as t; t.jax_dropout_reference(sys.argv[2])",
         str(Path(__file__).resolve().parent), str(d)],
        env=env, cwd=d, stdout=drop_log, stderr=subprocess.STDOUT)
    try:
        jax_refs = _jax_references(batch, empty, weights, d, inputs)
        rcs = [p.wait(timeout=600) for p in world]
        cli_rc = cli.wait(timeout=600)
        pre_rc = pre.wait(timeout=600)
        drop_rc = drop.wait(timeout=600)
    finally:
        for p in world + [cli, pre, drop]:
            if p.poll() is None:
                p.kill()
        for f in logs + [drop_log]:
            f.close()
    assert rcs == [0] * RANKS, (d / "rank0.log").read_text()[-3000:]
    assert drop_rc == 0, (d / "jax_dropout.log").read_text()[-3000:]
    with open(d / "jax_dropout.pkl", "rb") as f:
        jax_refs["dropout"] = pickle.load(f)
    return {"port": torch.load(d / "results.pt", weights_only=False),
            "jax": jax_refs, "cli_rc": cli_rc, "pre_rc": pre_rc,
            "cli_dir": cli_dir, "batch": batch}


def _assert_params(state, over, jax_params, atol):
    """Every parameter of the port's single-device state_dict, through
    convert.py, against the JAX tree."""
    jcfg = JConfig().override(**over)
    tcfg = Config.from_dict(jcfg.to_dict())
    got = state_dict_to_flax(state, tcfg.model,
                             scan=jcfg.model.use_scan_layers)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(leaves) > 20
    for path, want in leaves:
        have = got
        for key in path:
            have = have[key.key]
        np.testing.assert_allclose(have, want, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The mesh cases.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dp4", "tp", "sp", "sp_tp4", "zero",
                                  "pallas_conv"])
def test_mesh_step_matches_jax_meshless(case, runs):
    """DP, TP (column/row-parallel FFN, heads, conv channels, LSTM gates,
    vocabulary), SP, ZeRO-1 and the depthwise-conv kernels' plain versions
    on channel shards: the numbers of one device."""
    losses, states = runs["jax"]["base"]
    got = runs["port"][case]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    over = dict(CASES[[c[0] for c in CASES].index(case)][1])
    _assert_params(got["last"], over, states[-1][0], 1e-5)


def test_zero_holds_a_quarter_of_the_moments_on_each_rank(runs):
    got = runs["port"]["zero"]
    for rank_shapes in got["shapes"]:
        quartered = [full for full, mine in rank_shapes
                     if int(np.prod(mine)) * 4 == int(np.prod(full))]
        whole = [full for full, mine in rank_shapes if mine == full]
        assert len(quartered) + len(whole) == len(rank_shapes)
        assert len(quartered) > 0.9 * len(rank_shapes)
    # the first dimension that divides by dp (ZeRO-1's rule)
    assert got["zero_dims"][0] == 0


def test_batch_norm_statistics_are_global_under_dp(runs):
    _, states = runs["jax"]["base"]
    want = states[0][1]
    jcfg = JConfig().override(**BASE)
    got = state_dict_to_flax(runs["port"]["dp4"]["first"],
                             Config.from_dict(jcfg.to_dict()).model,
                             scan=True)["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == 4     # the blocks' conv norm (stacked), decoder
    for path, w in leaves:
        have = got
        for key in path:
            have = have[key.key]
        np.testing.assert_allclose(have, w, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_accumulation_with_group_norm_matches_jax(runs):
    losses, states = runs["jax"]["group"]
    got = runs["port"]["accum_group"]
    np.testing.assert_allclose(got["losses"], losses, rtol=5e-4)
    _assert_params(got["last"], GROUP, states[-1][0], 1e-4)


def test_transducer_on_the_mesh_matches_jax(runs):
    losses, states = runs["jax"]["transducer"]
    got = runs["port"]["transducer"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    _assert_params(got["last"], TRANSDUCER, states[-1][0], 1e-5)


def test_a_stripe_without_transcripts_matches_jax(runs):
    losses, states = runs["jax"]["empty"]
    got = runs["port"]["empty_stripe"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    _assert_params(got["last"], BASE, states[-1][0], 1e-5)


def test_hash_dropout_matches_jax_under_its_mesh(runs):
    losses, states = runs["jax"]["dropout"]
    got = runs["port"]["dropout"]
    base = runs["jax"]["base"][0]
    assert abs(losses[0] - base[0]) > 1e-3      # dropout did drop
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    _assert_params(got["last"], DROPOUT, states[-1][0], 1e-5)


def test_a_world_of_another_size_than_dp_tp_raises(runs):
    assert runs["port"]["misfit"] == "dp*tp = 3*1 != 4 ranks"


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_cli_train_on_a_mesh_resumes_across_layouts_and_scores(runs):
    d = runs["cli_dir"]
    logs = {i: (d / f"run{i}.log").read_text(errors="replace")
            for i in range(4) if (d / f"run{i}.log").exists()}
    assert runs["cli_rc"] == 0, {i: t[-2000:] for i, t in logs.items()}
    ck = d / "ck"
    records = [json.loads(ln.replace("NaN", "null"))
               for ln in (ck / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in records if "train/ctc_loss" in r]
    assert steps == [1, 2, 3, 4]          # rank 0 alone logs
    # validation at each epoch's end (a step an epoch here; the later runs
    # read the validation manifest from config.json): on the mesh each
    # rank's stripe decoded and the whole set scored
    val = [r for r in records if "val/wer" in r]
    assert [r["step"] for r in val] == [1, 2, 3, 4]
    assert all(np.isfinite(r["val/loss"]) for r in val)
    assert "resumed from step 2" in logs[1]
    assert "resumed from step 3" in logs[2]
    assert "mesh dp 2 x tp 2 zero seq_shard" in logs[0]
    # a mesh's checkpoint is in the single-device format
    cfg = Config.from_json(str(ck / "config.json")).override(
        **{"model.vocab_size": 370})
    assert (cfg.parallel.dp, cfg.parallel.tp) == (2, 2)
    model = build_model(cfg.model, "float32", seed=0)
    payload = torch.load(ck / "ckpt_00000004.pt")
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    moments = payload["optimizer"]["opt"]["state"]
    params = list(model.parameters())
    assert [tuple(moments[i]["exp_avg"].shape) for i in range(len(params))] \
        == [tuple(p.shape) for p in params]
    assert payload["optimizer"]["count"] == 4
    with open(d / "results.csv", encoding="utf8") as f:
        assert len(list(csv.reader(f))) > 1


def test_cli_train_on_a_mesh_refuses_a_missing_gpu(monkeypatch, tmp_path):
    from conformer_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--train-manifest", str(tmp_path / "m.csv"), "--dp", "2",
              "--tp", "2", "--device", "cuda", *TINY])


def _metrics_line(log: str) -> str:
    return next(ln for ln in log.splitlines() if ln.startswith("WER:"))


def test_cli_test_on_a_mesh_equals_one_process(runs):
    """cli.test --lm --decode beam_device at dp 2 x tp 2 (each data rank
    its stripe, the word LM's buckets over the model group, the frame
    steps eager over gloo) prints and writes what one process does."""
    d = runs["cli_dir"]
    logs = {i: (d / f"run{i}.log").read_text(errors="replace")
            for i in range(5) if (d / f"run{i}.log").exists()}
    assert runs["cli_rc"] == 0, {i: t[-2000:] for i, t in logs.items()}
    one, mesh = _metrics_line(logs[3]), _metrics_line(logs[4])
    assert one.split("loss")[0] == mesh.split("loss")[0]
    np.testing.assert_allclose(float(mesh.rsplit(" ", 1)[1]),
                               float(one.rsplit(" ", 1)[1]), rtol=1e-3)
    assert logs[4].count("WER:") == 1            # rank 0 alone prints
    assert "mesh dp 2 x tp 2, frame steps eager" in logs[4]
    assert (d / "results_mesh.csv").read_text(encoding="utf8") == \
        (d / "results.csv").read_text(encoding="utf8")


def test_cli_pretrain_on_a_mesh_resumes_and_transfers(runs):
    d = runs["cli_dir"]
    logs = {i: (d / f"pre{i}.log").read_text(errors="replace")
            for i in range(3) if (d / f"pre{i}.log").exists()}
    assert runs["pre_rc"] == 0, {i: t[-2000:] for i, t in logs.items()}
    pre = d / "pre"
    records = [json.loads(ln.replace("NaN", "null"))
               for ln in (pre / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "pretrain/loss" in r] == [1, 2, 3]
    assert "mesh dp 2 x tp 2 zero seq_shard" in logs[0]
    assert "resumed from step 2" in logs[1]
    assert "encoder initialized from" in logs[2]
    # the mesh's checkpoint is in the single-device format
    cfg = Config.from_json(str(pre / "config.json"))
    assert (cfg.parallel.dp, cfg.parallel.tp) == (1, 1)
    model = build_pretrain_model(cfg, seed=None)
    payload = torch.load(pre / "ckpt_00000002.pt")
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _stripes_match(ranks, want, lengths_too=True):
    """Every rank's outputs against the JAX rows of its stripe (b 4 over
    dp 2), and each model group's ranks alike."""
    assert len(ranks) == RANKS
    for r in ranks:
        rows = slice(2 * r["data_index"], 2 * r["data_index"] + 2)
        got = r["out"]
        np.testing.assert_array_equal(got[0], want[0][rows])
        np.testing.assert_array_equal(got[1], want[1][rows])
        np.testing.assert_allclose(got[2], want[2][rows], atol=1e-5,
                                   rtol=0)
    for a, b in ((0, 1), (2, 3)):
        for x, y in zip(ranks[a]["out"], ranks[b]["out"]):
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", ["ctc_token", "ctc_word"])
def test_sharded_ctc_search_matches_jax_meshless(name, runs):
    """ctc_beam_search_device_sharded at dp 2 x tp 2 (the token table as
    each rank's part, the word table whole and split by the wrapper, one
    hotword) against the JAX ctc_beam_search_device."""
    want = runs["jax"]["searches"][name]
    _stripes_match(runs["port"][name]["ranks"], want)
    assert (want[1] > 0).any()


def test_sharded_rnnt_search_matches_jax_meshless(runs):
    want = runs["jax"]["searches"]["rnnt_token"]
    _stripes_match(runs["port"]["rnnt_token"]["ranks"], want)
    assert (want[1] > 0).any()


def test_mesh_transducer_eval_beam_matches_jax(runs):
    """make_transducer_eval_step(decode="beam", mesh=) on a rank's stripe
    (the encoder split over the model group, the token table's buckets
    too) against the JAX eval step on the whole batch: the best beam's
    tokens and counts, its score (1e-4) and the global loss (2e-4)."""
    want = runs["jax"]["searches"]["eval_beam"]
    for r in runs["port"]["eval_beam"]["ranks"]:
        rows = slice(4 * r["data_index"], 4 * r["data_index"] + 4)
        got = r["out"]
        np.testing.assert_array_equal(got["counts"], want["counts"][rows])
        np.testing.assert_array_equal(got["tokens"], want["tokens"][rows])
        np.testing.assert_allclose(got["scores"], want["scores"][rows],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    assert (want["counts"] > 0).sum() >= 4      # the beams emit


@pytest.mark.parametrize("method", ["wav2vec2", "byol"])
def test_mesh_pretrain_step_matches_jax_meshless(method, runs):
    """Two steps at dp 2 x tp 2 with ZeRO-1 and SP on the JAX steps'
    draws: the losses and every parameter (the BYOL target's too)."""
    losses, params = runs["jax"]["pretrain"][method]
    got = runs["port"][method]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    jcfg = JConfig().override(**{**PRETRAIN, "pretrain.method": method})
    tcfg = Config.from_dict(jcfg.to_dict())
    scan = jcfg.model.use_scan_layers
    if method == "wav2vec2":
        trees = [(got["last"], "wav2vec2")]
    else:
        trees = [({k[7:]: v for k, v in got["last"].items()
                   if k.startswith(prefix)}, tree)
                 for prefix, tree in (("online.", "byol"),
                                      ("target.", "byol_target"))]
    for (state, tree), want in zip(trees, params):
        have = state_dict_to_flax(state, tcfg.model, scan, tree)["params"]
        leaves = jax.tree_util.tree_leaves_with_path(want)
        assert len(leaves) > 20
        for path, w in leaves:
            h = have
            for key in path:
                h = h[key.key]
            np.testing.assert_allclose(h, w, rtol=0, atol=1e-5,
                                       err_msg=f"{tree} "
                                       f"{jax.tree_util.keystr(path)}")


def test_byol_hash_dropout_takes_global_rows_on_the_mesh(runs):
    """BYOL's online batch on a rank is [view 1; view 2] of its stripe,
    which no single offset places in one device's [view 1; view 2]: with
    hash dropout 0.1 and remat (the backward recomputes each block) the
    mesh's step equals the port's one-device step on the whole batch. The
    attention runs its XLA path, whose probabilities' dropout is a hash
    site too: the kernel's own seed mixes the mesh indices, as the JAX
    package's sharded kernel does."""
    got = runs["port"]["byol_dropout"]
    np.testing.assert_allclose(got["mesh"]["losses"],
                               got["meshless"]["losses"], rtol=2e-4)
    assert abs(got["meshless"]["losses"][0]
               - runs["jax"]["pretrain"]["byol"][0][0]) > 1e-4  # it dropped
    for k, v in got["meshless"]["last"].items():
        np.testing.assert_allclose(got["mesh"]["last"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_make_mesh_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.mesh_from_config(Config().parallel)


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------

def test_param_spec_splits_the_big_products_and_keeps_uneven_ones_whole():
    cfg = Config().override(**BASE)
    model = build_model(cfg.model, "float32", seed=0)
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    spec = lambda name, tp, heads=2: tmesh.param_spec(name, shapes[name], tp,
                                                      heads)
    blk = "encoder.blocks.0."
    assert spec(blk + "ffn1.hidden.weight", 2) == 0
    assert spec(blk + "ffn1.out.weight", 2) == 1
    assert spec(blk + "ffn1.out.bias", 2) is None
    assert spec(blk + "mhsa.attention.query.weight", 2) == 0
    assert spec(blk + "mhsa.attention.content_bias", 2) == 0
    assert spec(blk + "mhsa.attention.out.weight", 2) == 1
    assert spec(blk + "mhsa.attention.query.weight", 4) is None  # 2 heads
    assert spec(blk + "conv.pointwise1.weight", 2) == tmesh.PAIRED
    assert spec(blk + "conv.bn.mean", 2) == 0
    assert spec(blk + "conv.pointwise2.weight", 2) == 1
    assert spec("decoder.lstm.0.weight_ih", 2) == 0
    assert spec("decoder.lstm.0.weight_hh", 2) is None
    assert spec("decoder.classifier.weight", 2) == 0
    assert spec("decoder.classifier.weight", 3) is None          # 40 % 3
    assert spec("encoder.input_proj.weight", 2) is None
    assert all(spec(n, 1) is None for n in shapes)
    # vocabulary 370 over 4 ranks stays whole; over 2 it splits
    assert tmesh.param_spec("decoder.classifier.weight", (370, 640), 4) is None
    assert tmesh.param_spec("decoder.classifier.weight", (370, 640), 2) == 0
    # pointwise1: each rank the matching value and gate channels
    full = torch.arange(8.0)[:, None]
    part = tmesh.shard_tensor(full, tmesh.PAIRED, 1, 2)
    assert part[:, 0].tolist() == [2.0, 3.0, 6.0, 7.0]
    assert tmesh.zero_dim((40, 80), 0, 4) == 1
    assert tmesh.zero_dim((40, 80), None, 4) == 0
    assert tmesh.zero_dim((3, 6), None, 4) is None
    assert tmesh.zero_dim((3, 6), None, 1) is None


def test_batch_stripes_follow_the_data_index_and_the_node(monkeypatch):
    """A rank's rows: of the global batch by data index, or of its node's
    batch under --multihost (LOCAL_WORLD_SIZE ranks a node)."""
    rows = np.arange(8)
    at = lambda rank, dp, tp: tmesh.Mesh(dp, tp, rank, None, None,
                                         torch.device("cpu"))
    assert tmesh.batch_stripe([rows], None) == (rows,)
    assert tmesh.batch_stripe([rows], at(5, 4, 2))[0].tolist() == [4, 5]
    assert tmesh.batch_stripe([rows], at(3, 8, 1))[0].tolist() == [3]
    # dp 4 over 2 nodes: data ranks 2 and 3 split the second node's batch
    assert tmesh.batch_stripe([rows], at(6, 4, 2), first_index=2,
                              ranks=2)[0].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_stripe([np.arange(6)], at(0, 4, 1))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tmesh.node_layout() == (0, 1)      # one process, no group


def test_hash_keep_offsets_give_the_part_of_the_global_mask():
    words, rate = (5, 0xFFFFFFF0), 0.3
    want = np.asarray(jdropout.hash_keep(
        (8, 15, 32), jnp.asarray(np.array(words, np.uint32)), rate))
    for b0, l0, c0 in ((0, 0, 0), (2, 0, 16), (4, 8, 0), (6, 8, 16)):
        got = tdropout.hash_keep((2, 7, 16), words, rate, "cpu",
                                 (b0, l0, c0)).numpy()
        np.testing.assert_array_equal(got, want[b0:b0 + 2, l0:l0 + 7,
                                                c0:c0 + 16])
    # rows that are not one run of the global array: one offset a row
    rows = torch.tensor([2, 3, 6, 7])
    got = tdropout.hash_keep((4, 15, 32), words, rate, "cpu",
                             (rows - torch.arange(4), 0, 0)).numpy()
    np.testing.assert_array_equal(got, want[rows.numpy()])


def test_attention_with_a_ranks_heads_matches_the_jax_kernels():
    """A rank of tp 2 calls K1/K2 with its 2 of 4 heads (packed D 32) and
    the whole position width (Dp 64): the plain versions against the JAX
    kernels in interpret mode on the same heads, the output and every
    gradient, with hash dropout; the rank's prep_pos_kernel of its columns
    is the full operand's slice of its heads (atol 2e-5 forward, 1e-4
    gradients, tests/test_torch_attention.py's)."""
    b, l, heads, h, dh = 2, 23, 4, 2, 16
    dp, d = heads * dh, h * dh
    rng = np.random.default_rng(5)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    qu, qv, k, v, g = (mk(b, l, d) for _ in range(5))
    kernel = (mk(dp, dp) / np.sqrt(dp)).astype(np.float32)
    lengths = np.array([23, 11], np.int32)
    scale, rate, seed = 1.0 / np.sqrt(dh), 0.1, 1234
    wh = np.array(jsa.prep_pos_kernel(jnp.asarray(kernel), heads))[:h]
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tsa.prep_pos_kernel(t(np.ascontiguousarray(kernel[:, :d])), h).numpy(),
        wh)

    def jax_loss(*xs):
        out = jsa.rel_attention_sincos_packed(
            *xs, jnp.asarray(lengths), scale, rate, seed, interpret=True)
        return jnp.sum(out * g), out

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(x) for x in (qu, qv, k, v, wh)))
    leaves = [t(x).requires_grad_(True) for x in (qu, qv, k, v, wh)]
    got = tsa.rel_attention_sincos_packed(*leaves, t(lengths), scale, rate,
                                          seed)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-4)
    # the card's selector and geometry at the production shards
    assert tsa.attention_variant(torch.bfloat16, 4, 64, 256, 512) == "wgmma"
    assert tsa.attention_variant(torch.bfloat16, 2, 64, 128, 512) == "wgmma"
    assert tsa.attention_variant(torch.float32, 4, 64, 256, 512) == "general"
    geo = tsa.general_geometry(torch.float32, 4, 199, 4, 64, 512)
    assert geo["d2p"] == 256 and geo["fwd_rows"] and geo["bwd_rows"]
    assert geo["bwd_scratch"] > tsa.general_geometry(
        torch.float32, 4, 199, 4, 64)["bwd_scratch"]
