"""The PyTorch port's whole serving path against the JAX package on the CPU.

The tiny CTC Conformer (ModelConfig.tiny, fp32), with flax-initialised
weights carried across by conformer_tpu_torch.convert, on the same seeded
audio: audio -> log-mels -> logits -> greedy tokens -> text. The JAX
attention's default 'pallas' impl runs its plain reference on the CPU, as
the JAX package's own tests run it. Tolerance: logits atol/rtol 1e-4 (fp32
on both sides; sums are taken in another order)."""

import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.ops.ctc import greedy_decode as j_greedy_decode
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables, make_forward as j_make_forward
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.train.steps import make_eval_step, make_forward
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 370   # the 'vi' tokenizer


def _configs(scan: bool, attention_impl: str = "pallas"):
    over = {"model.use_scan_layers": scan, "optim.compute_dtype": "float32",
            "model.attention_impl": attention_impl}
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**over)
    tcfg = Config.from_dict(jcfg.to_dict())
    return jcfg, tcfg


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x), variables["batch_stats"])

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            else:
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    fill(stats)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x), variables["params"])
    return {"params": params, "batch_stats": stats}


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 19200)) * 0.1).astype(np.float32)
    lengths = np.array([19200, 13000], np.int32)
    audio[1, 13000:] = 0.0
    return audio, lengths


@functools.lru_cache(maxsize=None)
def _variables(scan: bool):
    """Flax variables with random BatchNorm statistics, shared by both
    attention impls (the impl changes no parameter). Jitted, on a short
    dummy batch: one compile instead of one per op, and the parameter
    shapes do not depend on the batch's length."""
    jcfg, _ = _configs(scan)
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return _randomize_stats(init(jax.random.PRNGKey(3)), 4)


@functools.lru_cache(maxsize=None)
def _pair(scan: bool, attention_impl: str):
    """(JAX config, port config, flax variables, port model). Cached: the
    tests only read them."""
    jcfg, tcfg = _configs(scan, attention_impl)
    variables = _variables(scan)
    model = Conformer(tcfg.model, tcfg.optim.compute_dtype).eval()
    model.load_state_dict(flax_to_state_dict(variables, tcfg.model))
    return jcfg, tcfg, variables, model


@pytest.mark.parametrize("scan,impl", [(True, "pallas"), (False, "pallas"),
                                       (False, "xla")])
def test_logits_tokens_and_text_match_jax(scan, impl):
    jcfg, tcfg, variables, model = _pair(scan, impl)
    audio, lengths = _audio()
    tok = load_tokenizer("vi")
    jtok = j_load_tokenizer("vi")

    j_logits, j_len = jax.jit(j_make_forward(jcfg))(
        variables, jnp.asarray(audio), jnp.asarray(lengths))
    j_tokens, j_counts = j_greedy_decode(j_logits, j_len, unk_id=jtok.unk_id)

    t_logits, t_len = make_forward(tcfg, model)(torch.from_numpy(audio),
                                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)

    out = make_eval_step(tcfg, model, unk_id=tok.unk_id)(
        torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(out["counts"].numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(j_tokens))
    texts = [tok.collapsed_ids_to_text(out["tokens"][i].numpy(),
                                       out["counts"][i])
             for i in range(2)]
    j_texts = [jtok.collapsed_ids_to_text(np.asarray(j_tokens[i]),
                                          int(j_counts[i]))
               for i in range(2)]
    assert texts == j_texts


def test_cli_infer_on_cpu(tmp_path):
    """cli.infer.main end to end on WAV files with converted weights."""
    from conformer_tpu_torch.cli.infer import main

    jcfg, tcfg, variables, model = _pair(True, "pallas")
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    cfg_path = tmp_path / "cfg.json"
    tcfg.to_json(str(cfg_path))
    audio, lengths = _audio(1)
    paths = []
    for i in range(3):
        p = tmp_path / f"a{i}.wav"
        n = int(lengths[i % 2])
        wavfile.write(p, 16000, (audio[i % 2, :n] * 32767).astype(np.int16))
        paths.append(str(p))
    out_csv = tmp_path / "out.csv"
    pipe = main(["--audio", *paths, "--config", str(cfg_path),
                 "--weights", str(weights), "--device", "cpu",
                 "--batch-size", "2", "--output", str(out_csv)])
    with open(out_csv, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["path", "prediction"] and len(rows) == 4
    assert [b["batch_size"] for b in pipe.batch_log] == [2, 1]
    # The same audio through the JAX forward gives the same text.
    jtok = j_load_tokenizer("vi")
    sig = wavfile.read(paths[2])[1].astype(np.float32) / 32768.0
    j_logits, j_len = jax.jit(j_make_forward(jcfg))(
        variables, jnp.asarray(sig[None]), jnp.asarray([len(sig)], jnp.int32))
    j_tokens, j_counts = j_greedy_decode(j_logits, j_len, unk_id=jtok.unk_id)
    want = jtok.collapsed_ids_to_text(np.asarray(j_tokens[0]), int(j_counts[0]))
    assert rows[3] == [paths[2], want]
