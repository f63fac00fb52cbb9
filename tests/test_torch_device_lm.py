"""The port's exact top-k and device LM tables against the JAX package on
the CPU (conformer_tpu_torch/ops/topk.py, conformer_tpu_torch/lm/
device_table.py).

- ``topk_lastaxis`` and ``topk_stable`` give ``lax.top_k``'s values and
  indices, ties (and NEG-masked lanes) lowest index first; ``argsort_desc``
  gives ``jnp.argsort(-x)``: equal;
- the tables (``DeviceNgramTable.from_arpa`` with and without bucket
  growth, ``DeviceWordVocab.build``, ``DeviceHotwords.build``) hold the
  JAX package's arrays and its device layout bit for bit;
- the lookups (``score_tokens``, ``lookup_word_ids``, ``hotword_hit`` and
  the FNV fingerprint) give the JAX functions' values on seeded queries,
  misses and OOV ids included: equal, bit for bit;
- an LM table sharded over a mesh axis raises, naming ROADMAP §1 item 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.lm import device_table as jdt
from conformer_tpu.lm.ngram import build_arpa
from conformer_tpu.ops.topk import topk_lastaxis as j_topk_lastaxis
from conformer_tpu_torch.lm import device_table as dt
from conformer_tpu_torch.ops.topk import (NEG, argsort_desc, topk_lastaxis,
                                          topk_stable)
from conformer_tpu_torch.text.tokenizer import load_tokenizer

CPU = torch.device("cpu")
WORDS = ["XIN", "CHÀO", "BẠN", "CẢM", "ƠN", "TẠM", "BIỆT", "LỖI", "VIỆT",
         "NAM"]


def _topk_inputs():
    rng = np.random.default_rng(0)
    rand = rng.standard_normal((3, 5, 37)).astype(np.float32)
    ties = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0, -0.0, 0.0]], np.float32)
    dead = np.full((2, 10), NEG, np.float32)
    dead[0, 7], dead[1, 3], dead[1, 9] = -1.0, -2.0, -1.5
    coarse = rng.integers(-3, 3, (4, 40)).astype(np.float32)
    return [(rand, 8), (ties, 6), (dead, 5), (coarse, 12)]


@pytest.mark.parametrize("case", range(4))
def test_topk_follows_lax_top_k_ties_included(case):
    x, k = _topk_inputs()[case]
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    jv, ji = j_topk_lastaxis(jnp.asarray(x), k)
    np.testing.assert_array_equal(np.asarray(jv), np.asarray(want_v))
    for fn in (topk_lastaxis, topk_stable):
        v, i = fn(torch.from_numpy(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(
        argsort_desc(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.argsort(-jnp.asarray(x))))


@pytest.fixture(scope="module")
def word_arpa(tmp_path_factory):
    root = tmp_path_factory.mktemp("devlm")
    rng = np.random.default_rng(0)
    corpus = root / "corpus.txt"
    corpus.write_text("\n".join(" ".join(rng.choice(WORDS, rng.integers(2, 7)))
                                for _ in range(300)), encoding="utf8")
    path = str(root / "lm.arpa")
    build_arpa(str(corpus), path, order=3)
    return path


def _same_table(got, want):
    for name in ("order", "n_slots", "unk_logp", "vocab", "bos_id",
                 "n_probes"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("keys", "logps", "backoffs", "uni_logps", "uni_backoffs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    # the device tables hold the JAX device layout's planes
    packed = np.asarray(want.device_arrays()[0])     # (order, buckets, 32)
    arrays = got.device_arrays(CPU)
    np.testing.assert_array_equal(arrays.keys.numpy(),
                                  packed[..., :8].astype(np.int64))
    assert arrays.values.numpy().tobytes() == np.stack(
        [packed[..., 8:16], packed[..., 16:24]], -1).tobytes()
    np.testing.assert_array_equal(
        arrays.uni.numpy(), np.stack([want.uni_logps, want.uni_backoffs], -1))


@pytest.mark.parametrize("slots_per_entry", [2.0, 0.02])
def test_ngram_table_is_the_jax_table_bit_for_bit(word_arpa, slots_per_entry):
    """At 0.02 slots an entry the first bucket count overflows and the
    count doubles, in both packages."""
    got = dt.DeviceNgramTable.from_arpa(word_arpa, slots_per_entry)
    want = jdt.DeviceNgramTable.from_arpa(word_arpa, slots_per_entry)
    _same_table(got, want)
    if slots_per_entry < 1:
        assert got.n_slots > 8


def _queries(table, n=300, seed=1):
    """Seeded (ctx, ctx_len, tok): right-aligned contexts with junk on the
    left, OOV (-1) and out-of-range ids, and <s> contexts."""
    rng = np.random.default_rng(seed)
    m_ctx = table.order - 1
    ids = sorted(table.vocab.values())
    ctx = rng.choice(ids + [-1], (n, m_ctx)).astype(np.int32)
    ctx_len = rng.integers(0, m_ctx + 1, n).astype(np.int32)
    tok = rng.choice(ids + [-1, len(ids) + 5], n).astype(np.int32)
    ctx[: n // 10, -1] = table.bos_id
    ctx_len[: n // 10] = np.maximum(ctx_len[: n // 10], 1)
    return ctx, ctx_len, tok


def test_score_tokens_is_the_jax_scorer_bit_for_bit(word_arpa):
    table = dt.DeviceNgramTable.from_arpa(word_arpa)
    jtable = jdt.DeviceNgramTable.from_arpa(word_arpa)
    ctx, ctx_len, tok = _queries(table)
    want = np.asarray(jdt.score_tokens(
        jtable.device_arrays(), jnp.asarray(ctx), jnp.asarray(ctx_len),
        jnp.asarray(tok), jtable.unk_logp))
    arrays = table.device_arrays(CPU)
    got = dt.score_tokens(arrays, torch.from_numpy(ctx).long(),
                          torch.from_numpy(ctx_len).long(),
                          torch.from_numpy(tok).long(), table.unk_logp)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert (tok < 0).any() and np.isfinite(want).all()


@pytest.mark.parametrize("tp", [2, 4])
def test_split_probe_sums_to_the_unsharded_scorer(word_arpa, monkeypatch,
                                                  tp):
    """Each part's local probe (what a rank of a model group of tp holds
    before the sum), summed over the parts, gives the unsharded and the
    JAX score_tokens bit for bit: the group's all-reduce is played by
    summing the parts' local sums."""
    from conformer_tpu_torch.parallel import collectives

    table = dt.DeviceNgramTable.from_arpa(word_arpa)
    jtable = jdt.DeviceNgramTable.from_arpa(word_arpa)
    ctx, ctx_len, tok = _queries(table, seed=3)
    args = (torch.from_numpy(ctx).long(), torch.from_numpy(ctx_len).long(),
            torch.from_numpy(tok).long(), table.unk_logp)
    want = np.asarray(jdt.score_tokens(
        jtable.device_arrays(), jnp.asarray(ctx), jnp.asarray(ctx_len),
        jnp.asarray(tok), jtable.unk_logp))
    whole = table.device_arrays(CPU)
    parts = [table.device_arrays(CPU, part=(i, tp)) for i in range(tp)]
    assert parts[1].keys.shape[1] * tp == whole.keys.shape[1]
    assert parts[1].n_slots == table.n_slots and parts[1].part == (1, tp)
    assert torch.equal(parts[1].keys, whole.take_part(1, tp).keys)
    local = []
    monkeypatch.setattr(collectives, "all_reduce_",
                        lambda t, group: local.append(t.clone()) or t)
    for i, part in enumerate(parts):
        dt.score_tokens(part, *args, shard=dt.TableShard(i, table.n_slots,
                                                         "group"))
    # every query hits on one part at most, and some hit off part 0
    found = torch.stack([x[0] for x in local])
    assert found.sum(0).max() == 1 and found[1:].sum() > 0
    total = torch.stack(local).sum(0)
    monkeypatch.setattr(collectives, "all_reduce_", lambda t, group: total)
    for i, part in enumerate(parts):
        got = dt.score_tokens(part, *args, shard=dt.TableShard(
            i, table.n_slots, "group"))
        assert got.numpy().tobytes() == want.tobytes()
    assert dt.score_tokens(whole, *args).numpy().tobytes() == want.tobytes()


def test_fingerprint_is_the_jax_fingerprint():
    ids = np.random.default_rng(2).integers(-1, 70000, (50, 4)).astype(
        np.int32)
    want = np.asarray(jdt._fingerprint_jnp(jnp.asarray(ids),
                                           jnp.ones(ids.shape, bool)))
    got = dt._fingerprint(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) >= 2 ** 31


def test_word_vocab_and_hotwords_are_the_jax_ones(word_arpa):
    tok = load_tokenizer("vi")
    table = dt.DeviceNgramTable.from_arpa(word_arpa)
    # a vocabulary big enough that the pair table grows past its floor
    vocab = dict(table.vocab)
    for i in range(600):
        vocab[f"W{i}"] = len(vocab)
    got = dt.DeviceWordVocab.build(tok.vocab, vocab)
    want = jdt.DeviceWordVocab.build(tok.vocab, vocab)
    for name in ("tok_a1", "tok_b1", "tok_a2", "tok_b2", "keys1", "keys2",
                 "ids"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()
    j_tok, j_packed = (np.asarray(x) for x in want.device_arrays())
    assert dt._pack_pair_table(got.keys1, got.keys2, got.ids).tobytes() == \
        j_packed.tobytes()
    arrays = got.device_arrays(CPU)
    np.testing.assert_array_equal(arrays.tok.numpy(), j_tok.astype(np.int64))

    # every LM word is found, misses (and a word never seen) give -1
    words = [w for w in vocab if w not in ("<s>", "</s>", "<unk>")]
    queries = words + ["ZZRX", "XINCHÀO", ""]
    h1 = np.array([dt._poly_hash_np(w, dt._POLY1) for w in queries],
                  np.uint32)
    h2 = np.array([dt._poly_hash_np(w, dt._POLY2) for w in queries],
                  np.uint32)
    h2[-1] ^= 1                      # the first hash hits, the second not
    want_ids = np.asarray(jdt.lookup_word_ids(
        want.device_arrays(), jnp.asarray(h1), jnp.asarray(h2)))
    got_ids = dt.lookup_word_ids(arrays, torch.from_numpy(h1.astype(np.int64)),
                                 torch.from_numpy(h2.astype(np.int64)))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert (got_ids.numpy()[: len(words)] == [vocab[w] for w in words]).all()
    assert (got_ids.numpy()[len(words):] == -1).all()

    hot = ["xin chào", "việt nam", "cảm ơn bạn nhiều lắm", "ZZRX",
           "a b c d e"]
    got_h = dt.DeviceHotwords.build(hot)
    want_h = jdt.DeviceHotwords.build(hot)
    for name in ("keys1", "keys2", "valid"):
        assert getattr(got_h, name).tobytes() == \
            getattr(want_h, name).tobytes()
    rng = np.random.default_rng(3)
    q1 = np.concatenate([want_h.keys1[:3], rng.integers(
        0, 2 ** 32, 20, dtype=np.uint64).astype(np.uint32)])
    q2 = np.concatenate([want_h.keys2[:3], rng.integers(
        0, 2 ** 32, 20, dtype=np.uint64).astype(np.uint32)])
    q2[1] ^= 1
    want_hit = np.asarray(jdt.hotword_hit(want_h.device_arrays(),
                                          jnp.asarray(q1), jnp.asarray(q2)))
    got_hit = dt.hotword_hit(got_h.device_arrays(CPU),
                             torch.from_numpy(q1.astype(np.int64)),
                             torch.from_numpy(q2.astype(np.int64)))
    np.testing.assert_array_equal(got_hit.numpy(), want_hit)
    assert got_hit.numpy()[[0, 2]].all() and not got_hit.numpy()[1]
