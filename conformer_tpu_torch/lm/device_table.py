"""Device-resident n-gram LM: hashed bucket tables that the device beam
searches query every frame (counterpart of conformer_tpu/lm/device_table.py).

The host-side table construction is the JAX package's, in numpy, and
makes the same arrays bit for bit: ``DeviceNgramTable.from_arpa`` compiles an ARPA into one
pool of 8-entry buckets per n-gram order (bucket = fingerprint & mask, a
single hash; unigrams in dense id-indexed arrays), ``DeviceWordVocab`` maps
partial-word character hashes to word ids, ``DeviceHotwords`` holds hotword
phrase fingerprints. ``device_arrays(device)`` puts them on a device as
torch tensors, and the lookups are torch functions with static shapes (one
bucket gather and an in-vector compare of its 8 keys a query; no
data-dependent control flow), so the beam searches can run them inside a
CUDA graph.

torch has no general uint32 arithmetic. Every 32-bit hash is an int64 in
[0, 2^32): table keys and query fingerprints alike, each product cut back
to 32 bits by ``models/dropout.py::mul32`` in two 16-bit halves (a
constant or a tensor factor), so no product leaves int64. The tables'
float planes stay float tensors.

Over a mesh (ops/beam_search_device.py::ctc_beam_search_device_sharded) the
n-gram pools' buckets split over the model group: ``device_arrays(...,
part=(index, n))`` keeps rank ``index``'s contiguous bucket rows, and a probe
given the rank's ``TableShard`` looks up only the global buckets the rank
owns, then sums found, logp and backoff over the group. At most one rank
hits, so the sums equal the unsharded probe bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from conformer_tpu_torch.models.dropout import mul32

# FNV-1a based sequence fingerprint (uint32 wraparound).
# Python ints, not numpy scalars: one read in an exported while_loop's body
# would become a uint32 tensor constant there, which torch.export.save
# refuses on some versions
FNV_PRIME = 16777619
FNV_BASIS = 2166136261
EMPTY = 0                      # reserved key for empty slots
_BUCKET = 8                    # entries per bucket
# n_buckets = pow2(ceil(entries / _LOAD)): a mean bucket load of ~_LOAD
# entries; a bucket that overflows doubles the count, at most _MAX_GROWTH
# times (past that, more than _BUCKET entries share one fingerprint: keys
# that no size separates).
_LOAD = 2.0
_MAX_GROWTH = 8


def _bucket_layout(hashes, n_buckets: int) -> "list | None":
    """Each item's flat slot (bucket * _BUCKET + lane) by its hash, or None
    if a bucket overflows _BUCKET entries (the caller doubles and
    retries). Items must be deduplicated by key."""
    mask = n_buckets - 1
    fill = [0] * n_buckets
    pos = [0] * len(hashes)
    for i, h in enumerate(hashes):
        b = int(h) & mask
        lane = fill[b]
        if lane >= _BUCKET:
            return None
        fill[b] = lane + 1
        pos[i] = b * _BUCKET + lane
    return pos


def _fingerprint_np(ids: Sequence[int]) -> np.uint32:
    h = np.uint32(FNV_BASIS)
    for t in ids:
        h = np.uint32((int(h) ^ (int(t) & 0xFFFF)) & 0xFFFFFFFF)
        h = np.uint32((int(h) * FNV_PRIME) & 0xFFFFFFFF)
    if h == EMPTY:
        h = np.uint32(1)
    return h


class NgramTables(NamedTuple):
    """An n-gram table on a device: keys (order, n_buckets, 8) int64,
    values (order, n_buckets, 8, 2) f32 (logp, backoff), and the dense
    unigrams uni (V_lm, 2) f32 (logp, backoff) or None. Order 0's hash
    rows stay empty when the unigrams are dense. ``part``: (index, n) when
    the bucket rows are part ``index`` of ``n`` of the table's (the
    unigrams stay whole), else None."""

    keys: torch.Tensor
    values: torch.Tensor
    uni: Optional[torch.Tensor]
    part: Optional[Tuple[int, int]] = None

    @property
    def n_slots(self) -> int:
        """The whole table's bucket count."""
        return self.keys.shape[1] * (self.part[1] if self.part else 1)

    def take_part(self, index: int, n: int) -> "NgramTables":
        """Part ``index`` of ``n`` of a whole table's bucket rows (a
        contiguous copy)."""
        if self.part is not None:
            raise ValueError(f"the table is already part {self.part}")
        s = self.keys.shape[1]
        if s % n:
            raise ValueError(f"{s} buckets do not split into {n} parts")
        rows = slice(index * s // n, (index + 1) * s // n)
        return NgramTables(self.keys[:, rows].contiguous(),
                           self.values[:, rows].contiguous(), self.uni,
                           (index, n))


class TableShard(NamedTuple):
    """How a rank probes its part of a table split over a group (the JAX
    ``lm_axis_name`` with ``lm_n_slots_global``): its part ``index``, the
    whole table's bucket count ``n_slots``, and the process group whose
    ranks hold the parts (None: no sum, each part's own probe)."""

    index: int
    n_slots: int
    group: object = None


@dataclass
class DeviceNgramTable:
    """Per-order hash tables as host numpy; ``device_arrays`` puts them on
    a device once, for every search that follows."""

    order: int
    n_slots: int                       # buckets per order, a power of two
    keys: np.ndarray                   # (order, n_slots * _BUCKET) uint32
    logps: np.ndarray                  # (order, n_slots * _BUCKET) f32
    backoffs: np.ndarray               # (order, n_slots * _BUCKET) f32
    unk_logp: float
    vocab: dict                        # word/token string -> LM id
    bos_id: int
    n_probes: int                      # 1: one bucket a query
    uni_logps: np.ndarray = None       # (V_lm,) f32 dense unigram logp
    uni_backoffs: np.ndarray = None    # (V_lm,) f32 dense unigram backoff

    @classmethod
    def from_arpa(cls, arpa_path: str, slots_per_entry: float = 2.0
                  ) -> "DeviceNgramTable":
        from conformer_tpu_torch.lm.ngram import PyNgramLM

        lm = PyNgramLM(arpa_path)
        order = lm.order
        # Dense unigrams: ids are contiguous [0, V); an entry without a
        # backoff stores 0.0, as a hash miss would.
        v_lm = max(lm.vocab.values(), default=-1) + 1
        uni_logps = np.full((max(v_lm, 1),), -99.0, np.float32)
        uni_backoffs = np.zeros((max(v_lm, 1),), np.float32)
        for ids, (logp, backoff) in lm.tables[0].items():
            if 0 <= ids[0] < v_lm:
                uni_logps[ids[0]] = logp
                uni_backoffs[ids[0]] = backoff
        # Buckets sized for the largest hashed order (one count for every
        # order's pool).
        biggest = max([len(t) for t in lm.tables[1:]] or [1])
        n_buckets = 1 << int(np.ceil(np.log2(max(
            biggest * slots_per_entry / _LOAD / 2.0, 8))))
        # Each order's entries, deduplicated by fingerprint (the first
        # wins on a 32-bit collision, so a lookup hits at most once).
        rows = [[]]
        for table in lm.tables[1:]:
            seen, items = set(), []
            for ids, (logp, backoff) in table.items():
                fp = _fingerprint_np(ids)
                if int(fp) in seen:
                    continue
                seen.add(int(fp))
                items.append((fp, logp, backoff))
            rows.append(items)
        for _ in range(_MAX_GROWTH + 1):
            keys = np.zeros((order, n_buckets * _BUCKET), np.uint32)
            logps = np.zeros((order, n_buckets * _BUCKET), np.float32)
            backoffs = np.zeros((order, n_buckets * _BUCKET), np.float32)
            ok = True
            for m, items in enumerate(rows):
                pos = _bucket_layout([int(fp) for fp, _, _ in items],
                                     n_buckets)
                if pos is None:
                    ok = False
                    break
                for (fp, logp, backoff), slot in zip(items, pos):
                    keys[m, slot] = fp
                    logps[m, slot] = logp
                    backoffs[m, slot] = backoff
            if ok:
                break
            n_buckets *= 2
        else:
            raise RuntimeError(
                f"bucket layout failed for {arpa_path} even after "
                f"{_MAX_GROWTH} doublings ({n_buckets} buckets): more than "
                f"{_BUCKET} entries share one fingerprint bucket at every "
                "size (duplicate keys); this ARPA cannot be compiled into "
                "a bucketized device table")
        unk = lm.vocab.get("<unk>")
        unk_logp = (lm.tables[0][(unk,)][0]
                    if unk is not None and (unk,) in lm.tables[0] else -99.0)
        return cls(order=order, n_slots=n_buckets, keys=keys, logps=logps,
                   backoffs=backoffs, unk_logp=float(unk_logp),
                   vocab=dict(lm.vocab), bos_id=lm.vocab.get("<s>", -1),
                   n_probes=1, uni_logps=uni_logps,
                   uni_backoffs=uni_backoffs)

    def device_arrays(self, device, part: Optional[Tuple[int, int]] = None
                      ) -> NgramTables:
        """The table on ``device``; ``part=(index, n)`` keeps bucket rows
        [index * S / n, (index + 1) * S / n) of every order (S must divide
        by n), the dense unigrams whole."""
        shape = (self.order, self.n_slots, _BUCKET)
        keys = torch.from_numpy(self.keys.astype(np.int64).reshape(shape))
        values = torch.from_numpy(np.stack(
            [self.logps.reshape(shape), self.backoffs.reshape(shape)], -1))
        uni = None
        if self.uni_logps is not None:
            uni = torch.from_numpy(np.stack([self.uni_logps,
                                             self.uni_backoffs], -1))
        tables = NgramTables(keys, values, uni)
        if part is not None:
            tables = tables.take_part(*part)
        return NgramTables(tables.keys.to(device), tables.values.to(device),
                           None if uni is None else uni.to(device),
                           tables.part)


# ---------------------------------------------------------------------------
# Word-level fusion: character-rolling-hash word vocabulary.
# ---------------------------------------------------------------------------

def _build_pair_table(items, n_slots: int):
    """Bucket table keyed by (h1, h2) uint32 pairs; items: deduplicated
    (h1, h2, value) triples. -> (keys1, keys2, ids, n_probes=1), flat
    (n_buckets * _BUCKET) slots, ids -1 empty, bucket = h1 & mask."""
    if len({(int(h1), int(h2)) for h1, h2, _ in items}) != len(items):
        raise RuntimeError(
            "duplicate (h1, h2) keys collide in both 32-bit hashes; "
            "dedupe before building the pair table")
    n_buckets = max(n_slots // _BUCKET, 8)
    for _ in range(_MAX_GROWTH + 1):
        pos = _bucket_layout([int(h1) for h1, _, _ in items], n_buckets)
        if pos is not None:
            break
        n_buckets *= 2
    else:
        raise RuntimeError(
            f"bucket layout failed even after {_MAX_GROWTH} doublings "
            f"({n_buckets} buckets): more than {_BUCKET} entries share one "
            "h1 bucket at every size")
    keys1 = np.zeros((n_buckets * _BUCKET,), np.uint32)
    keys2 = np.zeros((n_buckets * _BUCKET,), np.uint32)
    ids = np.full((n_buckets * _BUCKET,), -1, np.int32)
    for (h1, h2, val), slot in zip(items, pos):
        keys1[slot], keys2[slot], ids[slot] = h1, h2, val
    return keys1, keys2, ids, 1


def _pack_pair_table(keys1, keys2, ids) -> np.ndarray:
    """(n_buckets, 32) uint32 bucket rows, plane-major: key1 in lanes
    [0:8), key2 [8:16), id bits [16:24), zeros [24:32) (the JAX
    package's device layout; id -1 round-trips through the view)."""
    n_buckets = keys1.shape[0] // _BUCKET

    def planes(a):
        return a.reshape(n_buckets, _BUCKET)

    return np.concatenate([
        planes(keys1), planes(keys2), planes(ids.view(np.uint32)),
        np.zeros((n_buckets, _BUCKET), np.uint32)], axis=-1)


# Polynomial rolling hash over code points: H(s) = sum ord(s_i) *
# MULT^(n-1-i) mod 2^32. It is affine in the running state (H(xy) = H(x) *
# MULT^|y| + H(y)), so a beam folds a whole token's characters into its
# partial-word hash with one multiply and one add of per-token constants.
# Two multipliers give a 64-bit key.
_POLY1 = np.uint32(1000003)
_POLY2 = np.uint32(2654435761)


def _poly_hash_np(s: str, mult: np.uint32) -> np.uint32:
    h = np.uint32(0)
    for ch in s:
        h = np.uint32((int(h) * int(mult) + ord(ch)) & 0xFFFFFFFF)
    return h


def _poly_consts_np(s: str, mult: np.uint32) -> Tuple[np.uint32, np.uint32]:
    """(A, B) with fold(h) = h * A + B for appending token string `s`."""
    a = np.uint32(1)
    for _ in s:
        a = np.uint32((int(a) * int(mult)) & 0xFFFFFFFF)
    return a, _poly_hash_np(s, mult)


class WordArrays(NamedTuple):
    """A DeviceWordVocab on a device: tok (V, 4) int64, each token's fold
    constants (a1, b1, a2, b2); table (n_buckets, 8, 3) int64 entries
    (key1, key2, word id), id -1 empty."""

    tok: torch.Tensor
    table: torch.Tensor


@dataclass
class DeviceWordVocab:
    """Partial-word character hashes -> word-level LM ids.

    The host search completes a word by string lookup
    (decode/beam_search.py); the device searches carry two rolling
    character hashes a beam and probe this table at word boundaries. A
    token c folds into a running hash h as h * tok_a[c] + tok_b[c], which
    equals _poly_hash_np of the concatenated string. Both keys must match.
    """

    tok_a1: np.ndarray   # (V,) uint32
    tok_b1: np.ndarray   # (V,) uint32
    tok_a2: np.ndarray   # (V,) uint32
    tok_b2: np.ndarray   # (V,) uint32
    keys1: np.ndarray    # (S,) uint32
    keys2: np.ndarray    # (S,) uint32
    ids: np.ndarray      # (S,) int32, -1 = empty
    n_probes: int

    @classmethod
    def build(cls, token_strings: Sequence[str], word_vocab: dict,
              slots_per_entry: float = 2.0) -> "DeviceWordVocab":
        v = len(token_strings)
        tok_a1 = np.zeros((v,), np.uint32)
        tok_b1 = np.zeros((v,), np.uint32)
        tok_a2 = np.zeros((v,), np.uint32)
        tok_b2 = np.zeros((v,), np.uint32)
        for i, s in enumerate(token_strings):
            tok_a1[i], tok_b1[i] = _poly_consts_np(s, _POLY1)
            tok_a2[i], tok_b2[i] = _poly_consts_np(s, _POLY2)
        words = [(w, wid) for w, wid in word_vocab.items()
                 if w not in ("<s>", "</s>", "<unk>")]
        seen, items = set(), []
        for w, wid in words:
            h1 = _poly_hash_np(w, _POLY1)
            h2 = _poly_hash_np(w, _POLY2)
            if (int(h1), int(h2)) in seen:
                continue  # duplicate spelling: the first wins
            seen.add((int(h1), int(h2)))
            items.append((h1, h2, wid))
        n_slots = 1 << int(np.ceil(np.log2(
            max(len(items) * slots_per_entry, 64))))
        keys1, keys2, ids, n_probes = _build_pair_table(items, n_slots)
        return cls(tok_a1=tok_a1, tok_b1=tok_b1, tok_a2=tok_a2,
                   tok_b2=tok_b2, keys1=keys1, keys2=keys2, ids=ids,
                   n_probes=n_probes)

    def device_arrays(self, device) -> WordArrays:
        tok = np.stack([self.tok_a1, self.tok_b1, self.tok_a2, self.tok_b2],
                       axis=1).astype(np.int64)
        packed = _pack_pair_table(self.keys1, self.keys2, self.ids)
        table = np.stack([
            packed[:, 0:_BUCKET].astype(np.int64),
            packed[:, _BUCKET:2 * _BUCKET].astype(np.int64),
            packed[:, 2 * _BUCKET:3 * _BUCKET].view(np.int32).astype(
                np.int64)], -1)
        return WordArrays(torch.from_numpy(tok).to(device),
                          torch.from_numpy(table).to(device))


# Hotword phrases: spans of up to _HOT_SPAN completed words, matched by
# folding the words' character-hash pairs with FNV (full 32-bit values).
_HOT_SPAN = 4


def _fold_word_seq_np(values: Sequence[int]) -> np.uint32:
    h = np.uint32(FNV_BASIS)
    for v in values:
        h = np.uint32((int(h) ^ int(v)) & 0xFFFFFFFF)
        h = np.uint32((int(h) * FNV_PRIME) & 0xFFFFFFFF)
    return h


class HotArrays(NamedTuple):
    """DeviceHotwords on a device: keys1, keys2 (N,) int64, valid (N,)
    bool."""

    keys1: torch.Tensor
    keys2: torch.Tensor
    valid: torch.Tensor


@dataclass
class DeviceHotwords:
    """Hotword phrase fingerprints. The host decoder boosts a completed
    word when a suffix of the text (up to 4 words) equals a hotword
    phrase; on the device each beam carries the character-hash pairs of
    its last completed words, folds the last k (k = 1..4) at a word
    boundary and compares them with every phrase (a few tens: a dense
    compare, no gather). Spelling-exact: OOV words hash by their
    characters."""

    keys1: np.ndarray   # (N,) uint32, zero-padded to a power of two
    keys2: np.ndarray   # (N,) uint32
    valid: np.ndarray   # (N,) bool (padding rows are False)

    @classmethod
    def build(cls, hotwords: Sequence[str]) -> "DeviceHotwords":
        phrases = []
        for h in hotwords:
            ws = h.upper().split()
            if 1 <= len(ws) <= _HOT_SPAN:
                phrases.append(ws)
        seen, items = set(), []
        for ws in phrases:
            fp1 = _fold_word_seq_np([_poly_hash_np(w, _POLY1) for w in ws])
            fp2 = _fold_word_seq_np([_poly_hash_np(w, _POLY2) for w in ws])
            if (int(fp1), int(fp2)) in seen:
                continue
            seen.add((int(fp1), int(fp2)))
            items.append((fp1, fp2))
        n = 1 << int(np.ceil(np.log2(max(len(items), 8))))
        keys1 = np.zeros((n,), np.uint32)
        keys2 = np.zeros((n,), np.uint32)
        valid = np.zeros((n,), bool)
        for i, (fp1, fp2) in enumerate(items):
            keys1[i], keys2[i], valid[i] = fp1, fp2, True
        return cls(keys1=keys1, keys2=keys2, valid=valid)

    def device_arrays(self, device) -> HotArrays:
        return HotArrays(
            torch.from_numpy(self.keys1.astype(np.int64)).to(device),
            torch.from_numpy(self.keys2.astype(np.int64)).to(device),
            torch.from_numpy(self.valid).to(device))


# ---------------------------------------------------------------------------
# Lookups (torch, static shapes).
# ---------------------------------------------------------------------------

def fnv_fold(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One FNV-1a step on 32-bit values held in int64: (h ^ v) * prime."""
    return mul32(h ^ v, FNV_PRIME)


def hotword_hit(hot: HotArrays, h1: torch.Tensor, h2: torch.Tensor
                ) -> torch.Tensor:
    """(...,) bool: does the (h1, h2) phrase fingerprint pair equal any
    hotword's? A dense compare against every phrase."""
    return (hot.valid & (hot.keys1 == h1[..., None])
            & (hot.keys2 == h2[..., None])).any(-1)


def lookup_pair(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor
                ) -> torch.Tensor:
    """(...,) hash pairs -> the stored value, -1 on a miss: one bucket
    gather (bucket = h1 & mask), then both keys compared in-vector. The
    table is deduplicated by (h1, h2), so at most one entry hits and the
    masked sum is the hit's value."""
    g = table[h1 & (table.shape[0] - 1)]                # (..., 8, 3)
    idv = g[..., 2]
    hit = ((g[..., 0] == h1[..., None]) & (g[..., 1] == h2[..., None])
           & (idv >= 0))
    val = torch.where(hit, idv, 0).sum(-1)
    return torch.where(hit.any(-1), val, -1)


def lookup_word_ids(word: WordArrays, h1: torch.Tensor, h2: torch.Tensor
                    ) -> torch.Tensor:
    """(...,) rolling hashes -> word LM ids (-1 when not in the LM)."""
    return lookup_pair(word.table, h1, h2)


def _fingerprint(ids: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the last axis of int64 ids (..., M) -> (...,), equal to
    _fingerprint_np of each row (the low 16 bits of each id, 0 -> 1)."""
    h = torch.full(ids.shape[:-1], FNV_BASIS, dtype=torch.int64,
                   device=ids.device)
    for m in range(ids.shape[-1]):
        h = fnv_fold(h, ids[..., m] & 0xFFFF)
    return torch.where(h == EMPTY, 1, h)


def _probe_rows(tables: NgramTables, fps: torch.Tensor, rows: Sequence[int],
                shard: Optional[TableShard] = None):
    """Probe g looks up fingerprint fps[..., g] in order rows[g]'s pool:
    one bucket gather a probe, the 8 keys compared in-vector. -> (found
    (..., G) bool, logp (..., G) f32, backoff (..., G) f32). Each order's
    pool is deduplicated by fingerprint, so at most one entry hits; empty
    entries hold key 0, which no fingerprint equals.

    With ``shard`` the tables hold part ``shard.index`` of a table of
    ``shard.n_slots`` buckets: the rank probes only the buckets it owns
    (any other gives no hit) and, given ``shard.group``, sums found, logp
    and backoff over the group in one all-reduce (in place, no autograd;
    NCCL's can be captured in a CUDA graph). Exactly one rank owns each
    bucket, so every sum has one non-zero term and equals the unsharded
    probe."""
    s_local = tables.keys.shape[1]
    bucket = fps & ((shard.n_slots if shard else s_local) - 1)
    in_range = None
    if shard is not None:
        bucket = bucket - shard.index * s_local
        in_range = (bucket >= 0) & (bucket < s_local)
        bucket = torch.where(in_range, bucket, 0)
    flat = torch.stack([bucket[..., g] + row * s_local
                        for g, row in enumerate(rows)], -1)
    keys = tables.keys.reshape(-1, _BUCKET)[flat]         # (..., G, 8)
    values = tables.values.reshape(-1, _BUCKET, 2)[flat]  # (..., G, 8, 2)
    hit = keys == fps[..., None]
    if in_range is not None:
        hit = hit & in_range[..., None]
    logp = torch.where(hit, values[..., 0], 0.0).sum(-1)
    backoff = torch.where(hit, values[..., 1], 0.0).sum(-1)
    found = hit.any(-1)
    if shard is not None and shard.group is not None:
        from conformer_tpu_torch.parallel.collectives import all_reduce_

        sums = all_reduce_(torch.stack([found.float(), logp, backoff]),
                           shard.group)
        found, logp, backoff = sums[0] > 0, sums[1], sums[2]
    return found, logp, backoff


def score_tokens(tables: NgramTables, ctx: torch.Tensor,
                 ctx_len: torch.Tensor, tok: torch.Tensor, unk_logp: float,
                 shard: Optional[TableShard] = None,
                 dense_pre=None) -> torch.Tensor:
    """Exact ARPA backoff log10 P(tok | ctx), elementwise.

    ctx (..., order-1) int64: the last order-1 LM ids, right-aligned
    (ctx[..., -1] the most recent), junk on the left; ctx_len (...,): how
    many trailing ids are valid; tok (...,) LM ids, < 0 for OOV (the unk
    penalty). ``dense_pre``: (uni logp at tok, uni backoff at ctx[-1]
    already zeroed for an invalid last id), when the caller has them.
    ``shard``: the tables are a rank's part of a table split over a group
    (``_probe_rows``; the JAX ``axis_name`` and ``n_slots_global``)."""
    order = tables.keys.shape[0]
    m_ctx = order - 1
    dense = tables.uni is not None
    # For each use-length u (context ids used, longest first): the
    # fingerprint of (ctx[-u:], tok) and, for the backoff, of ctx[-u:];
    # all hashed probes in one call. The unigram level and the length-1
    # context backoff are dense when the table has the unigrams.
    fp_list, bo_fp_list, usable_list = [], [], []
    lp_rows, bo_rows = [], []
    u_min = 1 if dense else 0
    for u in range(m_ctx, u_min - 1, -1):
        ids = torch.cat([ctx[..., m_ctx - u:], tok[..., None]], -1)
        fp_list.append(_fingerprint(ids))
        usable_list.append(ctx_len >= u)
        lp_rows.append(u)
        if u >= 1 + u_min:
            bo_fp_list.append(_fingerprint(ctx[..., m_ctx - u:]))
            bo_rows.append(u - 1)
    found_list, logp_list, bo_list = [], [], []
    if lp_rows or bo_rows:
        n_lp = len(lp_rows)
        f_all, lp_all, bo_all = _probe_rows(
            tables, torch.stack(fp_list + bo_fp_list, -1), lp_rows + bo_rows,
            shard)
        found_list = [f_all[..., i] & usable_list[i] for i in range(n_lp)]
        logp_list = [lp_all[..., i] for i in range(n_lp)]
        # backoff probe j was made in iteration j, so usable_list[j] gates
        bo_list = [torch.where(f_all[..., n_lp + j] & usable_list[j],
                               bo_all[..., n_lp + j], 0.0)
                   for j in range(len(bo_rows))]
    if dense:
        uni = tables.uni
        v_lm = uni.shape[0]
        found_list.append((tok >= 0) & (tok < v_lm))
        if dense_pre is not None:
            logp_list.append(dense_pre[0])
        else:
            logp_list.append(uni[tok.clamp(0, v_lm - 1), 0])
        if m_ctx >= 1:
            if dense_pre is not None:
                bo_list.append(torch.where(ctx_len >= 1, dense_pre[1], 0.0))
            else:
                last = ctx[..., -1]
                ok = (ctx_len >= 1) & (last >= 0) & (last < v_lm)
                bo_list.append(torch.where(
                    ok, uni[last.clamp(0, v_lm - 1), 1], 0.0))

    # The first level found (longest) wins; the backoff is the sum of the
    # levels longer than it.
    score = torch.full(tok.shape, unk_logp, dtype=torch.float32,
                       device=tok.device)
    taken = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    bo_sum = torch.zeros(tok.shape, dtype=torch.float32, device=tok.device)
    for i in range(len(found_list)):
        hit = found_list[i] & ~taken
        score = torch.where(hit, bo_sum + logp_list[i], score)
        taken = taken | hit
        if i < len(bo_list):
            bo_sum = bo_sum + torch.where(taken, 0.0, bo_list[i])
    score = torch.where(taken, score, bo_sum + unk_logp)
    return torch.where((tok < 0) & ~taken, bo_sum + unk_logp, score)
