"""Corpus WER/CER metrics (this package's copy of conformer_tpu/text/metrics.py).

Replaces torchmetrics WordErrorRate/CharErrorRate (reference: evaluation.py:18-27,
test.py:160-165): corpus-level rate = total edit distance / total reference
length, reported x100 by the eval CLI like the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    if not hyp:
        return len(ref)
    prev = np.arange(len(hyp) + 1, dtype=np.int64)
    cur = np.empty_like(prev)
    for i, r in enumerate(ref, start=1):
        cur[0] = i
        hyp_arr = np.array([1 if h != r else 0 for h in hyp], dtype=np.int64)
        # cur[j] = min(prev[j] + 1, cur[j-1] + 1, prev[j-1] + sub)
        sub = prev[:-1] + hyp_arr
        dele = prev[1:] + 1
        for j in range(len(hyp)):
            cur[j + 1] = min(sub[j], dele[j], cur[j] + 1)
        prev, cur = cur, prev
    return int(prev[-1])


def _corpus_rate(pairs: List[Tuple[Sequence, Sequence]]) -> float:
    errors = sum(edit_distance(r, h) for r, h in pairs)
    total = sum(len(r) for r, _ in pairs)
    return errors / max(total, 1)


def wer(predictions: "str | List[str]", targets: "str | List[str]") -> float:
    """Corpus word error rate (fraction, not percent)."""
    if isinstance(predictions, str):
        predictions, targets = [predictions], [targets]
    return _corpus_rate([(t.split(), p.split()) for p, t in zip(predictions, targets)])


def cer(predictions: "str | List[str]", targets: "str | List[str]") -> float:
    """Corpus character error rate (fraction, not percent)."""
    if isinstance(predictions, str):
        predictions, targets = [predictions], [targets]
    return _corpus_rate([(list(t), list(p)) for p, t in zip(predictions, targets)])
