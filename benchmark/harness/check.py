"""The numbers that can decide a training cell's ``correct``, each the gap
between the program's reading and the reference's; a cell's limits file
names the ones it compares:

- ``loss1``: the relative gap of the first step's loss (the forward from
  the same weights); ``loss``: the largest over every step followed;
- ``grad``: the first step's gradient as the optimizer got it, by the
  worst leaf: | ||g_prog|| - ||g_ref|| | over the larger of ||g_ref|| and
  the median leaf's; ``grad_median``: the median leaf's gap;
  ``grad2_median``, ...: the median leaf's gap of each later step's
  gradient (each side at its own parameters);
- ``change``, ``change_median``: each leaf's change over the steps
  followed, the same two ways.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias under softmax, which moves under Adam by round-off alone)
are left out of the leaf numbers.
"""

from __future__ import annotations

from typing import Dict, List

import torch

SMALL = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _median(xs) -> float:
    return float(torch.tensor(list(xs), dtype=torch.float64).median())


def counted(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(ref_grad)
    med = _median(n.values())
    return sorted(k for k, v in n.items() if v >= SMALL * med)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> dict:
    """-> the worst and the median leaf's gap, and the three worst leaves
    with their norms (program, reference) beside the median leaf's."""
    pn = _norms({k: prog[k] for k in leaves})
    rn = _norms({k: ref[k] for k in leaves})
    med = _median(rn[k] for k in leaves)
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in leaves}
    worst = sorted(leaves, key=lambda k: -gaps[k])[:3]
    return {"worst": gaps[worst[0]], "median": _median(gaps.values()),
            "leaves": [[k, gaps[k], pn[k], rn[k]] for k in worst],
            "median_norm": med}


def per_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: List[str]) -> Dict[str, List[float]]:
    """-> each leaf's [gap of norms, norm of the difference], both over
    the larger of the reference's norm and the median leaf's: the second
    sees every rounding, the first only what moves the norm."""
    rn = _norms({k: ref[k] for k in leaves})
    med = _median(rn.values())
    out = {}
    for k in leaves:
        d = max(rn[k], med)
        p, r = prog[k].double(), ref[k].double()
        out[k] = [abs(float(torch.linalg.vector_norm(p)) - rn[k]) / d,
                  float(torch.linalg.vector_norm(p - r)) / d]
    return out


def readings(prog: dict, ref: dict, leaf_detail: bool = False) -> dict:
    """prog, ref: {"losses", "grads" (a step's gradient a leaf, every
    step's), "change"} -> every number, and the
    worst leaves for the record (``leaf_detail``: every leaf's, and the
    norms of the differences, for a look at where a gap comes from)."""
    leaves = counted(ref["grads"][0])
    grad = leaf_gaps(prog["grads"][0], ref["grads"][0], leaves)
    change = leaf_gaps(prog["change"], ref["change"], leaves)
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    return {"loss1": losses[0], "loss": max(losses),
            "losses_gap": losses,
            **{f"grad{n}_median": leaf_gaps(pg, rg, leaves)["median"]
               for n, pg, rg in zip(range(2, 99), prog["grads"][1:],
                                    ref["grads"][1:])},
            "grad": grad["worst"], "grad_median": grad["median"],
            "change": change["worst"], "change_median": change["median"],
            "grad_leaves": grad["leaves"], "change_leaves": change["leaves"],
            "grad_median_norm": grad["median_norm"],
            "change_median_norm": change["median_norm"],
            "leaves": len(leaves), "leaves_out": len(ref["grads"][0]) - len(leaves),
            **({"per_leaf": {"grad1": per_leaf(prog["grads"][0], ref["grads"][0],
                                               leaves),
                             "change": per_leaf(prog["change"],
                                                ref["change"], leaves)}}
               if leaf_detail else {})}
