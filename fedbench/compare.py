"""The comparison that decides ``correct``: gaps between the program's
readings and the reference's, each held to its limit.

A gap of norms is taken leaf by leaf: the distance between the program's
norm of a leaf and the reference's, over the larger of the reference's
norm of that leaf and the median leaf's, and the worst leaf is the
reading.  A leaf whose reference gradient (or first update) is under a
thousandth of the median leaf's moves by rounding alone and is left out
of the change after several steps.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch

QUIET = 1e-3


def norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            named.items()}


def diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
         ) -> Dict[str, torch.Tensor]:
    return {k: a[k].float() - b[k].float() for k in b}


def moving(ref_grad_norms: Dict[str, float]) -> set:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= QUIET * med}


def gap_of_norms(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Optional[Iterable[str]] = None) -> float:
    keys = sorted(ref if keep is None else set(keep) & set(ref))
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        den = max(ref[k], med)
        if not math.isfinite(prog[k]):
            return math.inf
        worst = max(worst, abs(prog[k] - ref[k]) / den if den > 0
                    else abs(prog[k]))
    return worst


def diff_by_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's norm of the difference, over the larger of the
    reference's norm of that leaf and the median leaf's: where a gap of
    norms averages rounding away, this keeps every element's share."""
    rn = norms(ref)
    keys = sorted(rn if keep is None else set(keep) & set(rn))
    med = statistics.median(rn[k] for k in keys)
    worst = 0.0
    for k in keys:
        d = float(torch.linalg.vector_norm(prog[k].float() - ref[k].float()))
        if not math.isfinite(d):
            return math.inf
        den = max(rn[k], med)
        worst = max(worst, d / den if den > 0 else d)
    return worst


def rel_gap(a: float, b: float) -> float:
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / abs(b)


def against(values: Dict[str, float], limits: dict) -> List[dict]:
    """Each reading beside its limit (``limits[name]``); a reading passes
    when it is finite and not above its limit."""
    out = []
    for name, v in values.items():
        lim = limits[name]
        out.append({"name": name, "value": float(v), "limit": lim,
                    "ok": math.isfinite(v) and v <= lim})
    return out
