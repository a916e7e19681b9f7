"""The numbers that decide ``correct``, each held against its own limit.

Norms are compared by the worst leaf: the gap between the program's norm of
a leaf and the reference's, over the larger of the reference's norm of that
leaf and the median leaf's.  A leaf whose gradient in the reference is
under a thousandth of the median leaf's moves by round-off alone (a masked
gate; every gate of a lane already at its optimum) and is left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["worst_leaf_gap", "Check", "verdict"]

Check = Tuple[str, float, float]  # name, value, limit

GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm


def worst_leaf_gap(prog: Sequence[float], ref: Sequence[float],
                   ref_grad: Sequence[float]) -> float:
    """The worst leaf's ``|prog − ref| / max(ref, median ref)`` over the
    leaves whose reference gradient is at least ``GRAD_FLOOR`` of the
    median leaf's.  The three sequences are aligned leaf by leaf."""
    prog, ref, g = (np.asarray(v, dtype=np.float64) for v in (prog, ref, ref_grad))
    keep = g >= GRAD_FLOOR * float(np.median(g))
    if not keep.any():
        return math.inf
    med = float(np.median(ref[keep]))
    denom = np.maximum(ref[keep], med)
    return float(np.max(np.abs(prog[keep] - ref[keep]) / denom))


def verdict(checks: List[Check]) -> bool:
    """True when every number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def as_json(checks: List[Check]) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}``; a value that is not finite is null."""
    return {name: {"value": v if math.isfinite(v) else None, "limit": lim}
            for name, v, lim in checks}
