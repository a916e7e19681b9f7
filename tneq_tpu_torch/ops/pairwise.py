"""Pairwise einsum schedules: an opt_einsum-style path resolved into
explicit two-operand einsums.

Counterpart of ``tneq_tpu/ops/pairwise.py``, so far only ``_linear_path``
and :func:`pairwise_steps`, which ``ops/contract.py`` executes.  The rest of
that module (``choose_path``, ``execute_pairwise``, ``rescaled_execute``
and the log-abs overlap functions) comes with the brick-wall network mode
(ROADMAP A, item 7b).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["pairwise_steps"]

Step = Tuple[int, int, str]  # (i, j, "sub_i,sub_j->sub_out")


def _linear_path(n: int) -> List[Tuple[int, int]]:
    """((o0·o1)·o2)·...: sequential left-fold over the operand order.

    opt_einsum convention appends each result at the END of the operand
    list, so after the first step the running result sits at the last
    position: fold steps contract (0, len-1).
    """
    if n <= 1:
        return []
    path = [(0, 1)]
    for remaining in range(n - 1, 1, -1):
        path.append((0, remaining - 1))
    return path


def pairwise_steps(
    equation: str, path: Sequence[Tuple[int, int]]
) -> List[Step]:
    """Resolve an opt_einsum-style path into explicit two-operand einsums.

    Each step names current-list positions ``(i, j)``; both are removed and
    the step result appended (opt_einsum execution convention).  The step's
    output keeps every symbol still needed by remaining operands or by the
    final output, in first-appearance order.
    """
    lhs, rhs = equation.split("->")
    cur = lhs.split(",")
    steps: List[Step] = []
    for step_i, (i, j) in enumerate(path):
        if i == j:
            raise ValueError("path step contracts an operand with itself")
        a, b = cur[i], cur[j]
        hi, lo = max(i, j), min(i, j)
        cur.pop(hi)
        cur.pop(lo)
        if step_i == len(path) - 1 and not cur:
            # last step: emit the requested output order exactly
            if not set(rhs) <= set(a + b):
                raise ValueError(
                    f"output {rhs!r} references symbols missing from the "
                    f"final operands {a!r},{b!r}"
                )
            out = rhs
        else:
            keep = set(rhs) | set("".join(cur))
            out = "".join(dict.fromkeys(ch for ch in a + b if ch in keep))
        steps.append((i, j, f"{a},{b}->{out}"))
        cur.append(out)
    if len(cur) != 1:
        raise ValueError(f"path does not contract to one operand: {cur}")
    if set(cur[0]) != set(rhs):
        raise ValueError(f"path output {cur[0]!r} != equation output {rhs!r}")
    return steps
