"""Python bindings of the native contraction-path finder.

Counterpart of ``tneq_tpu/native/path.py`` (``parse_equation``,
``find_path``, ``path_cost``), with one difference: where JAX's functions
return ``None`` (no library, or the search failed) and its callers fall back
to ``opt_einsum``, these raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

from .build import load_library

__all__ = ["DP_MAX_OPERANDS", "find_path", "path_cost", "parse_equation"]

# operand counts up to this run the exact bitmask-DP search (exponential in
# n but sub-millisecond in C++); larger networks use the greedy heuristic
DP_MAX_OPERANDS = 16


def parse_equation(
    equation: str, shapes: Sequence[Sequence[int]]
) -> Tuple[List[List[int]], List[float], List[int]]:
    """einsum equation + shapes -> (operand symbol-id lists, sizes, output ids)."""
    lhs, rhs = equation.split("->")
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError(
            f"equation has {len(terms)} operands but {len(shapes)} shapes given"
        )
    sym_ids: Dict[str, int] = {}
    sizes: List[float] = []
    ops: List[List[int]] = []
    for term, shape in zip(terms, shapes):
        if len(term) != len(shape):
            raise ValueError(f"term {term!r} does not match shape {shape}")
        ids = []
        for ch, dim in zip(term, shape):
            if ch not in sym_ids:
                sym_ids[ch] = len(sizes)
                sizes.append(float(dim))
            elif sizes[sym_ids[ch]] != dim:
                raise ValueError(f"inconsistent size for index {ch!r}")
            ids.append(sym_ids[ch])
        ops.append(ids)
    out = [sym_ids[ch] for ch in rhs]
    return ops, sizes, out


def _pack(ops, sizes, out):
    offsets = [0]
    flat: List[int] = []
    for o in ops:
        flat.extend(o)
        offsets.append(len(flat))
    c_off = (ctypes.c_int * len(offsets))(*offsets)
    c_sym = (ctypes.c_int * max(1, len(flat)))(*(flat or [0]))
    c_sizes = (ctypes.c_double * len(sizes))(*sizes)
    c_out = (ctypes.c_int * max(1, len(out)))(*(out or [0]))
    return c_off, c_sym, c_sizes, c_out


def find_path(
    equation: str,
    shapes: Sequence[Sequence[int]],
    method: str = "auto",
) -> List[Tuple[int, ...]]:
    """Pairwise contraction path of an einsum, opt_einsum style: each step
    names two positions of the current operand list, which are removed and
    their result appended.  ``method``: 'auto' (optimal DP up to
    ``DP_MAX_OPERANDS`` operands, greedy beyond), 'greedy' or 'dp'.  A DP
    search that refuses falls back to greedy, as in JAX; a failed greedy
    search raises ``RuntimeError``."""
    if method not in ("auto", "greedy", "dp"):
        raise ValueError(f"unknown method {method!r}")
    lib = load_library()
    ops, sizes, out = parse_equation(equation, shapes)
    n = len(ops)
    if n <= 1:
        return [(0,)] if n == 1 else []
    c_off, c_sym, c_sizes, c_out = _pack(ops, sizes, out)
    path_buf = (ctypes.c_int * (2 * (n - 1)))()
    args = (n, c_off, c_sym, c_sizes, len(sizes), c_out, len(out), path_buf)
    use_dp = method == "dp" or (method == "auto" and n <= DP_MAX_OPERANDS)
    rc = (lib.tneq_find_path_dp if use_dp else lib.tneq_find_path)(*args)
    if rc != 0 and use_dp:  # DP refused (too many operands): greedy
        rc = lib.tneq_find_path(*args)
    if rc != 0:
        raise RuntimeError(f"the native path search failed (rc {rc}) for {equation!r}")
    return [(path_buf[2 * i], path_buf[2 * i + 1]) for i in range(n - 1)]


def path_cost(equation: str, shapes: Sequence[Sequence[int]]) -> float:
    """Estimated total element-ops of the greedy path (a fast cost model for
    ranking candidate structures)."""
    lib = load_library()
    ops, sizes, out = parse_equation(equation, shapes)
    n = len(ops)
    if n <= 1:
        return 0.0
    c_off, c_sym, c_sizes, c_out = _pack(ops, sizes, out)
    cost = ctypes.c_double(0.0)
    rc = lib.tneq_path_cost(
        n, c_off, c_sym, c_sizes, len(sizes), c_out, len(out), ctypes.byref(cost)
    )
    if rc != 0:
        raise RuntimeError(f"the native path cost failed (rc {rc}) for {equation!r}")
    return cost.value
