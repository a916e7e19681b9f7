"""Pairwise einsum execution with per-step rescaling: float32-safe
log-space contraction for any topology.

Counterpart of ``tneq_tpu/ops/pairwise.py``.  An einsum runs as its
explicit pairwise contraction path, two operands per ``torch.einsum``
(``execute_pairwise``: the one executor of the port, which
``ops/contract.py`` and ``ops/row_scan.py`` call too), and with
``rescale=True`` every intermediate is renormalised:

    t_k   <- contract(t_i, t_j)
    s_k    = detach(max|t_k| + tiny)
    t_k   <- t_k / s_k ;  log_scale += log(s_k)

Detached scales keep the gradient of the LOG of the result exact (the
rescale cancels between mantissa and scale).  This keeps a two-network
overlap finite in float32 at any depth, where the dense einsum under- or
overflows beyond ~24 qubits.

Each step is re-lettered to ``a-zA-Z`` (``torch.einsum`` takes no other
symbols; a large circuit's equation goes past 52 into Unicode), and on the
card a step whose terms have more than ``CUDA_MAX_DIMS`` dimensions
raises.  Operands are promoted to one dtype first, as ``jnp.einsum`` does.

Path selection is memory-guarded (:func:`choose_path`): the native path
finder's path when its largest intermediate fits ``max_intermediate``, else
the linear left-fold (a boundary-MPS sweep when the caller orders operands
row-major), else the smaller of the two with a warning.  Unlike JAX, a
failed path search raises instead of falling back to the linear path.
"""

from __future__ import annotations

import functools
import logging
import string
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..native.path import find_path

__all__ = [
    "CUDA_MAX_DIMS",
    "choose_path",
    "einsum",
    "execute_pairwise",
    "log_abs_einsum",
    "make_log_abs_overlap_fn",
    "make_log_abs_two_network_fn",
    "pairwise_steps",
    "path_flops",
    "rescaled_execute",
    "row_major_core_order",
    "two_network_interleave",
]

_TINY = 1e-30

# CUDA's elementwise kernels (the copies behind einsum's permutes) take at
# most this many dimensions
CUDA_MAX_DIMS = 25

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


def _index_sizes(equation: str, shapes: Sequence[Tuple[int, ...]]) -> Dict[str, int]:
    lhs, _ = equation.split("->")
    dims: Dict[str, int] = {}
    for sub, shape in zip(lhs.split(","), shapes):
        dims.update(zip(sub, shape))
    return dims


def _max_intermediate_size(
    equation: str, shapes: Sequence[Tuple[int, ...]], path
) -> int:
    """Largest intermediate (in elements) the path would materialize."""
    dims = _index_sizes(equation, shapes)
    biggest = 0
    for _, _, eq in pairwise_steps(equation, path):
        out = eq.split("->")[1]
        size = int(np.prod([dims[ch] for ch in out], dtype=np.float64)) if out else 1
        biggest = max(biggest, size)
    return biggest


def path_flops(
    equation: str, shapes: Sequence[Tuple[int, ...]], path
) -> float:
    """Exact real FLOPs of executing the path: 2·prod(union-of-index sizes)
    per pairwise step (one multiply-add = 2 FLOPs)."""
    dims = _index_sizes(equation, shapes)
    total = 0.0
    for _, _, eq in pairwise_steps(equation, path):
        union = set(eq.split("->")[0].replace(",", ""))
        total += 2.0 * float(np.prod([dims[ch] for ch in union], dtype=np.float64))
    return total


@functools.lru_cache(maxsize=512)
def choose_path(
    equation: str,
    shapes: Tuple[Tuple[int, ...], ...],
    max_intermediate: int = 1 << 26,
    strict: bool = False,
) -> Tuple[Tuple[int, int], ...]:
    """The native path finder's path when its intermediates fit
    ``max_intermediate`` elements, else the linear left-fold when it fits;
    else the smaller of the two, with a warning (``strict=True``: raise
    ``ValueError``).  The native path comes first because its bushier tree
    beats the linear sweep's long chain of dependent steps on the device,
    at more flops.  A failed native search raises."""
    n = len(shapes)
    if n <= 2:
        return tuple(_linear_path(n))
    native = find_path(equation, shapes)
    native_sz = _max_intermediate_size(equation, shapes, native)
    if native_sz <= max_intermediate:
        return tuple(native)
    linear = _linear_path(n)
    linear_sz = _max_intermediate_size(equation, shapes, linear)
    if linear_sz <= max_intermediate:
        return tuple(linear)
    best, best_sz = (native, native_sz) if native_sz < linear_sz else (linear, linear_sz)
    msg = (
        f"no contraction path fits max_intermediate={max_intermediate}: "
        f"proceeding with a {best_sz}-element intermediate "
        f"(native: {native_sz}, linear: {linear_sz})"
    )
    if strict:
        raise ValueError(msg)
    logging.getLogger(__name__).warning(msg)
    return tuple(best)


@functools.lru_cache(maxsize=8192)
def _lettered(equation: str) -> Tuple[str, int]:
    """``equation`` with its symbols renamed to a-zA-Z in order of first
    appearance, and the largest rank of its terms."""
    names: Dict[str, str] = {}
    for ch in equation:
        if ch not in ",->" and ch not in names:
            if len(names) == len(string.ascii_letters):
                raise ValueError(
                    f"a pairwise step needs more than {len(names)} symbols, more "
                    f"than torch.einsum takes: {equation!r}"
                )
            names[ch] = string.ascii_letters[len(names)]
    rank = max(len(term) for term in equation.replace("->", ",").split(","))
    return "".join(names.get(ch, ch) for ch in equation), rank


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of ``equation`` re-lettered to a-zA-Z; on the card a
    term of more than ``CUDA_MAX_DIMS`` dimensions raises."""
    lettered, rank = _lettered(equation)
    if rank > CUDA_MAX_DIMS and operands[0].is_cuda:
        raise ValueError(
            f"a pairwise step of this contraction has a rank-{rank} tensor; "
            f"CUDA's elementwise kernels take at most {CUDA_MAX_DIMS} dimensions"
        )
    return torch.einsum(lettered, *operands)


def _rescale(t: torch.Tensor, logs: Optional[torch.Tensor] = None):
    """``t / s`` and ``logs + log s`` for ``s = detach(max|t| + tiny)``, real:
    the max-abs rescale of every sweep and executor of the port."""
    s = t.detach().abs().max() + _TINY
    return t / s, torch.log(s) if logs is None else logs + torch.log(s)


def execute_pairwise(
    steps: Sequence[Step],
    operands: Sequence[torch.Tensor],
    contract_pair: Optional[Callable] = None,
    rescale: bool = False,
):
    """Run the resolved steps; returns ``final`` or ``(final, log_scale)``.

    ``contract_pair(eq, a, b)`` defaults to :func:`einsum`.  Operands are
    promoted to one dtype first.  With ``rescale=True`` every intermediate
    is max-abs normalised and the accumulated log-scale, in the real dtype
    of the operands, returned alongside (detached scales: LOG gradients
    stay exact).
    """
    if contract_pair is None:
        contract_pair = einsum
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    ops = [o.to(dtype) for o in operands]
    logs = None
    for i, j, eq in steps:
        a, b = ops[i], ops[j]
        ops.pop(max(i, j))
        ops.pop(min(i, j))
        t = contract_pair(eq, a, b)
        if rescale:
            t, logs = _rescale(t, logs)
        ops.append(t)
    final = ops[0]
    if rescale:
        if logs is None:  # zero steps (one operand)
            logs = torch.zeros((), dtype=final.real.dtype, device=final.device)
        return final, logs
    return final


def rescaled_execute(
    equation: str,
    operands: Sequence[torch.Tensor],
    max_intermediate: int = 1 << 26,
):
    """Plan (memoised by :func:`choose_path`) and execute ``equation``
    through the per-step rescaled executor.  Returns ``(mantissa,
    log_scale)`` with ``true_value = mantissa·exp(log_scale)``: the one
    entry point of every rescale=True caller (siamese value and env,
    two-network overlaps, :func:`log_abs_einsum`)."""
    shapes = tuple(tuple(int(d) for d in o.shape) for o in operands)
    path = choose_path(equation, shapes, max_intermediate)
    return execute_pairwise(pairwise_steps(equation, list(path)), operands, rescale=True)


def log_abs_einsum(
    equation: str,
    operands: Sequence[torch.Tensor],
    max_intermediate: int = 1 << 26,
) -> torch.Tensor:
    """log|einsum(equation, *operands)| for a SCALAR-output einsum,
    float32-stable at any network depth (per-step renormalisation)."""
    if not equation.endswith("->"):
        raise ValueError("log_abs_einsum requires a scalar-output equation")
    final, logs = rescaled_execute(equation, operands, max_intermediate)
    return logs + torch.log(torch.abs(final) + _TINY)


def row_major_core_order(graph) -> List[int]:
    """Core indices sorted by (lowest qubit touched, symbol index): the
    qubit-sweep order that keeps boundary environments small for layered
    circuits (brick wall / wall_col)."""

    def min_qubit(c):
        return min(e.qubit for e in c.in_edges + c.out_edges)

    return sorted(range(graph.ncores), key=lambda i: (min_qubit(graph.cores[i]), i))


def two_network_interleave(graph_a, graph_b=None):
    """Operand order of a two-network overlap: the row-major slots of the
    two networks interleaved (A_k then B_k per slot, the boundary-MPS
    pairing), so the linear path stays a boundary sweep.  Different core
    counts interleave by zip as far as possible and append the remainder.

    Returns ``(equation, slots)`` with ``slots`` ``[(side, name), ...]``:
    'a' operands come from params_a, 'b' from params_b (the caller
    conjugates the B side)."""
    from .einsum_spec import two_network_spec

    gb = graph_b if graph_b is not None else graph_a
    spec = two_network_spec(graph_a, gb)
    lhs, rhs = spec.equation.split("->")
    subs = lhs.split(",")
    n = graph_a.ncores
    order_a = row_major_core_order(graph_a)
    order_b = row_major_core_order(gb)
    perm: List[int] = []
    slots: List[Tuple[str, str]] = []
    m = min(len(order_a), len(order_b))
    for i in range(m):
        perm.append(order_a[i])
        slots.append(("a", graph_a.cores[order_a[i]].name))
        perm.append(n + order_b[i])
        slots.append(("b", gb.cores[order_b[i]].name))
    for k in order_a[m:]:
        perm.append(k)
        slots.append(("a", graph_a.cores[k].name))
    for k in order_b[m:]:
        perm.append(n + k)
        slots.append(("b", gb.cores[k].name))
    equation = ",".join(subs[p] for p in perm) + "->" + rhs
    return equation, slots


def make_log_abs_two_network_fn(
    graph_a,
    graph_b=None,
    max_intermediate: int = 1 << 26,
    signed: bool = False,
):
    """fn(params_a, params_b) -> log|⟨A, B⟩| for two networks.

    ``graph_b`` may be another topology, or the same one with other
    internal bond ranks; only the boundary ranks must match.  B-side cores
    are conjugated (Hermitian overlap).  ``signed=True`` returns
    ``(mantissa, log_scale)`` instead, the form in which slice partials
    are summed.
    """
    equation, slots = two_network_interleave(graph_a, graph_b)

    def fn(params_a, params_b):
        ops = [params_a[name] if side == "a" else params_b[name].conj()
               for side, name in slots]
        if not signed:
            return log_abs_einsum(equation, ops, max_intermediate)
        return rescaled_execute(equation, ops, max_intermediate)

    return fn


def make_log_abs_overlap_fn(graph, max_intermediate: int = 1 << 26):
    """fn(params_a, params_b) -> log|⟨A, B⟩| for two same-graph networks,
    any topology: the operands interleaved row-major, so the linear path is
    the boundary-MPS sweep; the native path where its intermediates fit."""
    return make_log_abs_two_network_fn(graph, None, max_intermediate)
