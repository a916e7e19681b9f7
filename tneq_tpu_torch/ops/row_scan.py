"""Row-sweep overlap contraction for layered 2-local circuits (brick wall,
wall_col).

Counterpart of ``tneq_tpu/ops/row_scan.py``.  The two-network overlap
⟨A, B⟩ is contracted as a boundary sweep over QUBIT ROWS: the environment
between rows q and q+1 carries the row-(q+1) legs of the cores spanning
that cut (``r^(4·n_cells)`` entries, independent of the qubit count), and
each row absorbs its cores in one einsum, planned as pairwise steps under a
memory cap of a small multiple of the environment
(``ops/pairwise.choose_path``) and run by ``ops/pairwise.execute_pairwise``.
A max-abs rescale after every row (detached scales) keeps the sweep
float32-stable at any depth, with exact gradients of the LOG overlap.

JAX runs the identical bulk rows as one ``lax.scan`` over stacked cores
and rematerialises every row (``jax.checkpoint``) to keep its program small
and its tile-padded residuals in HBM; the port loops over the rows in
Python, with the same rescale points, and lets autograd save what it saves.

Applies to graphs where every core spans exactly two adjacent qubit rows;
:func:`supports_row_scan` reports applicability, and callers take the
generic pairwise executor otherwise.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, get_symbol
from ..utils.profiling import annotate
from .pairwise import (
    _TINY,
    _linear_path,
    _rescale,
    choose_path,
    einsum,
    execute_pairwise,
    pairwise_steps,
)

__all__ = [
    "MAX_ENV_ELEMENTS",
    "build_row_steps",
    "make_row_scan_log_overlap_fn",
    "same_topology",
    "supports_row_scan",
]

# env entries beyond this are refused (r^(4*n_cells) grows with depth; the
# generic pairwise path handles deep-narrow circuits instead)
MAX_ENV_ELEMENTS = 1 << 24


def _core_rows(core) -> Tuple[int, ...]:
    return tuple(sorted({e.qubit for e in core.in_edges + core.out_edges}))


def same_topology(graph_a: CircuitGraph, graph_b: CircuitGraph) -> bool:
    """True when the two graphs differ at most in INTERNAL bond ranks: same
    cores and names, same wiring (qubit and neighbour per slot), same
    boundary-leg ranks.  The overlap of such a pair is well-defined."""
    if graph_a.nqubits != graph_b.nqubits or graph_a.ncores != graph_b.ncores:
        return False
    for ca, cb in zip(graph_a.cores, graph_b.cores):
        if ca.name != cb.name:
            return False
        for ea_list, eb_list in ((ca.in_edges, cb.in_edges), (ca.out_edges, cb.out_edges)):
            if len(ea_list) != len(eb_list):
                return False
            for ea, eb in zip(ea_list, eb_list):
                if ea.qubit != eb.qubit or ea.neighbor != eb.neighbor:
                    return False
                if ea.neighbor == -1 and ea.rank != eb.rank:
                    return False
    return True


def supports_row_scan(
    graph: CircuitGraph, graph_b: Optional[CircuitGraph] = None
) -> bool:
    """True when every core spans exactly two ADJACENT qubit rows, every
    cut has a core, and the cut environments stay within
    ``MAX_ENV_ELEMENTS`` (A-side times B-side leg ranks with ``graph_b``,
    which must have the same topology)."""
    if graph_b is not None and not same_topology(graph, graph_b):
        return False
    if graph.nqubits < 3:
        return False
    gb = graph_b if graph_b is not None else graph
    cuts: Dict[int, List[int]] = {}
    for core in graph.cores:
        rows = _core_rows(core)
        if len(rows) != 2 or rows[1] != rows[0] + 1:
            return False
        cuts.setdefault(rows[0], []).append(core.index)
    for q in range(graph.nqubits - 1):
        if q not in cuts:
            return False
    for q, idxs in cuts.items():
        size_a = size_b = 1
        for i in idxs:
            for e in graph.cores[i].in_edges + graph.cores[i].out_edges:
                if e.qubit == q + 1:
                    size_a *= e.rank
            for e in gb.cores[i].in_edges + gb.cores[i].out_edges:
                if e.qubit == q + 1:
                    size_b *= e.rank
        if size_a * size_b > MAX_ENV_ELEMENTS:
            return False
    return True


class _Sym:
    def __init__(self):
        self.n = 0

    def next(self) -> str:
        s = get_symbol(self.n)
        self.n += 1
        return s


def _row_order(graph: CircuitGraph, idxs: List[int], q: int) -> List[int]:
    """Cut-q cores ordered along the row (the row-q chain's order)."""
    chain = [graph.name_to_index[n] for n in graph.qubit_cores(q)]
    pos = {i: k for k, i in enumerate(chain)}
    return sorted(idxs, key=lambda i: pos[i])


def build_row_steps(graph: CircuitGraph, graph_b: Optional[CircuitGraph] = None):
    """Resolve the row sweep into per-row einsums, as JAX does.

    Returns a list over rows q = 0..n-1 of dicts with ``equation`` (over
    [env?, A-cores..., B-cores...]), ``cores`` (cut-q core names in row
    order; empty for the last row), ``has_env``, ``env_in_shape`` and
    ``env_out_shape``.  Each row's output axes are the env axes the next
    row consumes, in order.  ``graph_b``: the B side when its internal bond
    ranks differ from A's; equations are rank-agnostic, only the env shapes
    depend on it.
    """
    net_graph = {"A": graph, "B": graph_b if graph_b is not None else graph}
    n = graph.nqubits
    cuts: Dict[int, List[int]] = {}
    for core in graph.cores:
        rows = _core_rows(core)
        cuts.setdefault(rows[0], []).append(core.index)
    cut_order = {q: _row_order(graph, idxs, q) for q, idxs in cuts.items()}

    def edge_class(net: str, core_idx: int, e, is_out: bool):
        """Boundary edges glue A and B (the class ignores the net); internal
        bonds pair the two endpoint cores within a network."""
        if e.neighbor == -1:
            return ("bnd", e.qubit, "out" if is_out else "in")
        a, b = sorted((core_idx, e.neighbor))
        return ("bond", net, e.qubit, a, b)

    def axis_rank(net, ci, ref):
        is_out, pos = ref
        core = net_graph[net].cores[ci]
        return (core.out_edges if is_out else core.in_edges)[pos].rank

    steps = []
    # env_axes: (net, core_idx, (is_out, position)) of the legs on row q+1
    # whose symbols the next row reuses
    env_axes: List[Tuple[str, int, Tuple[bool, int]]] = []
    for q in range(n):
        sym = _Sym()
        class_syms: Dict[object, str] = {}

        def sym_for(cls):
            if cls not in class_syms:
                class_syms[cls] = sym.next()
            return class_syms[cls]

        env_subscript = ""
        for net, ci, (is_out, pos) in env_axes:
            core = graph.cores[ci]
            e = (core.out_edges if is_out else core.in_edges)[pos]
            assert e.qubit == q, (q, net, ci, e)
            env_subscript += sym_for(edge_class(net, ci, e, is_out))

        new_idxs = cut_order.get(q, [])
        core_subs = {}
        next_env: List[Tuple[str, int, Tuple[bool, int]]] = []
        out_syms: List[str] = []
        for net in ("A", "B"):
            for ci in new_idxs:
                core = graph.cores[ci]
                sub = ""
                for is_out, edges in ((False, core.in_edges), (True, core.out_edges)):
                    for pos, e in enumerate(edges):
                        if e.qubit == q:
                            sub += sym_for(edge_class(net, ci, e, is_out))
                        else:  # row q+1: an open env leg
                            s = sym.next()
                            sub += s
                            out_syms.append(s)
                            next_env.append((net, ci, (is_out, pos)))
                core_subs[(net, ci)] = sub

        operands = [env_subscript] if env_axes else []
        for net in ("A", "B"):
            for ci in new_idxs:
                operands.append(core_subs[(net, ci)])
        steps.append({
            "equation": ",".join(operands) + "->" + "".join(out_syms),
            "cores": [graph.cores[ci].name for ci in new_idxs],
            "has_env": bool(env_axes),
            "env_in_shape": tuple(axis_rank(*ax) for ax in env_axes),
            "env_out_shape": tuple(axis_rank(*ax) for ax in next_env),
        })
        env_axes = next_env
    assert not env_axes, "sweep did not close"
    return steps


class _Row(NamedTuple):
    cores: Tuple[str, ...]
    has_env: bool
    equation: str
    steps: Optional[tuple]  # pairwise steps; None: one operand, one einsum


@functools.lru_cache(maxsize=64)
def _schedule(graph: CircuitGraph, graph_b: Optional[CircuitGraph]) -> Tuple[_Row, ...]:
    """The rows of the sweep with their pairwise plans.  A row of more than
    two operands is planned by ``choose_path`` under the cap
    ``max(64·env, 2^16)``, env the larger of its in and out environments:
    JAX's tight guard, which keeps every intermediate within a small
    multiple of the environment."""
    gb = graph_b if graph_b is not None else graph
    rows = []
    for step in build_row_steps(graph, graph_b):
        shapes = [step["env_in_shape"]] if step["has_env"] else []
        shapes += [graph.shapes[nm] for nm in step["cores"]]
        shapes += [gb.shapes[nm] for nm in step["cores"]]
        eq = step["equation"]
        cap = max(
            int(np.prod(step["env_in_shape"], dtype=np.int64)),
            int(np.prod(step["env_out_shape"], dtype=np.int64)),
        )
        cap = max(64 * cap, 1 << 16)
        if len(shapes) == 1:
            plan = None
        elif len(shapes) == 2:
            plan = tuple(pairwise_steps(eq, _linear_path(2)))
        else:
            plan = tuple(pairwise_steps(eq, list(choose_path(eq, tuple(shapes), cap))))
        rows.append(_Row(tuple(step["cores"]), step["has_env"], eq, plan))
    return tuple(rows)


def make_row_scan_log_overlap_fn(
    graph: CircuitGraph,
    graph_b: Optional[CircuitGraph] = None,
    signed: bool = False,
):
    """fn(params_a, params_b) -> log|⟨A, B⟩| via the row sweep.

    B-side cores are conjugated (Hermitian overlap).  Raises ``ValueError``
    when the topology is unsupported (check :func:`supports_row_scan`).

    ``graph_b``: the B side with other internal bond ranks (same
    topology).  ``signed=True``: return ``(mantissa, log_scale)`` with
    ``value = mantissa·exp(log_scale)``, the form in which slice partials
    are summed.
    """
    if not supports_row_scan(graph, graph_b):
        raise ValueError("graph is not a layered 2-local circuit")
    rows = _schedule(graph, graph_b)

    def fn(params_a, params_b):
        with annotate("row_sweep.overlap"):
            env, logs = None, None
            for row in rows:
                ops = [env] if row.has_env else []
                ops += [params_a[nm] for nm in row.cores]
                ops += [params_b[nm].conj() for nm in row.cores]
                if row.steps is None:
                    out = einsum(row.equation, ops[0])
                else:
                    out = execute_pairwise(row.steps, ops)
                env, logs = _rescale(out, logs)
            if signed:
                return env, logs
            return logs + torch.log(torch.abs(env) + _TINY)

    return fn
