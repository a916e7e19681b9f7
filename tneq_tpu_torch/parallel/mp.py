"""Model parallelism: bond-sliced contraction over a ``model`` mesh axis.

Counterpart of ``tneq_tpu/parallel/mp.py``.  Chosen internal bonds become
an explicit slice index: fixing it on the two cores that share each bond
and summing the contraction over every index gives the full value, so the
slices can be shared out over the positions of the mesh's ``model`` axis.
JAX runs each share inside ``shard_map`` and combines with ``psum``; here
every factory is two functions of a flat slice index:

- a *slice partial*: the sliced cores' bond axes fixed at the index
  (``select`` in the raw forms, ``narrow`` keeping a size-1 axis in the
  log form, one axis further for stacked-real pairs), then the contraction
  through the port's executors (``ops/contract.execute`` for the raw
  forms; the row sweep, the rescaled pairwise executor or its pair twin in
  ``signed`` form for the log form);
- a *combine*: a sum of the raw partials; in the log form a running-max
  sum of ``(mantissa, log_scale)`` partials per position, then the group
  max of the detached log-scales and the sum of the renormalised
  mantissas over positions.

Two execution forms, decided when a factory is called:

- **one process** (``torch.distributed`` not initialised, or one rank):
  this process holds every position of the ``model`` axis and runs every
  slice in turn.  The positions must share one device (the one-card form:
  ``make_mesh({"model": 2}, devices=["cuda:0"] * 2)``).  A ``data`` axis
  changes no number: the whole batch is contracted.
- **ranks**: one ``torch.distributed`` rank per mesh position
  (``parallel/mesh.py``).  The rank at ``model`` coordinate ``r`` runs
  slices ``r·local ..``, and the combine goes through ``all_reduce`` on
  its ``model`` line (MAX for the log-scales, SUM for the partials).  The
  siamese contraction's ``data_axis`` (JAX's ``in_specs=(P(), P(),
  P(data_axis))``) becomes this rank's rows of the batch: each rank
  contracts its rows and the rows are gathered over its ``data`` line, so
  ``fn`` returns the whole batch, as JAX's does.  Ranks on one line of
  any other axis compute the same.

Gradients.  JAX's gradient of the replicated params is the sum over
devices of each device's slice terms.  In one process that is what
autograd gives, every slice being in one graph.  Across ranks the SUM
combine passes the cotangent through unchanged and the row gather hands
each rank its own rows' cotangent (``parallel/_collectives.py``), so each
rank's gradient holds its own slices' terms of its own rows, and the
caller sums the parameter gradients over the ranks that hold different
terms with ``fn.reduce_gradients`` (one flat buffer) before the optimizer
update.  A loss on the gathered batch is its mean over the global batch,
as in JAX.  This is exact when every gradient term passes through a
sliced contraction, as in the fits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..graph.dsl import CircuitGraph
from ..graph.surgery import with_bond_ranks
from ..ops.complex_pair import make_pair_log_abs_two_network_fn, pair_abs2
from ..ops.contract import abs_square, execute
from ..ops.einsum_spec import siamese_spec_sliced, two_network_spec_sliced
from ..ops.pairwise import make_log_abs_two_network_fn
from ..ops.row_scan import make_row_scan_log_overlap_fn, supports_row_scan
from ..train.losses import nll_loss
from ._collectives import all_reduce, gather_rows, sum_flat
from .mesh import Mesh, data_sharding, rank_form

__all__ = [
    "choose_slice_bonds",
    "make_sliced_siamese_fn",
    "make_sliced_two_network_fn",
    "make_sliced_log_overlap_fn",
    "sliced_nll_loss",
]

BondKey = Tuple[int, int, int]  # (min_core_idx, max_core_idx, qubit)

_NEG = -1e30  # "log of zero": the log-scale of an empty share of slices
#               (finite: -inf - (-inf) in the running max would give NaN)
_TINY = 1e-30  # log(|x| + _TINY): keeps exact zeros finite


def _internal_bonds(graph: CircuitGraph) -> List[Tuple[BondKey, int]]:
    seen = {}
    for core in graph.cores:
        for e in core.out_edges:
            if e.neighbor >= 0:
                key = (min(core.index, e.neighbor), max(core.index, e.neighbor), e.qubit)
                seen.setdefault(key, e.rank)
    return sorted(seen.items())


def choose_slice_bonds(
    graph: CircuitGraph, n_slices: int, prefer_early_rows: bool = False
) -> Tuple[BondKey, ...]:
    """Greedily pick internal bonds whose rank product covers ``n_slices``
    (slices per position = ceil(product / n_slices); a non-divisible
    product is padded, the padded tail contributing nothing).

    Max-rank bonds first; ``prefer_early_rows``: lowest-qubit bonds first
    (max rank as the tie-break), so slicing touches only the first rows of
    the row sweep (``ops/row_scan.py``).
    """
    if n_slices == 1:
        return ()
    if prefer_early_rows:
        bonds = sorted(_internal_bonds(graph), key=lambda kv: (kv[0][2], -kv[1]))
    else:
        bonds = sorted(_internal_bonds(graph), key=lambda kv: -kv[1])
    if not bonds:
        raise ValueError("graph has no internal bonds to slice")
    chosen: List[BondKey] = []
    prod = 1
    for key, rank in bonds:
        if prod % n_slices == 0:
            break
        chosen.append(key)
        prod *= rank
    if prod % n_slices != 0 and prod < n_slices:
        raise ValueError(
            f"cannot reach {n_slices} slices from bond ranks "
            f"{[r for _, r in bonds]} (product {prod})"
        )
    return tuple(chosen)


def _bond_indices(flat_idx: int, ranks: Sequence[int]) -> List[int]:
    """Per-bond indices of a flat slice index (the last bond fastest)."""
    idxs = []
    for r in reversed(ranks):
        idxs.append(flat_idx % r)
        flat_idx //= r
    return idxs[::-1]


class _Positions:
    """The positions of the ``model`` axis this process runs (all of them
    in one process, its rank's in the rank form), their shares of the
    ``total`` slices, the combine over positions and the gradient sum over
    ``reduce_axes`` (the ``model`` axis, and the ``data`` axis where the
    rows are split)."""

    def __init__(self, mesh: Mesh, model_axis: str, total: int,
                 reduce_axes: Tuple[str, ...] = ()):
        n_model = mesh.shape[model_axis]
        self.total = total
        self.local = -(-total // n_model)  # ceil: the tail is padded
        self.ranks = rank_form()
        if self.ranks:
            self.line = mesh.line((model_axis,))
            self.positions: Tuple[int, ...] = (self.line.index,)
            self.reduce_line = mesh.line((model_axis,) + tuple(reduce_axes))
        else:
            mesh.device()  # one device for every position
            self.positions = tuple(range(n_model))

    def slices(self, pos: int) -> range:
        return range(pos * self.local, min(self.total, (pos + 1) * self.local))

    def sum(self, partials: List[torch.Tensor]) -> torch.Tensor:
        """Raw forms: the positions' partial sums added (JAX's ``psum``)."""
        if self.ranks:
            return all_reduce(partials[0], self.line)
        acc = partials[0]
        for p in partials[1:]:
            acc = acc + p
        return acc

    def log_sum(self, parts: List[Tuple[torch.Tensor, torch.Tensor]]):
        """Log form: ``(gmax, m_tot)`` from each position's ``(m, l)``: the
        group max of the detached log-scales (JAX's ``pmax``), then the sum
        of the renormalised mantissas."""
        if self.ranks:
            (m, l), = parts
            gmax = all_reduce(l.detach(), self.line, dist.ReduceOp.MAX)
            return gmax, all_reduce(m * torch.exp(l - gmax), self.line)
        gmax = torch.stack([l for _, l in parts]).max().detach()
        return gmax, self.sum([m * torch.exp(l - gmax) for m, l in parts])

    def reduce_gradients(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The parameter gradients summed over the ranks that hold
        different terms, through one flat buffer (safe under
        ``torch.func.vmap``); unchanged in one process."""
        if not self.ranks:
            return grads
        return sum_flat(grads, self.reduce_line)


def _finish(fn, positions: _Positions):
    fn.reduce_gradients = positions.reduce_gradients
    fn.ranks = positions.ranks
    return fn


def _selected(params, slice_axes, idxs):
    """The raw forms' slice of each affected core (axes removed, higher
    axes first so the positions stay valid)."""
    out = dict(params)
    for name, axes in slice_axes.items():
        arr = out[name]
        for b_i, axis in sorted(axes, key=lambda t: -t[1]):
            arr = arr.select(axis, idxs[b_i])
        out[name] = arr
    return out


def make_sliced_siamese_fn(
    graph: CircuitGraph,
    mesh: Mesh,
    bonds: Optional[Sequence[BondKey]] = None,
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
    states_batched: bool = False,
    measure_extra_dims: int = 1,
):
    """Siamese contraction with sliced ket-side bonds shared out over
    ``model_axis``: ``fn(params, states, measures) -> raw siamese values``,
    as ``ops.contract.make_siamese_fn``'s.  Differentiable.  ``data_axis``
    is JAX's batch axis: one process contracts the whole batch; in the rank
    form each rank contracts its rows of the measures' leading axis and
    the rows are gathered over its ``data_axis`` line.  ``fn`` returns
    the whole batch either way."""
    n_model = mesh.shape[model_axis]
    if bonds is None:
        bonds = choose_slice_bonds(graph, n_model)
    spec, slice_axes, ranks = siamese_spec_sliced(
        graph, tuple(bonds), True, states_batched, measure_extra_dims
    )
    total = int(np.prod(ranks)) if ranks else 1
    split = data_axis is not None and mesh.shape.get(data_axis, 1) > 1
    positions = _Positions(mesh, model_axis, total, (data_axis,) if split else ())
    rows = data_sharding(mesh, data_axis) if split else None

    def partial(params, states, measures, idx):
        # ket-side cores are sliced; the bra (conjugate) side keeps the full
        # tensors: only the ket bond is summed explicitly
        p = _selected(params, slice_axes, _bond_indices(idx, ranks))
        ops = []
        for kind, key in spec.operands:
            if kind == "core":
                ops.append(p[key])
            elif kind == "core_conj":
                ops.append(torch.conj(params[key]))
            elif kind == "state":
                ops.append(states[key])
            elif kind == "state_conj":
                ops.append(torch.conj(states[key]))
            else:  # measure
                ops.append(measures[key])
        return execute(spec.equation, ops)

    def fn(params, states, measures):
        measures = list(measures)
        if rows is not None:
            measures = [rows.local(m) for m in measures]
        first = next(iter(params.values()))
        parts = []
        for pos in positions.positions:
            acc = torch.zeros(tuple(measures[0].shape[:measure_extra_dims]),
                              dtype=first.dtype, device=first.device)
            for idx in positions.slices(pos):
                acc = acc + partial(params, states, measures, idx)
            parts.append(acc)
        out = positions.sum(parts)
        if rows is not None and positions.ranks:
            out = gather_rows(out, mesh.line((data_axis,)))
        return out

    return _finish(fn, positions)


def make_sliced_two_network_fn(
    graph1: CircuitGraph,
    graph2: CircuitGraph,
    mesh: Mesh,
    bonds: Optional[Sequence[BondKey]] = None,
    model_axis: str = "model",
    conj_target: bool = True,
):
    """Two-network overlap with sliced ``graph1`` bonds shared out over
    ``model_axis``: ``fn(params1, params2) -> scalar``, as
    ``ops.contract.make_two_network_fn``'s.  Raw values: they under- and
    overflow float32 beyond ~24 qubits (see
    :func:`make_sliced_log_overlap_fn`).  Differentiable."""
    n_model = mesh.shape[model_axis]
    if bonds is None:
        bonds = choose_slice_bonds(graph1, n_model)
    spec, slice_axes, ranks = two_network_spec_sliced(graph1, graph2, tuple(bonds))
    total = int(np.prod(ranks)) if ranks else 1
    positions = _Positions(mesh, model_axis, total)

    def fn(params1, params2):
        p2 = {k: torch.conj(v) for k, v in params2.items()} if conj_target else params2
        first = next(iter(params1.values()))
        parts = []
        for pos in positions.positions:
            acc = torch.zeros((), dtype=first.dtype, device=first.device)
            for idx in positions.slices(pos):
                p1 = _selected(params1, slice_axes, _bond_indices(idx, ranks))
                ops = [p1[key] if kind == "core" else p2[key] for kind, key in spec.operands]
                acc = acc + execute(spec.equation, ops)
            parts.append(acc)
        return positions.sum(parts)

    return _finish(fn, positions)


def make_sliced_log_overlap_fn(
    graph: CircuitGraph,
    mesh: Mesh,
    bonds: Optional[Sequence[BondKey]] = None,
    model_axis: str = "model",
    pair: bool = False,
):
    """``fn(params_a, params_b) -> log|⟨A, B⟩|``, bond-sliced over
    ``model_axis`` and float32-safe at any qubit count: the multi-device
    path of the 30+-qubit network-fidelity fit.

    Each slice partial comes from a rescaled executor in ``(mantissa,
    log_scale)`` form: the row sweep of ``graph_sliced`` against ``graph``
    where ``supports_row_scan`` holds, the rescaled pairwise executor
    otherwise, its pair twin with ``pair=True`` (params are stacked-real
    pairs ``[2, *shape]``).  Only the A side is sliced, so one ``fn``
    serves ⟨p,t⟩ and ⟨p,p⟩.  The log-scales are detached throughout, so the
    gradient of the LOG overlap is exact.
    """
    n_model = mesh.shape[model_axis]
    if bonds is None:
        bonds = choose_slice_bonds(graph, n_model, prefer_early_rows=True)
    bonds = tuple(bonds)
    ranks = []
    slice_axes: Dict[str, list] = {}
    for b_i, (i, j, q) in enumerate(bonds):
        edge = next(e for e in graph.cores[i].in_edges + graph.cores[i].out_edges
                    if e.qubit == q and e.neighbor == j)
        ranks.append(edge.rank)
        for ci, other in ((i, j), (j, i)):
            core = graph.cores[ci]
            edges = core.in_edges + core.out_edges
            axis = next(k for k, e in enumerate(edges) if e.qubit == q and e.neighbor == other)
            slice_axes.setdefault(core.name, []).append((b_i, axis))
    total = int(np.prod(ranks)) if ranks else 1
    positions = _Positions(mesh, model_axis, total)

    graph_sliced = with_bond_ranks(graph, {b: 1 for b in bonds})
    if pair:
        overlap_slice = make_pair_log_abs_two_network_fn(graph_sliced, graph, signed=True)
    elif supports_row_scan(graph_sliced, graph):
        overlap_slice = make_row_scan_log_overlap_fn(graph_sliced, graph_b=graph, signed=True)
    else:
        overlap_slice = make_log_abs_two_network_fn(graph_sliced, graph, signed=True)
    axis_off = 1 if pair else 0  # pair tensors carry a leading [2] axis

    def slice_params(params, idx):
        # size-1 slices: positions stay valid in any order, shapes match
        # graph_sliced
        idxs = _bond_indices(idx, ranks)
        out = dict(params)
        for name, axes in slice_axes.items():
            arr = out[name]
            for b_i, axis in axes:
                arr = arr.narrow(axis + axis_off, idxs[b_i], 1)
            out[name] = arr
        return out

    def fn(params_a, params_b):
        first = next(iter(params_a.values()))
        parts = []
        for pos in positions.positions:
            # an empty share (the padded tail) stays (0, _NEG), which the
            # combine adds as zero
            m = torch.zeros((2,) if pair else (), dtype=first.dtype, device=first.device)
            l = torch.full((), _NEG, dtype=first.real.dtype, device=first.device)
            for idx in positions.slices(pos):
                ms, ls = overlap_slice(slice_params(params_a, idx), params_b)
                # running max-normalised sum: m·e^l stays |m| ~ O(1) however
                # the slice scales differ
                hi = torch.maximum(l, ls)
                m = m * torch.exp(l - hi) + ms * torch.exp(ls - hi)
                l = hi
            parts.append((m, l))
        gmax, m_tot = positions.log_sum(parts)
        if pair:
            return gmax + 0.5 * torch.log(pair_abs2(m_tot) + _TINY)
        return gmax + torch.log(torch.abs(m_tot) + _TINY)

    return _finish(fn, positions)


def sliced_nll_loss(
    graph: CircuitGraph,
    mesh: Mesh,
    params,
    states,
    measures,
    bonds: Optional[Sequence[BondKey]] = None,
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
) -> torch.Tensor:
    """NLL of Born probabilities through the sliced contraction."""
    fn = make_sliced_siamese_fn(graph, mesh, bonds, model_axis, data_axis)
    raw = fn(params, states, measures)
    return nll_loss(abs_square(raw) if raw.is_complex() else raw)
