"""Einsum specification builders: CircuitGraph -> static einsum equations.

The port's copy of ``tneq_tpu/ops/einsum_spec.py`` (pure Python, the same
equations symbol for symbol, held by ``tests/test_torch_einsum_spec.py``).
This is the single place contraction topology is turned into equations;
``ops/contract.py`` executes them as explicit pairwise steps along the
native path.  Past 52 symbols ``get_symbol`` leaves the latin letters, so
the executor re-letters each pairwise step before ``torch.einsum``.  The
``_sliced`` builders serve the parallel layer (ROADMAP A, item 11).

Symbol scheme for the siamese ⟨ψ|M|ψ⟩ network (reference semantics:
``einsum_strategy.py:418-620``, with its operand/qubit-order mismatches
fixed — states and measurement operators here bind to their qubit index):

- per qubit q: ``s_in[q]``/``s_out[q]`` (ket-side boundary), mirrored
  ``t_in[q]``/``t_out[q]`` (bra side)
- per internal bond: one ket symbol + one mirrored bra symbol
- measurement operator on qubit q carries ``batch + s_out[q] + t_out[q]``
- output is the batch symbol(s)

The bra-side cores are fed conjugated by the compute layer (Born rule),
matching the runtime GreedyStrategy path (``greedy_strategy.py:676-680``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

from ..graph.dsl import CircuitGraph, get_symbol

__all__ = [
    "EinsumSpec",
    "core_only_spec",
    "siamese_spec",
    "two_network_spec",
    "with_inputs_spec",
]


@dataclass(frozen=True)
class EinsumSpec:
    """A fully-resolved einsum contraction plan.

    ``equation`` is the einsum string; ``operands`` names each operand slot in
    order, as tuples ``(kind, key)`` with kind in
    {'core', 'core_conj', 'state', 'state_conj', 'measure', 'target_core'}
    and key the core name or qubit index.
    """

    equation: str
    operands: Tuple[Tuple[str, object], ...]
    output_shape_hint: Tuple[object, ...] = ()

    @property
    def n_operands(self) -> int:
        return len(self.operands)


class _Symbols:
    def __init__(self):
        self.n = 0

    def next(self) -> str:
        s = get_symbol(self.n)
        self.n += 1
        return s


def _bond_symbols(graph: CircuitGraph, sym: _Symbols) -> Dict[Tuple[int, int, int], str]:
    """Assign one symbol per internal bond, keyed (min_core, max_core, qubit).

    Matches the reference's edge_symbol_map keying
    (``einsum_strategy.py:165-183``): a repeated contact of the same core
    pair on the same qubit shares one index.
    """
    bonds: Dict[Tuple[int, int, int], str] = {}
    for core in graph.cores:
        for e in core.out_edges:
            if e.neighbor >= 0:
                key = (min(core.index, e.neighbor), max(core.index, e.neighbor), e.qubit)
                if key not in bonds:
                    bonds[key] = sym.next()
    return bonds


def _core_subscript(
    graph: CircuitGraph,
    core_idx: int,
    bonds: Dict[Tuple[int, int, int], str],
    s_in: Dict[int, str],
    s_out: Dict[int, str],
) -> str:
    """Subscript for one core: in-edge symbols then out-edge symbols."""
    core = graph.cores[core_idx]
    sub = ""
    for e in core.in_edges:
        if e.neighbor == -1:
            sub += s_in[e.qubit]
        else:
            sub += bonds[(min(core_idx, e.neighbor), max(core_idx, e.neighbor), e.qubit)]
    for e in core.out_edges:
        if e.neighbor == -1:
            sub += s_out[e.qubit]
        else:
            sub += bonds[(min(core_idx, e.neighbor), max(core_idx, e.neighbor), e.qubit)]
    return sub


def _boundary_symbols(
    graph: CircuitGraph, sym: _Symbols, order: str = "reference"
) -> Tuple[Dict[int, str], Dict[int, str], List[str]]:
    """Allocate boundary symbols.

    order='reference': symbols allocated (and the boundary output list built)
    in core-iteration order, in-edges before out-edges per core — the exact
    dense-tensor axis order of ``build_core_only_expression``
    (``einsum_strategy.py:137-194``), so target tensors are interchangeable
    with the reference.  order='qubit': inputs by qubit then outputs by qubit.
    """
    s_in: Dict[int, str] = {}
    s_out: Dict[int, str] = {}
    boundary: List[str] = []
    if order == "reference":
        for core in graph.cores:
            for e in core.in_edges:
                if e.neighbor == -1:
                    s_in[e.qubit] = sym.next()
                    boundary.append(s_in[e.qubit])
            for e in core.out_edges:
                if e.neighbor == -1:
                    s_out[e.qubit] = sym.next()
                    boundary.append(s_out[e.qubit])
    elif order == "qubit":
        for q in range(graph.nqubits):
            s_in[q] = sym.next()
        for q in range(graph.nqubits):
            s_out[q] = sym.next()
        boundary = [s_in[q] for q in range(graph.nqubits)] + [
            s_out[q] for q in range(graph.nqubits)
        ]
    else:
        raise ValueError(f"unknown boundary order {order!r}")
    return s_in, s_out, boundary


@lru_cache(maxsize=256)
def core_only_spec(graph: CircuitGraph, order: str = "reference") -> EinsumSpec:
    """Contract all cores, boundary legs open -> dense circuit tensor."""
    sym = _Symbols()
    s_in, s_out, boundary = _boundary_symbols(graph, sym, order)
    bonds = _bond_symbols(graph, sym)
    subs = [
        _core_subscript(graph, i, bonds, s_in, s_out) for i in range(graph.ncores)
    ]
    eq = ",".join(subs) + "->" + "".join(boundary)
    ops = tuple(("core", c.name) for c in graph.cores)
    return EinsumSpec(eq, ops)


@lru_cache(maxsize=256)
def with_inputs_spec(graph: CircuitGraph, batched: bool = True) -> EinsumSpec:
    """Apply the circuit to per-qubit input vectors -> output-boundary tensor.

    Operands: per-qubit state vectors (``(B, rank)`` if batched else
    ``(rank,)``) followed by the cores.  Output: batch + output legs in qubit
    order.  (Reference: ``build_with_vector_inputs_expression``,
    ``einsum_strategy.py:258-318``.)
    """
    sym = _Symbols()
    batch = sym.next() if batched else ""
    s_in, s_out, _ = _boundary_symbols(graph, sym, "qubit")
    bonds = _bond_symbols(graph, sym)
    subs = [batch + s_in[q] for q in range(graph.nqubits)]
    subs += [_core_subscript(graph, i, bonds, s_in, s_out) for i in range(graph.ncores)]
    out = batch + "".join(s_out[q] for q in range(graph.nqubits))
    ops = tuple(("state", q) for q in range(graph.nqubits)) + tuple(
        ("core", c.name) for c in graph.cores
    )
    return EinsumSpec(",".join(subs) + "->" + out, ops)


@lru_cache(maxsize=256)
def _siamese_build(
    graph: CircuitGraph,
    with_states: bool,
    states_batched: bool,
    measure_extra_dims: int,
) -> Tuple[EinsumSpec, Tuple[Tuple[Tuple[int, int, int], str], ...]]:
    """Build the siamese spec AND its ket-side bond-symbol map.

    Single source of truth for the symbol allocation: both
    :func:`siamese_spec` and :func:`siamese_spec_sliced` read from here, so
    the sliced builder can never drift from the base allocation (VERDICT r1
    weak #3).
    """
    sym = _Symbols()
    batch_syms = "".join(sym.next() for _ in range(measure_extra_dims))
    state_batch = batch_syms[:1] if (states_batched and batch_syms) else ""

    s_in, s_out, _ = _boundary_symbols(graph, sym, "qubit")
    t_in = {q: sym.next() for q in range(graph.nqubits)}
    t_out = {q: sym.next() for q in range(graph.nqubits)}
    bonds = _bond_symbols(graph, sym)
    mirror_bonds = {k: sym.next() for k in bonds}

    subs: List[str] = []
    ops: List[Tuple[str, object]] = []

    if with_states:
        for q in range(graph.nqubits):
            subs.append(state_batch + s_in[q])
            ops.append(("state", q))

    for i in range(graph.ncores):
        subs.append(_core_subscript(graph, i, bonds, s_in, s_out))
        ops.append(("core", graph.cores[i].name))

    for q in range(graph.nqubits):
        subs.append(batch_syms + s_out[q] + t_out[q])
        ops.append(("measure", q))

    for i in reversed(range(graph.ncores)):
        subs.append(_core_subscript(graph, i, mirror_bonds, t_in, t_out))
        ops.append(("core_conj", graph.cores[i].name))

    if with_states:
        for q in range(graph.nqubits):
            subs.append(state_batch + t_in[q])
            ops.append(("state_conj", q))

    eq = ",".join(subs) + "->" + batch_syms
    return EinsumSpec(eq, tuple(ops)), tuple(bonds.items())


def siamese_spec(
    graph: CircuitGraph,
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
) -> EinsumSpec:
    """⟨ψ|M|ψ⟩ Born-rule network: cores, measurement operators, conj cores.

    measure_extra_dims: number of leading batch-like axes on each per-qubit
    measurement operator (1 for ``(B, K, K)``, 2 for the stacked conditional
    ``(B, 2, K, K)`` trick, 0 for unbatched ``(K, K)``).  The result keeps
    those axes.  (Reference: ``build_with_self_expression``,
    ``einsum_strategy.py:418-620``; conditional stacking
    ``engine_siamese.py:689-719``.)
    """
    return _siamese_build(
        graph, with_states, states_batched, measure_extra_dims
    )[0]


def siamese_bond_symbols(
    graph: CircuitGraph,
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
) -> Dict[Tuple[int, int, int], str]:
    """Ket-side bond symbol per bond key, from the SAME allocation as
    :func:`siamese_spec` (shared build, not a replay)."""
    return dict(
        _siamese_build(graph, with_states, states_batched, measure_extra_dims)[1]
    )


@lru_cache(maxsize=256)
def siamese_env_spec(
    graph: CircuitGraph,
    open_qubit: int,
    with_states: bool = True,
    states_batched: bool = False,
) -> EinsumSpec:
    """Siamese network with ONE qubit's measurement slot left open.

    Identical to :func:`siamese_spec` (measure_extra_dims=1) except the
    measurement operand for ``open_qubit`` is omitted and its ket/bra output
    legs appear in the result: output = ``batch + s_out[q] + t_out[q]``.

    Contracting this once gives the per-sample environment ``E[b, k, l]``;
    the density at ANY measurement operator M on that qubit is then the tiny
    inner product ``E[b,k,l]·M[k,l]`` — this is what makes grid-based
    inverse-CDF sampling scale (the reference instead re-contracts the whole
    network for every grid point as an S·G batch,
    ``engine_siamese.py:799-847``).
    """
    if not 0 <= open_qubit < graph.nqubits:
        raise ValueError(f"open_qubit {open_qubit} out of range")
    sym = _Symbols()
    batch = sym.next()
    state_batch = batch if states_batched else ""

    s_in, s_out, _ = _boundary_symbols(graph, sym, "qubit")
    t_in = {q: sym.next() for q in range(graph.nqubits)}
    t_out = {q: sym.next() for q in range(graph.nqubits)}
    bonds = _bond_symbols(graph, sym)
    mirror_bonds = {k: sym.next() for k in bonds}

    subs: List[str] = []
    ops: List[Tuple[str, object]] = []

    if with_states:
        for q in range(graph.nqubits):
            subs.append(state_batch + s_in[q])
            ops.append(("state", q))

    for i in range(graph.ncores):
        subs.append(_core_subscript(graph, i, bonds, s_in, s_out))
        ops.append(("core", graph.cores[i].name))

    for q in range(graph.nqubits):
        if q == open_qubit:
            continue
        subs.append(batch + s_out[q] + t_out[q])
        ops.append(("measure", q))

    for i in reversed(range(graph.ncores)):
        subs.append(_core_subscript(graph, i, mirror_bonds, t_in, t_out))
        ops.append(("core_conj", graph.cores[i].name))

    if with_states:
        for q in range(graph.nqubits):
            subs.append(state_batch + t_in[q])
            ops.append(("state_conj", q))

    # the batch symbol only exists in the inputs via measure operands (or
    # batched states); with one qubit open on a 1-qubit circuit there are
    # none, and the environment is unbatched
    has_batch = states_batched or graph.nqubits > 1
    out = (batch if has_batch else "") + s_out[open_qubit] + t_out[open_qubit]
    return EinsumSpec(",".join(subs) + "->" + out, tuple(ops))


def siamese_spec_sliced(
    graph: CircuitGraph,
    sliced_bonds: Tuple[Tuple[int, int, int], ...],
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
):
    """Siamese spec with chosen ket-side bonds turned into explicit slices.

    ``sliced_bonds``: bond keys ``(min_core, max_core, qubit)``.  The returned
    spec has those bond symbols REMOVED from the two cores sharing each bond;
    contracting it for one combination of slice indices (after slicing those
    cores' axes) yields a partial value, and summing over all combinations
    reproduces the full siamese value.  Also returns
    ``{core_name: ((bond_pos, axis), ...)}`` — which axis of which core to
    slice for each bond (axis positions refer to the UNSLICED tensor).

    This is the index-sliced contraction at the heart of the reference's
    tensor-parallel reduce stage (``distributed_engine.py:1384-1499``), recast
    so the slice axis can be sharded over devices and the partials
    summed.
    """
    base, bond_items = _siamese_build(
        graph, with_states, states_batched, measure_extra_dims
    )
    subs_str, out = base.equation.split("->")
    subs = subs_str.split(",")
    bonds = dict(bond_items)

    slice_axes: Dict[str, list] = {}
    for b_i, key in enumerate(sliced_bonds):
        if key not in bonds:
            raise ValueError(f"{key} is not an internal bond of the graph")
        symbol = bonds[key]
        for op_i, (kind, name) in enumerate(base.operands):
            if kind != "core":
                continue
            sub = subs[op_i]
            count = sub.count(symbol)
            if count == 0:
                continue
            if count > 1:
                raise ValueError(
                    f"core {name!r} touches bond {key} more than once; "
                    f"slicing is ambiguous"
                )
            axis = sub.index(symbol)
            slice_axes.setdefault(name, []).append((b_i, axis))
            subs[op_i] = sub.replace(symbol, "")
    spec = EinsumSpec(",".join(subs) + "->" + out, base.operands)
    ranks = tuple(
        next(
            e.rank
            for e in graph.cores[k[0]].out_edges + graph.cores[k[0]].in_edges
            if e.qubit == k[2] and e.neighbor == k[1]
        )
        for k in sliced_bonds
    )
    slice_axes_t = {n: tuple(v) for n, v in slice_axes.items()}
    return spec, slice_axes_t, ranks


def two_network_spec_sliced(
    graph1: CircuitGraph,
    graph2: CircuitGraph,
    sliced_bonds: Tuple[Tuple[int, int, int], ...],
):
    """Two-network overlap spec with chosen graph1 bonds turned into slices.

    Same mechanics as :func:`siamese_spec_sliced` (see there): the returned
    spec drops the sliced bond symbols from graph1's two incident cores, and
    summing the contraction over all slice-index combinations reproduces the
    full overlap.  Returns ``(spec, slice_axes, ranks)``.
    """
    base, bond_items = _two_network_build(graph1, graph2)
    subs_str, out = base.equation.split("->")
    subs = subs_str.split(",")
    bonds = dict(bond_items)

    slice_axes: Dict[str, list] = {}
    for b_i, key in enumerate(sliced_bonds):
        if key not in bonds:
            raise ValueError(f"{key} is not an internal bond of graph1")
        symbol = bonds[key]
        for op_i, (kind, name) in enumerate(base.operands):
            if kind != "core":
                continue
            sub = subs[op_i]
            count = sub.count(symbol)
            if count == 0:
                continue
            if count > 1:
                raise ValueError(
                    f"core {name!r} touches bond {key} more than once"
                )
            slice_axes.setdefault(name, []).append((b_i, sub.index(symbol)))
            subs[op_i] = sub.replace(symbol, "")
    spec = EinsumSpec(",".join(subs) + "->" + out, base.operands)
    ranks = tuple(
        next(
            e.rank
            for e in graph1.cores[k[0]].out_edges + graph1.cores[k[0]].in_edges
            if e.qubit == k[2] and e.neighbor == k[1]
        )
        for k in sliced_bonds
    )
    return spec, {n: tuple(v) for n, v in slice_axes.items()}, ranks


@lru_cache(maxsize=256)
def _two_network_build(
    graph1: CircuitGraph, graph2: CircuitGraph
) -> Tuple[EinsumSpec, Tuple[Tuple[Tuple[int, int, int], str], ...]]:
    """Two-network spec AND graph1's bond-symbol map (shared allocation;
    see :func:`_siamese_build`)."""
    if graph1.nqubits != graph2.nqubits:
        raise ValueError("networks must have the same number of qubits")
    if (
        graph1.input_ranks != graph2.input_ranks
        or graph1.output_ranks != graph2.output_ranks
    ):
        raise ValueError("boundary ranks must match to glue the two networks")
    sym = _Symbols()
    s_in = {q: sym.next() for q in range(graph1.nqubits)}
    s_out = {q: sym.next() for q in range(graph1.nqubits)}
    bonds1 = _bond_symbols(graph1, sym)
    bonds2 = _bond_symbols(graph2, sym)
    subs = [
        _core_subscript(graph1, i, bonds1, s_in, s_out) for i in range(graph1.ncores)
    ]
    subs += [
        _core_subscript(graph2, i, bonds2, s_in, s_out) for i in range(graph2.ncores)
    ]
    ops = tuple(("core", c.name) for c in graph1.cores) + tuple(
        ("target_core", c.name) for c in graph2.cores
    )
    return EinsumSpec(",".join(subs) + "->", ops), tuple(bonds1.items())


def two_network_spec(graph1: CircuitGraph, graph2: CircuitGraph) -> EinsumSpec:
    """⟨network2 | network1⟩: glue input↔input and output↔output -> scalar.

    Both circuits must share boundary ranks per qubit.  The second network's
    cores are fed conjugated (fidelity overlap); for the reference's
    unconjugated variant (``build_with_qctn_expression``,
    ``einsum_strategy.py:320-416``) pass real tensors.
    """
    return _two_network_build(graph1, graph2)[0]
