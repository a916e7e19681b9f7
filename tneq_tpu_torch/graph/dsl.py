"""Graph DSL parser: ASCII circuit diagram -> immutable CircuitGraph.

The PyTorch port's own copy of ``tneq_tpu/graph/dsl.py`` (pure Python, same
semantics): importing ``tneq_tpu.graph`` would import JAX through the
package's ``__init__``, so the port keeps this copy.

The DSL (same language as the reference, ``tneq_qc/core/qctn.py:456-480``):
rows are qubit world-lines, letters are core tensors, digits are bond
dimensions, dashes are spacing.  Example::

    -2-A-2-
    -2-A-2-B-2-
    -2-----B-2-

Each qubit line reads left-to-right: ``-<in_rank>-<core>...<core>-<out_rank>-``
with ``<core><rank><core>`` runs describing inter-core bonds along that qubit.

Unlike the reference's ``QCTN`` (mutable object that re-parses with regexes
and caches compiled expressions as attributes,
``qctn.py:591-722`` / ``engine_siamese.py:300``), the parse result here is a
frozen, hashable value object.  Its ``signature`` is the jit-compilation
cache key for every contraction built from it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Tuple

__all__ = ["Edge", "CoreSpec", "CircuitGraph", "parse_graph", "get_symbol"]

_SYMBOLS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def get_symbol(i: int) -> str:
    """i-th einsum symbol: latin letters first, then unicode (opt_einsum order).

    Matches ``opt_einsum.get_symbol`` so that core-name ordering is identical
    to the reference (``qctn.py:497-506``).
    """
    if i < 52:
        return _SYMBOLS[i]
    return chr(i + 140)


_SYMBOL_INDEX: Dict[str, int] = {get_symbol(i): i for i in range(4096)}


def symbol_index(c: str) -> int:
    idx = _SYMBOL_INDEX.get(c)
    if idx is not None:
        return idx
    return ord(c) - 140


@dataclass(frozen=True)
class Edge:
    """One tensor index of a core.

    ``neighbor`` is the index of the core on the other end of the bond, or
    ``-1`` for a circuit boundary (input or output) leg.  ``qubit`` is the
    qubit world-line the bond lives on, ``rank`` its dimension.
    (Reference edge dicts: ``qctn.py:644-686``.)
    """

    qubit: int
    rank: int
    neighbor: int = -1

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"edge rank must be >= 1, got {self.rank}")


@dataclass(frozen=True)
class CoreSpec:
    """Static description of one core tensor.

    Tensor index convention (same as reference ``qctn.py:724-760``):
    ``in_edges`` (ascending qubit) then ``out_edges`` (ascending qubit), so the
    tensor shape is ``input_shape + output_shape``.
    """

    index: int
    name: str
    in_edges: Tuple[Edge, ...]
    out_edges: Tuple[Edge, ...]

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(e.rank for e in self.in_edges)

    @property
    def output_shape(self) -> Tuple[int, ...]:
        return tuple(e.rank for e in self.out_edges)

    @property
    def input_dim(self) -> int:
        d = 1
        for e in self.in_edges:
            d *= e.rank
        return d

    @property
    def output_dim(self) -> int:
        d = 1
        for e in self.out_edges:
            d *= e.rank
        return d

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.input_shape + self.output_shape


@dataclass(frozen=True)
class CircuitGraph:
    """Immutable parsed circuit: the contract every engine layer builds on.

    Attributes:
        nqubits: number of qubit world-lines.
        cores: per-core static specs, ordered by einsum-symbol index of the
            core name (reference ordering, ``qctn.py:504-506``).
        source: the original DSL string (display only; not part of equality).
    """

    nqubits: int
    cores: Tuple[CoreSpec, ...]
    source: str = field(default="", compare=False, repr=False)

    @property
    def ncores(self) -> int:
        return len(self.cores)

    @property
    def core_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.cores)

    @cached_property
    def name_to_index(self) -> Dict[str, int]:
        return {c.name: c.index for c in self.cores}

    @cached_property
    def signature(self) -> str:
        """Canonical hashable string: the jit-cache key for this topology."""
        parts = [f"q{self.nqubits}"]
        for c in self.cores:
            ins = ";".join(f"{e.qubit},{e.rank},{e.neighbor}" for e in c.in_edges)
            outs = ";".join(f"{e.qubit},{e.rank},{e.neighbor}" for e in c.out_edges)
            parts.append(f"{c.name}[{ins}|{outs}]")
        return "|".join(parts)

    def __hash__(self):
        return hash(self.signature)

    def __eq__(self, other):
        return isinstance(other, CircuitGraph) and self.signature == other.signature

    # -- convenience views ------------------------------------------------

    @cached_property
    def input_ranks(self) -> Tuple[int, ...]:
        """Circuit-input rank per qubit (ascending qubit order)."""
        ranks = {}
        for c in self.cores:
            for e in c.in_edges:
                if e.neighbor == -1:
                    ranks[e.qubit] = e.rank
        return tuple(ranks[q] for q in range(self.nqubits))

    @cached_property
    def output_ranks(self) -> Tuple[int, ...]:
        """Circuit-output rank per qubit (ascending qubit order)."""
        ranks = {}
        for c in self.cores:
            for e in c.out_edges:
                if e.neighbor == -1:
                    ranks[e.qubit] = e.rank
        return tuple(ranks[q] for q in range(self.nqubits))

    @cached_property
    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {c.name: c.shape for c in self.cores}

    def qubit_cores(self, qubit: int) -> List[str]:
        """Core names touching a qubit line, in left-to-right order."""
        order = []
        # Walk the chain on this qubit: start at the core with the circuit
        # input leg, follow out-edges.
        cur = None
        for c in self.cores:
            for e in c.in_edges:
                if e.qubit == qubit and e.neighbor == -1:
                    cur = c
        while cur is not None:
            order.append(cur.name)
            nxt = None
            for e in cur.out_edges:
                if e.qubit == qubit and e.neighbor >= 0:
                    nxt = self.cores[e.neighbor]
            cur = nxt
        return order


def _core_chars(graph: str) -> List[str]:
    """Distinct core symbols in the DSL string, sorted by symbol index.

    Any character that is a valid einsum symbol (letter / CJK extension) is a
    core name; digits, dashes and whitespace are structure.
    (Reference: ``qctn.py:497-506``.)
    """
    seen = set()
    for ch in graph:
        if ch in "-\n\r\t 0123456789":
            continue
        seen.add(ch)
    return sorted(seen, key=symbol_index)


def render_dsl(graph: CircuitGraph) -> str:
    """Synthesize a canonical DSL string from a CircuitGraph.

    Inverse of :func:`parse_graph` up to dash spacing:
    ``parse_graph(render_dsl(g)) == g``.  Useful for graphs constructed
    programmatically (no retained ``source``), e.g. before split/merge.
    """
    lines = []
    for q in range(graph.nqubits):
        chain = graph.qubit_cores(q)
        if not chain:
            raise ValueError(f"qubit {q} has no cores; graph is not renderable")
        first = graph.cores[graph.name_to_index[chain[0]]]
        in_rank = next(
            e.rank for e in first.in_edges if e.qubit == q and e.neighbor == -1
        )
        parts = [f"-{in_rank}-"]
        for i, name in enumerate(chain):
            core = graph.cores[graph.name_to_index[name]]
            parts.append(name)
            if i + 1 < len(chain):
                nxt = graph.name_to_index[chain[i + 1]]
                bond = next(
                    e.rank
                    for e in core.out_edges
                    if e.qubit == q and e.neighbor == nxt
                )
                parts.append(f"-{bond}-")
        last = graph.cores[graph.name_to_index[chain[-1]]]
        out_rank = next(
            e.rank for e in last.out_edges if e.qubit == q and e.neighbor == -1
        )
        parts.append(f"-{out_rank}-")
        lines.append("".join(parts))
    return "\n".join(lines)


def parse_graph(graph: str) -> CircuitGraph:
    """Parse a DSL string into a :class:`CircuitGraph`.

    Semantics identical to the reference parser ``qctn.py:591-722``:
    per qubit line, the leading ``<digits><core>`` is that core's circuit-input
    edge, the trailing ``<core><digits>`` its circuit-output edge, and each
    ``<core><digits><core>`` run a directed bond (out of the left core, into
    the right core).  Edge lists end up ordered by ascending qubit index
    because lines are scanned top to bottom.
    """
    lines = graph.strip().splitlines()
    nqubits = len(lines)
    names = _core_chars(graph)
    if not names:
        raise ValueError("graph contains no core symbols")
    name_to_idx = {n: i for i, n in enumerate(names)}

    in_edges: List[List[Edge]] = [[] for _ in names]
    out_edges: List[List[Edge]] = [[] for _ in names]

    cores_re = re.escape("".join(names))
    input_pat = re.compile(rf"^(\d+)([{cores_re}])")
    output_pat = re.compile(rf"([{cores_re}])(\d+)$")
    connect_pat = re.compile(rf"([{cores_re}])(\d+)(?=[{cores_re}])")

    for qubit, raw in enumerate(lines):
        line = raw.strip().replace("-", "")
        m_in = input_pat.match(line)
        m_out = output_pat.search(line)
        if m_in is None or m_out is None:
            raise ValueError(
                f"qubit line {qubit} is malformed (needs leading rank+core "
                f"and trailing core+rank): {raw!r}"
            )
        in_rank, in_core = m_in.groups()
        out_core, out_rank = m_out.groups()
        in_edges[name_to_idx[in_core]].append(Edge(qubit, int(in_rank), -1))
        out_edges[name_to_idx[out_core]].append(Edge(qubit, int(out_rank), -1))

        for m in connect_pat.finditer(line):
            end = m.end()
            if end >= len(line):
                break
            left, rank = m.groups()
            right = line[end]
            li, ri = name_to_idx[left], name_to_idx[right]
            out_edges[li].append(Edge(qubit, int(rank), ri))
            in_edges[ri].append(Edge(qubit, int(rank), li))

    cores = tuple(
        CoreSpec(i, names[i], tuple(in_edges[i]), tuple(out_edges[i]))
        for i in range(len(names))
    )
    return CircuitGraph(nqubits=nqubits, cores=cores, source=graph)
