"""Graph generators: MPS / tree / brick-wall circuits and incidence helpers.

The PyTorch port's own copy of ``tneq_tpu/graph/generators.py`` (pure
Python + numpy, same semantics).

Functional equivalents of ``QCTNHelper.generate_example_graph``
(``tneq_qc/core/qctn.py:34-447``) and the incidence-matrix utilities of the
symmetry-breaking experiment (``symmetry_breaking_quantum.py:15-125``).
Generators emit DSL strings consumable by :func:`tneq_tpu.graph.parse_graph`;
topology (not exact dash spacing) is what matters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .dsl import get_symbol

__all__ = [
    "mps_graph",
    "tree_graph",
    "wall_graph",
    "wall_graph_col",
    "random_graph",
    "example_graph",
    "build_brick_wall_incidence",
    "incidence_to_graph",
]


def _line(entries: Sequence[tuple], in_rank: int, out_rank: int) -> str:
    """Build one qubit line '-r-A-r-B-...-r-' from [(core, bond_after), ...].

    ``entries`` is the ordered list of cores on the line; ``bond_after`` is
    the rank between this core and the next (ignored for the last core).
    """
    parts = [f"-{in_rank}-"]
    for i, (core, bond) in enumerate(entries):
        parts.append(core)
        if i + 1 < len(entries):
            parts.append(f"-{bond}-")
    parts.append(f"-{out_rank}-")
    return "".join(parts)


def mps_graph(n: int, dim: int = 3, phys: int = None) -> str:
    """MPS chain over ``n`` qubits: core i couples qubits (i, i+1).

    Reference: ``qctn.py:43-70`` (``generate_mps_graph``) — there the
    circuit boundary ranks equal the bond dimension.  ``phys`` decouples
    them (boundary legs = ``phys``, internal bonds = ``dim``): the
    canonical physical-dim-``phys`` / bond-``dim`` MPS, whose cores are
    ``[dim, phys, phys, dim]`` — the shape the large-bond MXU-utilization
    sweeps need (a coupled boundary would grow cores as dim^4).
    """
    if n < 2:
        raise ValueError("mps_graph needs n >= 2 qubits")
    if phys is None:
        phys = dim
    lines = []
    for q in range(n):
        if q == 0:
            entries = [(get_symbol(0), 0)]
        elif q == n - 1:
            entries = [(get_symbol(n - 2), 0)]
        else:
            entries = [(get_symbol(q - 1), dim), (get_symbol(q), 0)]
        lines.append(_line(entries, phys, phys))
    return "\n".join(lines)


def tree_graph(n: int, dim: int = 3) -> str:
    """Binary-tree-like ladder over ``n`` qubits.

    Reference: ``qctn.py:72-134`` (``generate_tree_graph``): qubit q couples
    to its neighbors through a chain of cores meeting in the middle.
    """
    if n < 2:
        raise ValueError("tree_graph needs n >= 2 qubits")
    m = n // 2
    lines = []
    # Top half: qubit i holds cores (i, i-1) for 0 < i < m, qubit 0 holds core 0.
    for i in range(m):
        if i == 0:
            entries = [(get_symbol(0), 0)]
        else:
            entries = [(get_symbol(i), dim), (get_symbol(i - 1), 0)]
        lines.append(_line(entries, dim, dim))
    if n % 2 == 1:
        lines.append(_line([(get_symbol(m - 1), 0)], dim, dim))
    # Bottom half mirrors the top.
    for i in range(m, 2 * m):
        if i < 2 * m - 1:
            entries = [(get_symbol(i - 1), dim), (get_symbol(i), 0)]
        else:
            entries = [(get_symbol(i - 1), 0)]
        lines.append(_line(entries, dim, dim))
    return "\n".join(lines)


def wall_graph(n: int, layers: int = 4, dim: int = 3) -> str:
    """Brick-wall circuit: alternating even/odd two-qubit gates.

    Reference: ``qctn.py:232-278`` (``generate_wall_graph``).  Built via the
    incidence matrix to keep one canonical construction path.
    """
    inc = build_brick_wall_incidence(n, max(1, layers // 2), rank=dim)
    return incidence_to_graph(inc)


def wall_graph_col(n: int, layers: int = 4, dim: int = 3) -> str:
    """Column-ordered brick wall (reference ``qctn.py:136-230``)."""
    n_gates_even = n // 2
    n_gates_odd = (n - 1) // 2
    # core id for (layer, pair)
    core_of = {}
    idx = 0
    for layer in range(layers):
        npairs = n_gates_even if layer % 2 == 0 else n_gates_odd
        for p in range(npairs):
            core_of[(layer, p)] = get_symbol(idx)
            idx += 1
    rows: List[List[tuple]] = [[] for _ in range(n)]
    for layer in range(layers):
        if layer % 2 == 0:
            for p in range(n_gates_even):
                rows[2 * p].append((core_of[(layer, p)], dim))
                rows[2 * p + 1].append((core_of[(layer, p)], dim))
        else:
            for p in range(n_gates_odd):
                rows[2 * p + 1].append((core_of[(layer, p)], dim))
                rows[2 * p + 2].append((core_of[(layer, p)], dim))
    lines = []
    for q in range(n):
        entries = rows[q] if rows[q] else [(get_symbol(0), 0)]
        lines.append(_line(entries, dim, dim))
    return "\n".join(lines)


def random_graph(
    nqubits: int = 5,
    ncores: int = 3,
    rng: Optional[np.random.Generator] = None,
    min_rank: int = 2,
    max_rank: int = 9,
) -> str:
    """Random circuit: each qubit passes through a random subset of cores.

    Reference: ``qctn.py:434-447`` (``generate_random_example_graph``).
    Guarantees every qubit line has at least one core (the reference could
    emit invalid empty lines).
    """
    rng = rng or np.random.default_rng()
    symbols = [get_symbol(i) for i in range(ncores)]
    lines = []
    for _ in range(nqubits):
        entries = []
        for s in symbols:
            if rng.random() > 0.5:
                entries.append((s, int(rng.integers(min_rank, max_rank + 1))))
        if not entries:
            entries = [(symbols[int(rng.integers(0, ncores))], 0)]
        in_rank = int(rng.integers(min_rank, max_rank + 1))
        out_rank = int(rng.integers(min_rank, max_rank + 1))
        lines.append(_line(entries, in_rank, out_rank))
    return "\n".join(lines)


#: The reference's fixed 5-qubit example circuit
#: (``QCTNHelper.generate_example_graph(target=True)``, ``qctn.py:36-41``).
TARGET_EXAMPLE = (
    "-2-A-5-----C-3-----E-2-\n"
    "-2-----B----4------E-2-\n"
    "-2-A-4-B-7-C-2-D-4-E-2-\n"
    "-2-----B-6-----D-----2-\n"
    "-2-A-3-----C-8-D-----2-"
)


def triu_ndindex(n: int):
    """Upper-triangle index pairs (``QCTNHelper.triu_ndindex``, ``qctn.py:450``)."""
    for i in range(n):
        for j in range(i + 1, n):
            yield (i, j)


def example_graph(
    n: int = 16, graph_type: str = "mps", dim: int = 3, target: bool = False
) -> str:
    """Dispatcher matching ``QCTNHelper.generate_example_graph`` modes."""
    if target:
        return TARGET_EXAMPLE
    if graph_type == "mps":
        return mps_graph(n, dim)
    if graph_type == "tree":
        return tree_graph(n, dim)
    if graph_type == "wall":
        return wall_graph(n, 4, dim)
    if graph_type == "wall_col":
        return wall_graph_col(n, 4, dim)
    return mps_graph(n, dim)


# ---------------------------------------------------------------------------
# Incidence-matrix representation (symmetry-breaking experiment)
# ---------------------------------------------------------------------------


def build_brick_wall_incidence(n_qubits: int, n_cells: int, rank: int = 2) -> np.ndarray:
    """Incidence matrix of a brick-wall circuit.

    Rows = qubits, cols = cores; entry = bond rank (0 = core absent on that
    qubit).  Each cell contributes (n_qubits - 1) two-qubit cores: first the
    even bonds (0,1),(2,3),... then the odd bonds (1,2),(3,4),...
    (Reference: ``symmetry_breaking_quantum.py:107-125``.)
    """
    n_cores = (n_qubits - 1) * n_cells
    inc = np.zeros((n_qubits, n_cores), dtype=int)
    for cell in range(n_cells):
        base = cell * (n_qubits - 1)
        col = 0
        for q in range(0, n_qubits - 1, 2):
            inc[q, base + col] = rank
            inc[q + 1, base + col] = rank
            col += 1
        for q in range(1, n_qubits - 1, 2):
            inc[q, base + col] = rank
            inc[q + 1, base + col] = rank
            col += 1
    return inc


def incidence_to_graph(
    incidence: np.ndarray,
    core_symbols: Optional[Sequence[str]] = None,
    mask_list: Optional[Sequence[int]] = None,
    for_display: bool = False,
    mask_char: str = "#",
) -> str:
    """Incidence matrix -> DSL string (reference ``symmetry_breaking_quantum.py:15-102``).

    ``mask_list`` marks masked cores; with ``for_display=True`` they render as
    ``mask_char`` (diagram only), otherwise masking is the caller's business
    (typically by zeroing columns before the call).
    """
    if incidence.ndim != 2:
        raise ValueError("incidence must be 2D (n_qubits x n_cores)")
    if (incidence < 0).any():
        raise ValueError("incidence entries must be >= 0")
    n_qubits, n_cores = incidence.shape
    if core_symbols is None:
        core_symbols = [get_symbol(i) for i in range(n_cores)]
    if len(core_symbols) != n_cores:
        raise ValueError("core_symbols length must match n_cores")
    mask_set = set(mask_list or [])
    for m in mask_set:
        if not 0 <= m < n_cores:
            raise IndexError(f"mask index {m} out of range 0..{n_cores - 1}")

    def sym(c: int) -> str:
        if for_display and c in mask_set:
            return mask_char
        return core_symbols[c]

    lines = []
    for q in range(n_qubits):
        entries = [
            (sym(c), int(incidence[q, c]))
            for c in range(n_cores)
            if incidence[q, c] > 0
        ]
        if not entries:
            raise ValueError(f"qubit row {q} has no cores; graph would be invalid")
        line = f"-{entries[0][1]}-{entries[0][0]}"
        for core, dim in entries[1:]:
            line += f"-{dim}-{core}"
        line += f"-{entries[-1][1]}-"
        lines.append(line)
    return "\n".join(lines)
