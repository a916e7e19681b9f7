"""Graph surgery: split / merge of circuit DSL strings.

The port's own copy of ``tneq_tpu/graph/surgery.py`` (pure Python, same
semantics).

Functional equivalents of ``QCTN.split`` / ``QCTN.merge``
(``tneq_qc/core/qctn.py:1296-1523``), operating on DSL strings and returning
``(new_source, core_name_map)`` so the model layer can carry weights across.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .dsl import CircuitGraph, CoreSpec, Edge, get_symbol, parse_graph

__all__ = ["split_graph", "merge_graphs", "with_bond_ranks"]


def with_bond_ranks(
    graph: CircuitGraph, rank_map: Dict[Tuple[int, int, int], int]
) -> CircuitGraph:
    """Same topology with chosen internal bond ranks replaced.

    ``rank_map`` keys are ``(min_core_idx, max_core_idx, qubit)`` bond keys
    (the convention of ``parallel.mp.choose_slice_bonds``).  Used by the
    sliced multi-chip contraction: fixing a bond index per slice is a
    rank-1 version of the bond, so the per-slice network is this graph with
    those ranks set to 1 (reference analogue: the K-shard slice of the TP
    matmul, ``distributed_engine.py:1384-1435``).
    """

    def fix(core: CoreSpec, e: Edge) -> Edge:
        if e.neighbor >= 0:
            key = (
                min(core.index, e.neighbor),
                max(core.index, e.neighbor),
                e.qubit,
            )
            if key in rank_map:
                return Edge(e.qubit, int(rank_map[key]), e.neighbor)
        return e

    found = set()
    cores = []
    for c in graph.cores:
        for e in c.in_edges + c.out_edges:
            if e.neighbor >= 0:
                key = (min(c.index, e.neighbor), max(c.index, e.neighbor), e.qubit)
                if key in rank_map:
                    found.add(key)
        cores.append(
            CoreSpec(
                c.index,
                c.name,
                tuple(fix(c, e) for e in c.in_edges),
                tuple(fix(c, e) for e in c.out_edges),
            )
        )
    missing = set(rank_map) - found
    if missing:
        raise ValueError(f"not internal bonds of this graph: {sorted(missing)}")
    return CircuitGraph(graph.nqubits, tuple(cores))


def _tokenize(line: str) -> List[Tuple[str, object]]:
    """'-2-A-5-B-3-' -> [('dim',2),('core','A'),('dim',5),('core','B'),('dim',3)].

    Reference: ``qctn.py:1217-1250`` (``_parse_qubit_line``).
    """
    cleaned = line.strip().replace("-", "")
    out: List[Tuple[str, object]] = []
    i = 0
    while i < len(cleaned):
        if cleaned[i].isdigit():
            j = i
            while j < len(cleaned) and cleaned[j].isdigit():
                j += 1
            out.append(("dim", int(cleaned[i:j])))
            i = j
        else:
            out.append(("core", cleaned[i]))
            i += 1
    return out


def _untokenize(tokens: List[Tuple[str, object]]) -> str:
    return "-" + "-".join(str(v) for _, v in tokens) + "-"


def split_graph(source: str, split_idx: Optional[int] = None) -> Tuple[str, str]:
    """Split a circuit into left/right halves at core index ``split_idx``.

    Cores (in symbol order) ``[:split_idx]`` go left, the rest right.  A qubit
    line containing cores of both groups is cut at the boundary bond, which
    becomes the left group's output rank and the right group's input rank.
    Raises if the groups interleave on any line.
    (Reference semantics: ``qctn.py:1296-1401``.)
    """
    g = parse_graph(source)
    if split_idx is None:
        split_idx = g.ncores // 2
    if not 0 < split_idx < g.ncores:
        raise ValueError(f"split_idx must be in [1, {g.ncores - 1}], got {split_idx}")

    group1 = set(g.core_names[:split_idx])
    group2 = set(g.core_names[split_idx:])

    lines1, lines2 = [], []
    for qubit, raw in enumerate(source.strip().splitlines()):
        tokens = _tokenize(raw)
        core_pos = [(i, v) for i, (t, v) in enumerate(tokens) if t == "core"]
        p1 = [i for i, c in core_pos if c in group1]
        p2 = [i for i, c in core_pos if c in group2]
        if p1 and p2:
            if max(p1) >= min(p2):
                raise ValueError(
                    f"cannot split: groups interleave on qubit {qubit}"
                )
            lines1.append(_untokenize(tokens[: max(p1) + 2]))
            lines2.append(_untokenize(tokens[min(p2) - 1 :]))
        elif p1:
            lines1.append(_untokenize(tokens))
        elif p2:
            lines2.append(_untokenize(tokens))
    if not lines1 or not lines2:
        raise ValueError("split produced an empty group")
    return "\n".join(lines1), "\n".join(lines2)


def merge_graphs(
    source1: str, source2: str
) -> Tuple[str, Dict[str, str], Dict[str, str]]:
    """Left-right merge of two circuits into one DSL string.

    Qubit lines are concatenated horizontally; the shared boundary keeps the
    left circuit's output rank.  The shorter circuit is bottom-padded with
    boundary-only treatment (its lines pass through unchanged on extra
    qubits of the longer one).  Cores are renamed contiguously: left circuit
    cores first, then right circuit cores.

    Returns ``(merged_source, name_map_left, name_map_right)`` where the maps
    send old core names to new ones (for weight transfer).
    (Reference semantics: ``qctn.py:1403-1506``.)
    """
    g1, g2 = parse_graph(source1), parse_graph(source2)
    n1, n2 = g1.nqubits, g2.nqubits
    total = g1.ncores + g2.ncores
    new_syms = [get_symbol(i) for i in range(total)]
    map1 = {old: new_syms[i] for i, old in enumerate(g1.core_names)}
    map2 = {old: new_syms[g1.ncores + i] for i, old in enumerate(g2.core_names)}

    def remap(line: str, m: Dict[str, str]) -> str:
        return "".join(m.get(ch, ch) for ch in line)

    lines1 = [remap(l, map1) for l in source1.strip().splitlines()]
    lines2 = [remap(l, map2) for l in source2.strip().splitlines()]

    merged = []
    for q in range(max(n1, n2)):
        has1, has2 = q < n1, q < n2
        if has1 and has2:
            l1, l2 = lines1[q], lines2[q]
            m1 = re.search(r"-\d+-$", l1)
            m2 = re.match(r"^-\d+-", l2)
            # keep the left circuit's output rank as the shared bond
            merged.append(l1[: m1.start()] + m1.group() + l2[m2.end() :])
        elif has1:
            merged.append(lines1[q])
        else:
            merged.append(lines2[q])
    out = "\n".join(merged)
    parse_graph(out)  # validate
    return out, map1, map2
