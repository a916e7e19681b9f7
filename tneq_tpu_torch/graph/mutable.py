"""MutableGraph: edit-friendly circuit representation for structure search.

The port's own copy of ``tneq_tpu/graph/mutable.py`` (pure Python and
numpy, same semantics): every random choice takes the caller's
``np.random.Generator``, so a seeded run of mutations gives the same DSL in
both packages, step by step.

Equivalent of the reference's ``TNGraph`` (``tneq_qc/core/tn_graph.py``):
each qubit line is a list of ``(tensor_name, left_bond, right_bond)`` tuples;
bond 0 means "no connection" on that line.  The genetic search mutates this
representation (modify bond / remove tensor / insert tensor) and renders back
to the DSL consumed by :func:`tneq_tpu_torch.graph.parse_graph`.
"""

from __future__ import annotations

import string
from typing import List, Optional, Tuple

import numpy as np

from .dsl import parse_graph

__all__ = ["MutableGraph"]

Entry = Tuple[str, int, int]  # (tensor_name, left_bond, right_bond)


class MutableGraph:
    """Mutable per-qubit tensor chains with GA mutation primitives.

    Reference: ``tn_graph.py:36-55`` (representation), ``:399-687``
    (mutations).  Names are restricted to uppercase A-Z as in the reference's
    insertion logic (``tn_graph.py:585``).
    """

    def __init__(self, source: Optional[str] = None, n_qubits: int = 0):
        self.lines: List[List[Entry]] = [[] for _ in range(n_qubits)]
        if source:
            self._from_string(source)

    # -- construction -----------------------------------------------------

    def _from_string(self, source: str) -> None:
        raw_lines = [l.strip() for l in source.strip().splitlines() if l.strip()]
        self.lines = []
        for raw in raw_lines:
            entries: List[Entry] = []
            # tokenize: alternating digit-runs and single core chars
            cleaned = raw.replace("-", " ")
            tokens: List[Tuple[str, object]] = []
            i = 0
            while i < len(cleaned):
                ch = cleaned[i]
                if ch == " ":
                    i += 1
                elif ch.isdigit():
                    j = i
                    while j < len(cleaned) and cleaned[j].isdigit():
                        j += 1
                    tokens.append(("dim", int(cleaned[i:j])))
                    i = j
                else:
                    tokens.append(("core", ch))
                    i += 1
            # walk tokens: bond value applies to the gap it sits in; a gap
            # with no digits is bond 0 (no connection)
            pending_dim = 0
            last_core_idx = -1
            for t, v in tokens:
                if t == "dim":
                    pending_dim = int(v)
                else:
                    entries.append((str(v), pending_dim, 0))
                    if last_core_idx >= 0:
                        name, lb, _ = entries[last_core_idx]
                        entries[last_core_idx] = (name, lb, pending_dim)
                    last_core_idx = len(entries) - 1
                    pending_dim = 0
            if last_core_idx >= 0:
                name, lb, _ = entries[last_core_idx]
                entries[last_core_idx] = (name, lb, pending_dim)
            self.lines.append(entries)

    # -- views ------------------------------------------------------------

    @property
    def n_qubits(self) -> int:
        return len(self.lines)

    @property
    def tensor_names(self) -> List[str]:
        names = {name for line in self.lines for name, _, _ in line}
        return sorted(names)

    @property
    def n_tensors(self) -> int:
        return len(self.tensor_names)

    def tensor_qubits(self, name: str) -> List[int]:
        return [q for q, line in enumerate(self.lines) if any(n == name for n, _, _ in line)]

    def copy(self) -> "MutableGraph":
        g = MutableGraph(n_qubits=self.n_qubits)
        g.lines = [list(line) for line in self.lines]
        return g

    def to_dsl(self) -> str:
        """Render to the DSL; internal 0-bonds render as plain dashes (no
        connection).  Boundary ranks are preserved exactly as stored — the
        reference's ``TNGraph.to_string`` does the same
        (``tn_graph.py:176-286``); a 0 boundary rank is unrenderable and
        raises rather than silently inventing a rank."""
        out = []
        for q, line in enumerate(self.lines):
            if not line:
                raise ValueError("cannot render a qubit line with no tensors")
            if line[0][1] <= 0 or line[-1][2] <= 0:
                raise ValueError(
                    f"qubit {q} has an unset (0) boundary rank; boundary "
                    f"ranks must stay positive through mutations"
                )
            parts = [f"-{line[0][1]}-"]
            for i, (name, _lb, rb) in enumerate(line):
                parts.append(name)
                if i + 1 < len(line):
                    parts.append(f"-{rb}-" if rb > 0 else "-----")
            parts.append(f"-{line[-1][2]}-")
            out.append("".join(parts))
        src = "\n".join(out)
        parse_graph(src)  # validate round-trip
        return src

    def __str__(self) -> str:
        return self.to_dsl()

    # -- mutations (reference tn_graph.py:399-687) ------------------------

    def modify_bond(self, qubit: int, name: str, new_value: int) -> None:
        """Change the right bond of ``name`` on ``qubit`` (not the last core)."""
        line = self.lines[qubit]
        idx = next((i for i, (n, _, _) in enumerate(line) if n == name), None)
        if idx is None:
            raise ValueError(f"tensor {name} not on qubit {qubit}")
        if idx == len(line) - 1:
            raise ValueError(f"{name} is the last tensor on qubit {qubit}")
        n, lb, _ = line[idx]
        line[idx] = (n, lb, new_value)
        nn, _, nrb = line[idx + 1]
        line[idx + 1] = (nn, new_value, nrb)

    def remove_tensor_from_qubit(
        self, qubit: int, name: str, bond_mode: str = "min"
    ) -> None:
        """Remove ``name`` from ``qubit`` and reconnect neighbors.

        ``bond_mode`` in {'min','max','left','right'} picks the surviving bond
        for a middle removal; edge removals reuse the boundary rank
        (default 2 when the removed bond was 0).
        """
        line = self.lines[qubit]
        idx = next((i for i, (n, _, _) in enumerate(line) if n == name), None)
        if idx is None:
            raise ValueError(f"tensor {name} not on qubit {qubit}")
        if len(line) == 1:
            # an empty qubit line has no DSL rendering (and no physical
            # meaning in the siamese model) — the reference's remove allows
            # it and its search would crash on the next to_string; here the
            # GA's mutation-retry loop treats it as an invalid mutation
            raise ValueError("cannot remove the only tensor on a qubit line")
        _, lb, rb = line[idx]
        if idx == 0 and len(line) > 1:
            new_bond = lb if lb > 0 else 2
            nn, _, nrb = line[1]
            line[1] = (nn, new_bond, nrb)
        elif idx == len(line) - 1 and len(line) > 1:
            new_bond = rb if rb > 0 else 2
            pn, plb, _ = line[idx - 1]
            line[idx - 1] = (pn, plb, new_bond)
        elif 0 < idx < len(line) - 1:
            if bond_mode == "min":
                new_bond = min(lb, rb)
            elif bond_mode == "max":
                new_bond = max(lb, rb)
            elif bond_mode == "left":
                new_bond = lb
            elif bond_mode == "right":
                new_bond = rb
            else:
                raise ValueError(f"invalid bond_mode {bond_mode!r}")
            pn, plb, _ = line[idx - 1]
            nn, _, nrb = line[idx + 1]
            line[idx - 1] = (pn, plb, new_bond)
            line[idx + 1] = (nn, new_bond, nrb)
        line.pop(idx)

    def insert_tensor_after(
        self,
        qubit: int,
        name: str,
        insert_mode: str = "random",
        rng: Optional[np.random.Generator] = None,
    ) -> str:
        """Insert a new tensor right of ``name`` ('' = leftmost) on ``qubit``.

        The new name is chosen from unused uppercase letters that preserve
        alphabetical order between the neighbors (reference
        ``tn_graph.py:525-687``).  Returns the new tensor's name.
        """
        rng = rng or np.random.default_rng()

        def choose(avail: List[str]) -> str:
            if not avail:
                raise ValueError("no available tensor names")
            if insert_mode == "random":
                return str(rng.choice(avail))
            if insert_mode == "first":
                return avail[0]
            if insert_mode == "last":
                return avail[-1]
            if insert_mode == "middle":
                return avail[len(avail) // 2]
            raise ValueError(f"invalid insert_mode {insert_mode!r}")

        line = self.lines[qubit]
        line_names = [n for n, _, _ in line]
        max_tensors = min(self.n_tensors + 1, 26)
        letters = string.ascii_uppercase[:max_tensors]

        if name == "":
            if not line:
                new_name = choose(list(letters))
                line.append((new_name, 2, 2))
                return new_name
            first_name, first_lb, first_rb = line[0]
            avail = [l for l in letters if l < first_name and l not in line_names]
            new_name = choose(avail)
            edge = first_lb if first_lb > 0 else 2
            line.insert(0, (new_name, edge, edge))
            line[1] = (first_name, edge, first_rb)
            return new_name

        idx = next((i for i, (n, _, _) in enumerate(line) if n == name), None)
        if idx is None:
            raise ValueError(f"tensor {name} not on qubit {qubit}")
        cur_name, cur_lb, cur_rb = line[idx]
        if idx == len(line) - 1:
            avail = [l for l in letters if l > cur_name and l not in line_names]
            new_name = choose(avail)
            edge = cur_rb if cur_rb > 0 else 2
            line.append((new_name, edge, edge))
            line[idx] = (cur_name, cur_lb, edge)
            return new_name
        next_name = line[idx + 1][0]
        avail = [
            l for l in letters if cur_name < l < next_name and l not in line_names
        ]
        new_name = choose(avail)
        line.insert(idx + 1, (new_name, cur_rb, cur_rb))
        return new_name
