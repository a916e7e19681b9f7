"""MPS-chain topology check.  Counterpart of ``tneq_tpu/ops/mps_sweep.py``
(``is_mps_chain``); the siamese transfer sweep (kernels B3/B4) waits for the
Born-rule slice."""

from __future__ import annotations

from ..graph.dsl import CircuitGraph

__all__ = ["is_mps_chain"]


def is_mps_chain(graph: CircuitGraph) -> bool:
    """True when core i sits exactly on qubits (i, i+1) in a chain."""
    m = graph.ncores
    if m != graph.nqubits - 1 or m < 1:
        return False
    for i, core in enumerate(graph.cores):
        qubits = sorted(
            {e.qubit for e in core.in_edges} | {e.qubit for e in core.out_edges}
        )
        if qubits != [i, i + 1]:
            return False
        for e in core.in_edges:
            if e.neighbor not in (-1, i - 1):
                return False
        for e in core.out_edges:
            if e.neighbor not in (-1, i + 1):
                return False
    return True
