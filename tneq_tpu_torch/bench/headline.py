"""The headline training program on the port.

The program of ``bench.py::_build_step_fn``: plain SGD (lr 1e-3) on
−``network_log_fidelity`` of a 32-qubit, bond-16 (physical rank 16) MPS
chain in float32, started from a perturbed copy of the target (target drawn
with ``init_params``, params = target + 0.01·noise).  The weights are drawn
on the host from a seed (numpy noise), so the same problem can be handed to
the card and to the host; each step is three chain overlaps forward
(three B1 launches on the card) and two backward (two B2 launches: the
target needs no gradient).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, parse_graph
from ..graph.generators import mps_graph
from ..model.qctn import init_params, params_to_numpy
from ..train.network_fit import network_log_fidelity

__all__ = ["N_QUBITS", "BOND_DIM", "LR", "build_problem", "sgd_step"]

N_QUBITS = 32
BOND_DIM = 16
LR = 1e-3


def build_problem(
    n_qubits: int = N_QUBITS, bond_dim: int = BOND_DIM, seed: int = 0
) -> Tuple[CircuitGraph, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``(graph, params, target)`` with numpy float32 weights."""
    graph = parse_graph(mps_graph(n_qubits, dim=bond_dim))
    target = params_to_numpy(init_params(graph, seed, torch.float32, device="cpu"))
    rng = np.random.default_rng(seed + 1)
    params = {
        n: (t + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        for n, t in sorted(target.items())
    }
    return graph, params, target


def sgd_step(graph: CircuitGraph, params, target, lr: float = LR):
    """One gradient step of −log F; returns ``(new params, loss before the
    step)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = -network_log_fidelity(graph, leaves, target)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: leaves[k].detach() - lr * g for k, g in zip(leaves, grads)}
    return new, loss.detach()
