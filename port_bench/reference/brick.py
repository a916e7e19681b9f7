"""The brick-wall circuit's masked network fit, plainly.

The brick wall of ``n`` qubits and ``c`` cells is ``c·(n−1)`` two-qubit
gates: in each cell first the pairs (0,1), (2,3), … then (1,2), (3,4), ….
Gate ``i`` is named by the ``i``-th letter of ``a…zA…Z`` and has the axes
``[in q, in q+1, out q, out q+1]`` (in-legs then out-legs, by ascending
qubit), each of dimension ``rank`` (2: a gate on qubits).  The network is
the ``2ⁿ × 2ⁿ`` operator that applies the gates in order; a masked gate is
the identity: ``mask·gate + (1 − mask)·I``.

The fidelity of two networks is ``F = |⟨T,O⟩|² / (⟨O,O⟩⟨T,T⟩)`` with
``⟨A,B⟩ = Σ conj(A)·B`` over every entry of the dense operators; the fit
minimises ``−log F`` by SGD-G (``sgdg.py``) and its exit test reads
``1 − F`` before each step's update.  Lanes (a leading axis of the gates
and masks) are independent fits that share the optimizer's draws.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .sgdg import SGDG

__all__ = ["gate_names", "gate_pairs", "neg_log_fidelity", "fit"]

LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def gate_pairs(n_qubits: int, n_cells: int) -> List[int]:
    """The lower qubit of each gate, in gate order."""
    cell = list(range(0, n_qubits - 1, 2)) + list(range(1, n_qubits - 1, 2))
    return cell * n_cells


def gate_names(n_qubits: int, n_cells: int) -> List[str]:
    return [LETTERS[i] for i in range(len(gate_pairs(n_qubits, n_cells)))]


def operator(gates: torch.Tensor, pairs: List[int], n_qubits: int) -> torch.Tensor:
    """The dense operators ``[L, 2ⁿ, 2ⁿ]`` (inputs × outputs) of ``L``
    lanes' circuits; ``gates`` is ``[L, n_gates, 2, 2, 2, 2]``."""
    lanes = gates.shape[0]
    dim = 2 ** n_qubits
    x = torch.eye(dim, dtype=gates.dtype, device=gates.device).expand(lanes, dim, dim)
    for i, q in enumerate(pairs):
        g = gates[:, i].reshape(lanes, 4, 4)
        x = x.reshape(lanes, dim, 2 ** q, 4, 2 ** (n_qubits - q - 2))
        x = torch.einsum("lnacb,lcd->lnadb", x, g)
    return x.reshape(lanes, dim, dim)


def masked(gates: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``mask·gate + (1 − mask)·I`` for gates ``[L, n_gates, 2, 2, 2, 2]``
    and masks ``[L, n_gates]``."""
    eye = torch.eye(4, dtype=gates.dtype, device=gates.device).reshape(2, 2, 2, 2)
    m = masks.to(gates.dtype)[..., None, None, None, None]
    return m * gates + (1 - m) * eye


def neg_log_fidelity(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``−log F`` per lane of operators ``[L, N, N]`` against ``t``
    (``[L, N, N]`` or ``[N, N]``)."""
    ov = (t.conj() * o).sum(dim=(-2, -1))
    oo = (o.conj() * o).sum(dim=(-2, -1)).real
    tt = (t.conj() * t).sum(dim=(-2, -1)).real
    return -(2 * torch.log(ov.abs()) - torch.log(oo) - torch.log(tt))


def fit(gates: Dict[str, torch.Tensor], masks: torch.Tensor, target: torch.Tensor,
        n_qubits: int, n_cells: int, steps: int, lr: float, momentum: float,
        seed: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict[str, torch.Tensor]]:
    """``steps`` SGD-G steps of the lanes of ``gates`` (``{name: [L, 2, 2, 2,
    2]}``, one lane per row of ``masks`` ``[L, n_gates]``) towards the
    target operator ``target`` (``[N, N]``).  Returns the gates after the
    steps, ``−log F [steps, L]`` read before each update, and the norm of
    the first step's gradient per gate and lane (``{name: [L]}``)."""
    names = gate_names(n_qubits, n_cells)
    pairs = gate_pairs(n_qubits, n_cells)
    opt = SGDG(lr, momentum, seed, batch=1)
    params = {n: gates[n].clone() for n in names}
    nlfs, first_grad = [], None
    for _ in range(steps):
        leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
        stacked = torch.stack([leaves[n] for n in names], dim=1)
        o = operator(masked(stacked, masks), pairs, n_qubits)
        nlf = neg_log_fidelity(o, target)
        grads = torch.autograd.grad(nlf.sum(), [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        if first_grad is None:
            first_grad = {n: torch.linalg.vector_norm(g.flatten(1), dim=1) for n, g in grads.items()}
        nlfs.append(nlf.detach())
        with torch.no_grad():
            params = opt.step({n: v.detach() for n, v in leaves.items()}, grads)
    return params, torch.stack(nlfs), first_grad
