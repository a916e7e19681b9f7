"""Probability inference: full, marginal and conditional.

Counterpart of ``tneq_tpu/infer/probability.py``, on the port's siamese
contraction (``ops/contract.make_siamese_fn``: pairwise ``torch.einsum``
steps along the native path):

- marginal: the qubits that are not measured get identity operators,
  batched like the first measurement operator;
- conditional: each qubit's operator is stacked ``[joint, marginal]`` along
  an extra axis so both contract in one batched pass, then divided.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..graph.dsl import CircuitGraph
from ..ops.contract import abs_square, make_siamese_fn

__all__ = ["full_probability", "marginal_probability", "conditional_probability"]


def _born(raw: torch.Tensor) -> torch.Tensor:
    return abs_square(raw) if raw.is_complex() else raw


def _states_batched(states) -> bool:
    return any(getattr(s, "ndim", 1) == 2 for s in (states or []))


def full_probability(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    measures: Sequence[torch.Tensor],
    log: bool = False,
) -> torch.Tensor:
    """P(outcomes) for a complete per-qubit measurement batch ``(B, K, K)``.

    ``log=True`` returns log P through the per-step rescaled executor
    (``ops/pairwise.rescaled_execute``), the only representable form at 30
    and more qubits, where P itself under- or overflows float32."""
    fn = make_siamese_fn(
        graph,
        with_states=True,
        states_batched=_states_batched(states),
        measure_extra_dims=1,
        rescale=log,
    )
    if not log:
        return _born(fn(params, states, measures))
    raw, log_scale = fn(params, states, measures)
    factor = 2.0 if raw.is_complex() else 1.0
    return torch.log(_born(raw) + 1e-30) + factor * log_scale


def _identity_like(measures: Sequence[torch.Tensor], rank: int) -> torch.Tensor:
    """Identity operator matching the batch shape, dtype and device of the
    first measurement operator."""
    m0 = measures[0]
    ident = torch.eye(rank, dtype=m0.dtype, device=m0.device)
    if m0.ndim == 3:
        return ident.expand(m0.shape[0], rank, rank)
    return ident


def marginal_probability(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    measures: Sequence[torch.Tensor],
    qubit_indices: Sequence[int],
    log: bool = False,
) -> torch.Tensor:
    """P over a subset of qubits: identity operators trace out the rest.
    ``log=True``: see :func:`full_probability`."""
    if len(qubit_indices) != len(measures):
        raise ValueError("qubit_indices length must match measures length")
    ranks = graph.output_ranks
    by_qubit = dict(zip(qubit_indices, measures))
    full = [
        by_qubit[q] if q in by_qubit else _identity_like(measures, ranks[q])
        for q in range(graph.nqubits)
    ]
    return full_probability(graph, params, states, full, log=log)


def conditional_probability(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    measures: Sequence[torch.Tensor],
    qubit_indices: Sequence[int],
    target_indices: Sequence[int],
    epsilon: float = 1e-10,
    rescale=None,
) -> torch.Tensor:
    """P(target | condition) by the stacked-[M, I] operators.

    ``measures`` covers ``qubit_indices`` (targets and conditions).  Each
    qubit's operator becomes a ``(B, 2, K, K)`` stack: slot 0 computes the
    joint, slot 1 (identity on the targets) the conditioning marginal, and
    one contraction yields both; their ratio is the conditional.

    ``rescale`` runs the contraction through the per-step rescaled
    executor: one global log-scale serves both slots and cancels in the
    ratio, so the conditional stays representable at 30 and more qubits.
    ``None`` turns it on from 16 qubits.
    """
    if rescale is None:
        rescale = graph.nqubits >= 16
    if len(qubit_indices) != len(measures):
        raise ValueError("qubit_indices length must match measures length")
    target_set = set(target_indices)
    if not target_set <= set(qubit_indices):
        raise ValueError("target_indices must be a subset of qubit_indices")
    ranks = graph.output_ranks
    by_qubit = dict(zip(qubit_indices, measures))
    stacked = []
    for q in range(graph.nqubits):
        ident = _identity_like(measures, ranks[q])
        if q not in by_qubit:
            pair = (ident, ident)
        elif q in target_set:
            pair = (by_qubit[q], ident)
        else:
            pair = (by_qubit[q], by_qubit[q])
        stacked.append(torch.stack(pair, dim=-3))

    fn = make_siamese_fn(
        graph,
        with_states=True,
        states_batched=_states_batched(states),
        measure_extra_dims=2,
        rescale=rescale,
    )
    raw = fn(params, states, stacked)
    if rescale:
        raw, _ = raw  # one global scale for both slots: cancels in the ratio
    both = _born(raw)  # (B, 2)
    joint, cond = both[..., 0], both[..., 1]
    return joint / (cond + epsilon)
