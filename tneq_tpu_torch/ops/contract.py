"""Contraction compute functions: einsum specs -> callables on torch tensors.

Counterpart of ``tneq_tpu/ops/contract.py``.  Every contraction is one
equation from ``ops/einsum_spec.py``, executed as explicit two-operand
``torch.einsum`` steps by ``ops/pairwise.execute_pairwise`` along the path
of the port's native path finder (``native/path.py``: exact DP up to 16
operands, greedy beyond) — never as one many-operand ``torch.einsum``,
which contracts left to right where ``opt_einsum`` is missing, as on the
machine with the card.  JAX takes the same native path from 5 operands on
and opt_einsum's optimal 'auto' below; the port takes the native DP there
too, so the two agree to rounding.

Born-rule semantics as in JAX: the bra side is the complex conjugate of the
ket side, and for complex dtypes the probability is ``|result|²``
(:func:`abs_square`), for real dtypes the raw siamese value.  With
``rescale=True`` the siamese value and env run through the per-step
rescaled executor (``ops/pairwise.rescaled_execute``) and come back as
``(value, log_scale)``.  On MPS chains the Born-rule trainer takes the
transfer sweep (``ops/mps_sweep.py``) instead.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..graph.dsl import CircuitGraph
from ..native.path import find_path
from .einsum_spec import (
    EinsumSpec,
    core_only_spec,
    siamese_env_spec,
    siamese_spec,
    two_network_spec,
    with_inputs_spec,
)
from .pairwise import einsum, execute_pairwise, pairwise_steps, rescaled_execute

__all__ = [
    "abs_square",
    "contract_cores",
    "make_core_only_fn",
    "make_siamese_env_fn",
    "make_siamese_fn",
    "make_two_network_fn",
    "make_with_inputs_fn",
    "siamese_probability",
]

Params = Dict[str, torch.Tensor]


def abs_square(x: torch.Tensor) -> torch.Tensor:
    """|x|² as a real tensor (the Born rule)."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x * x


@functools.lru_cache(maxsize=1024)
def _schedule(equation: str, shapes: Tuple[Tuple[int, ...], ...]):
    """The pairwise steps of ``equation`` at ``shapes`` along the native path."""
    return tuple(pairwise_steps(equation, find_path(equation, shapes)))


def execute(equation: str, ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """``equation`` on ``ops`` as pairwise ``torch.einsum`` steps along the
    native path."""
    if len(ops) == 1:
        return einsum(equation, ops[0])
    return execute_pairwise(_schedule(equation, tuple(tuple(o.shape) for o in ops)), ops)


def _gather_operands(
    spec: EinsumSpec,
    params: Params,
    states: Optional[Sequence[torch.Tensor]] = None,
    measures: Optional[Sequence[torch.Tensor]] = None,
    target_params: Optional[Params] = None,
    conj_right: bool = True,
) -> List[torch.Tensor]:
    ops: List[torch.Tensor] = []
    for kind, key in spec.operands:
        if kind == "core":
            ops.append(params[key])
        elif kind == "core_conj":
            ops.append(torch.conj(params[key]) if conj_right else params[key])
        elif kind == "state":
            ops.append(states[key])
        elif kind == "state_conj":
            ops.append(torch.conj(states[key]) if conj_right else states[key])
        elif kind == "measure":
            ops.append(measures[key])
        elif kind == "target_core":
            ops.append(target_params[key])
        else:  # pragma: no cover
            raise ValueError(f"unknown operand kind {kind}")
    return ops


# ---------------------------------------------------------------------------
# Public compute-function factories
# ---------------------------------------------------------------------------


def make_core_only_fn(graph: CircuitGraph, order: str = "reference"):
    """fn(params) -> dense circuit tensor with open boundary legs."""
    spec = core_only_spec(graph, order)

    def fn(params: Params) -> torch.Tensor:
        return execute(spec.equation, _gather_operands(spec, params))

    return fn


def contract_cores(graph: CircuitGraph, params: Params, order: str = "reference"):
    return make_core_only_fn(graph, order)(params)


def make_with_inputs_fn(graph: CircuitGraph, batched: bool = True):
    """fn(params, states) -> output-boundary tensor (circuit applied to inputs)."""
    spec = with_inputs_spec(graph, batched)

    def fn(params: Params, states: Sequence[torch.Tensor]) -> torch.Tensor:
        return execute(spec.equation, _gather_operands(spec, params, states=states))

    return fn


def make_siamese_fn(
    graph: CircuitGraph,
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
    conj_right: bool = True,
    rescale: bool = False,
):
    """fn(params, states, measures) -> raw siamese value ``[batch...]``.

    ``states``: per-qubit list of ``(rank,)`` (or ``(B, rank)`` when
    ``states_batched``); ``measures``: per-qubit list of
    ``(B..., K_out, K_out')`` operators with ``measure_extra_dims`` leading
    axes.  The bra side is conjugated (no-op for real dtypes).
    """
    spec = siamese_spec(graph, with_states, states_batched, measure_extra_dims)

    def _validate(states, measures):
        if len(measures) != graph.nqubits:
            raise ValueError(
                f"need one measurement operator per qubit "
                f"({graph.nqubits}), got {len(measures)}"
            )
        for q, (m, r) in enumerate(zip(measures, graph.output_ranks)):
            if m.shape[-1] != r or m.shape[-2] != r:
                raise ValueError(
                    f"measurement operator on qubit {q} has shape {tuple(m.shape)} "
                    f"but the circuit's output rank there is {r} — the "
                    f"Hermite order K must equal the qubit's output rank"
                )
        if with_states:
            if states is None or len(states) != graph.nqubits:
                raise ValueError(
                    f"need one input state per qubit ({graph.nqubits}), "
                    f"got {0 if states is None else len(states)}"
                )
            for q, (s, r) in enumerate(zip(states, graph.input_ranks)):
                if s.shape[-1] != r:
                    raise ValueError(
                        f"input state on qubit {q} has shape {tuple(s.shape)} but "
                        f"the circuit's input rank there is {r}"
                    )

    def fn(
        params: Params,
        states: Optional[Sequence[torch.Tensor]],
        measures: Sequence[torch.Tensor],
    ) -> torch.Tensor:
        _validate(states, measures)
        ops = _gather_operands(
            spec, params, states=states, measures=measures, conj_right=conj_right
        )
        if rescale:
            return rescaled_execute(spec.equation, ops, 1 << 28)
        return execute(spec.equation, ops)

    return fn


def make_siamese_env_fn(
    graph: CircuitGraph,
    open_qubit: int,
    with_states: bool = True,
    states_batched: bool = False,
    rescale: bool = False,
):
    """fn(params, states, measures) -> environment ``[B, K, K]`` with
    ``open_qubit``'s measurement slot left open.

    ``measures`` is a FULL per-qubit list; the entry at ``open_qubit`` is
    ignored.  The siamese value for any operator M on that qubit is then
    ``einsum('bkl,...kl->b...', env, M)``.
    """
    spec = siamese_env_spec(graph, open_qubit, with_states, states_batched)

    def fn(
        params: Params,
        states: Optional[Sequence[torch.Tensor]],
        measures: Sequence[torch.Tensor],
    ) -> torch.Tensor:
        ops = _gather_operands(spec, params, states=states, measures=measures)
        if rescale:
            return rescaled_execute(spec.equation, ops, 1 << 28)
        return execute(spec.equation, ops)

    return fn


def siamese_probability(
    graph: CircuitGraph,
    params: Params,
    states: Optional[Sequence[torch.Tensor]],
    measures: Sequence[torch.Tensor],
    states_batched: bool = False,
    measure_extra_dims: int = 1,
) -> torch.Tensor:
    """Born-rule probability of the measurement outcome batch: the siamese
    value itself for real dtypes, ``|value|²`` for complex ones."""
    fn = make_siamese_fn(
        graph,
        with_states=states is not None,
        states_batched=states_batched,
        measure_extra_dims=measure_extra_dims,
    )
    raw = fn(params, states, measures)
    return abs_square(raw) if raw.is_complex() else raw


def make_two_network_fn(
    graph1: CircuitGraph, graph2: CircuitGraph, conj_target: bool = False
):
    """fn(params1, params2) -> scalar overlap of two circuits.

    ``conj_target=False`` is the reference's unconjugated glue; True gives
    the Hermitian inner product.
    """
    spec = two_network_spec(graph1, graph2)

    def fn(params1: Params, params2: Params) -> torch.Tensor:
        if conj_target:
            params2 = {k: torch.conj(v) for k, v in params2.items()}
        return execute(
            spec.equation, _gather_operands(spec, params1, target_params=params2)
        )

    return fn
