"""Complex-as-real lowering: complex tensor networks as stacked-real pairs.

Counterpart of ``tneq_tpu/ops/complex_pair.py``.  A complex tensor is held
as a real PAIR, a tensor with a leading axis of size 2 (``[2, *shape]`` =
real part, imaginary part), and every contraction lowers to real einsums
(Karatsuba, three real products per complex one):

    t1 = ar·br,  t2 = ai·bi,  t3 = (ar + ai)·(br + bi)
    (a·b)_re = t1 − t2,  (a·b)_im = t3 − t1 − t2

JAX needed this because its TPU plugin has no complex64; CUDA has, so on
the card the pair form exists to keep ``complex_as_real=True`` meaning the
same in both packages.  Every contraction runs through the port's one
pairwise executor (``ops/pairwise.execute_pairwise``) with
:func:`pair_einsum` as its two-operand step: the step equations are written
for the underlying complex operands (no pair axis), and ``pairwise.einsum``
re-letters each of the three real products to ``a-zA-Z`` and applies the
card's dimension check.

Gradient convention: a pair tensor's gradient is the real pair
``(∂L/∂xr, ∂L/∂xi)`` in both packages (torch's complex gradient, not JAX's
conjugate), so the pair optimizer (``optim/pair_stiefel.py``) follows JAX's
formulas as they are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..graph.dsl import CircuitGraph
from .einsum_spec import core_only_spec, siamese_spec
from .pairwise import (
    choose_path,
    einsum,
    execute_pairwise,
    pairwise_steps,
    two_network_interleave,
)

__all__ = [
    "to_pair",
    "from_pair",
    "pair_conj",
    "pair_abs2",
    "pair_einsum",
    "make_pair_core_only_fn",
    "make_pair_siamese_fn",
    "make_pair_log_abs_overlap_fn",
    "make_pair_log_abs_two_network_fn",
    "pair_fidelity",
    "pair_tree",
    "unpair_tree",
]


def to_pair(z: torch.Tensor) -> torch.Tensor:
    """complex tensor -> ``[2, *shape]`` float32 pair (float64 from
    complex128)."""
    z = torch.as_tensor(z)
    real = z.real if z.is_complex() else z
    imag = z.imag if z.is_complex() else torch.zeros_like(z)
    dtype = torch.float64 if real.dtype == torch.float64 else torch.float32
    return torch.stack([real, imag]).to(dtype)


def from_pair(p: torch.Tensor) -> torch.Tensor:
    """``[2, *shape]`` pair -> complex tensor."""
    return torch.complex(p[0], p[1])


def pair_conj(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[0], -p[1]])


def pair_abs2(p: torch.Tensor) -> torch.Tensor:
    """|z|² elementwise (a real tensor without the leading pair axis)."""
    return p[0] * p[0] + p[1] * p[1]


def pair_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum of pair tensors (``eq`` written for the
    underlying complex operands, no pair axis): three real einsums."""
    t1 = einsum(eq, a[0], b[0])
    t2 = einsum(eq, a[1], b[1])
    t3 = einsum(eq, a[0] + a[1], b[0] + b[1])
    return torch.stack([t1 - t2, t3 - t1 - t2])


def _execute(equation: str, ops: Sequence[torch.Tensor], rescale: bool = False,
             max_intermediate: int = 1 << 26):
    """Pairwise execution of a (complex-operand) einsum on pair tensors:
    the path of the underlying shapes, every step a :func:`pair_einsum`."""
    shapes = tuple(tuple(int(d) for d in o.shape[1:]) for o in ops)
    path = choose_path(equation, shapes, max_intermediate)
    steps = pairwise_steps(equation, list(path))
    return execute_pairwise(steps, ops, contract_pair=pair_einsum, rescale=rescale)


def make_pair_core_only_fn(graph: CircuitGraph, order: str = "reference"):
    """fn(pair_params) -> the dense circuit tensor as a pair (pair twin of
    ``ops.contract.make_core_only_fn``)."""
    spec = core_only_spec(graph, order)

    def fn(params):
        return _execute(spec.equation, [params[name] for _, name in spec.operands])

    return fn


def make_pair_siamese_fn(
    graph: CircuitGraph,
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
):
    """fn(pair_params, pair_states, pair_measures) -> pair siamese value.

    Pair twin of ``ops.contract.make_siamese_fn``; the bra side is
    conjugated in pair form (negated imaginary part).  Born probabilities
    are ``pair_abs2`` of the result.
    """
    spec = siamese_spec(graph, with_states, states_batched, measure_extra_dims)

    def fn(params, states: Optional[Sequence], measures: Sequence):
        ops = []
        for kind, key in spec.operands:
            if kind == "core":
                ops.append(params[key])
            elif kind == "core_conj":
                ops.append(pair_conj(params[key]))
            elif kind == "state":
                ops.append(states[key])
            elif kind == "state_conj":
                ops.append(pair_conj(states[key]))
            elif kind == "measure":
                ops.append(measures[key])
            else:  # pragma: no cover
                raise ValueError(kind)
        return _execute(spec.equation, ops)

    return fn


def make_pair_log_abs_overlap_fn(graph: CircuitGraph, max_intermediate: int = 1 << 26):
    """fn(pair_a, pair_b) -> log|⟨A, B⟩| with per-step rescaling (pair twin
    of ``pairwise.make_log_abs_overlap_fn``)."""
    return make_pair_log_abs_two_network_fn(graph, None, max_intermediate)


def make_pair_log_abs_two_network_fn(
    graph_a: CircuitGraph,
    graph_b: Optional[CircuitGraph] = None,
    max_intermediate: int = 1 << 26,
    signed: bool = False,
):
    """Pair twin of ``pairwise.make_log_abs_two_network_fn``: the overlap of
    two same-boundary networks in pair form, B side conjugated.
    ``signed=True`` returns ``(pair_mantissa, log_scale)``, the form in
    which slice partials are summed."""
    equation, slots = two_network_interleave(graph_a, graph_b)

    def fn(params_a, params_b):
        ops = [params_a[name] if side == "a" else pair_conj(params_b[name])
               for side, name in slots]
        final, logs = _execute(equation, ops, rescale=True, max_intermediate=max_intermediate)
        if signed:
            return final, logs
        return logs + 0.5 * torch.log(pair_abs2(final) + 1e-30)

    return fn


def pair_fidelity(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|⟨t,o⟩|² / (⟨t,t⟩·⟨o,o⟩) on pair tensors (twin of
    ``train.losses.fidelity``)."""
    o = out.reshape(2, -1)
    t = target.reshape(2, -1)
    ov_re = torch.sum(t[0] * o[0] + t[1] * o[1])  # Re⟨t,o⟩ = Σ Re(conj t · o)
    ov_im = torch.sum(t[0] * o[1] - t[1] * o[0])
    num = ov_re ** 2 + ov_im ** 2
    den = torch.clamp(torch.sum(t[0] ** 2 + t[1] ** 2) * torch.sum(o[0] ** 2 + o[1] ** 2),
                      min=1e-12)
    return num / den


def pair_tree(params) -> dict:
    """Map a dict of complex tensors to pair form."""
    return {k: to_pair(v) for k, v in params.items()}


def unpair_tree(params) -> dict:
    """Inverse of :func:`pair_tree`."""
    return {k: from_pair(v) for k, v in params.items()}
