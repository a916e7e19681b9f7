"""Log-scale companions: ``(data, log_scale)`` pairs with max-abs-normalised
data.  Counterpart of ``tneq_tpu/ops/scaling.py`` (``Scaled``,
``auto_scale``, ``scaled_siamese_fn``).  The per-step rescaled pairwise
executor that these pairs also feed comes with ROADMAP A, item 7b."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.dsl import CircuitGraph
from .contract import make_siamese_fn

__all__ = ["Scaled", "auto_scale", "scaled_siamese_fn"]


class Scaled(NamedTuple):
    """A tensor with its magnitude factored out: value = data · exp(log_scale)."""

    data: torch.Tensor
    log_scale: torch.Tensor  # scalar, real

    @property
    def value(self) -> torch.Tensor:
        return self.data * torch.exp(self.log_scale).to(self.data.dtype)


def auto_scale(x: torch.Tensor, eps: float = 1e-30) -> Scaled:
    """Normalise max-abs to 1.  The scale is detached (JAX's
    ``stop_gradient``): gradients flow through ``data`` as through ``x`` up
    to the constant factor."""
    m = x.detach().abs().max().clamp_min(eps)
    return Scaled(x / m.to(x.dtype), torch.log(m).to(torch.float32))


def scaled_siamese_fn(
    graph: CircuitGraph,
    with_states: bool = True,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
):
    """Siamese contraction on auto-scaled operands.

    Returns ``fn(params, states, measures) -> (raw, log_scale)`` where the
    true siamese value is ``raw · exp(log_scale)``.  Cores contribute their
    log-scale twice (ket + bra), measures once.  Born probability of the
    scaled result: ``abs_square(raw)`` with ``2·log_scale`` (complex) or
    ``raw`` with ``log_scale`` (real) — feed that log term to
    ``nll_loss(probs, log_scale=...)``.
    """
    fn = make_siamese_fn(graph, with_states, states_batched, measure_extra_dims)

    def scaled(params, states, measures):
        dev = next(iter(params.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        norm_params = {}
        for name, arr in params.items():
            s = auto_scale(arr)
            norm_params[name] = s.data
            total = total + 2.0 * s.log_scale  # ket + bra
        norm_measures = []
        for m in measures:
            s = auto_scale(m)
            norm_measures.append(s.data)
            total = total + s.log_scale
        raw = fn(norm_params, states, norm_measures)
        return raw, total

    return scaled
