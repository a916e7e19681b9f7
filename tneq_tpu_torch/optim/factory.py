"""Optimizer factory: reference method names -> gradient transformations.

Counterpart of ``tneq_tpu/optim/factory.py``.  The JAX factory maps the
plain methods onto optax; here the same update rules are written out by
hand with optax's formulas (``adam``, ``sgd``, ``momentum``, ``nesterov``,
``rmsprop``) over ``{name: Tensor}`` dicts, without an optax import.

Complex leaves: optax applies its formulas to ``jax.grad``'s output, the
conjugate of torch's gradient, so each rule here first conjugates the torch
gradient.  This reproduces the JAX package step for step — including that
optax then steps along the conjugate of the descent direction on complex
leaves (see ROADMAP, section C).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .stiefel import GradientTransformation, _lr_at, adamg, sgdg

__all__ = ["make_optimizer"]


def _jax_grad(g: torch.Tensor) -> torch.Tensor:
    """The gradient as ``jax.grad`` returns it (conjugate for complex)."""
    return g.conj() if g.is_complex() else g


def _abs_sq(g: torch.Tensor) -> torch.Tensor:
    return (g.conj() * g).real if g.is_complex() else g * g


class _AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _adam(lr, b1: float, b2: float, eps: float) -> GradientTransformation:
    """optax.adam: scale_by_adam (bias-corrected moments), then −lr."""

    def init(params):
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return _AdamState(0, zeros, {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state: _AdamState, params=None):
        count_inc = state.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count_inc))
        step = -_lr_at(lr, state.count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = _jax_grad(g)
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * _abs_sq(g) + b2 * state.nu[k]
            updates[k] = step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
        return updates, _AdamState(count_inc, mu, nu)

    return GradientTransformation(init, update)


class _TraceState(NamedTuple):
    count: int
    trace: Dict[str, torch.Tensor]


def _sgd(lr, momentum: Optional[float] = None,
         nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: optional trace (heavy-ball / Nesterov), then −lr."""

    def init(params):
        return _TraceState(0, {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state: _TraceState, params=None):
        step = -_lr_at(lr, state.count)
        updates, trace = {}, {}
        for k, g in grads.items():
            g = _jax_grad(g)
            if momentum is None:
                u, trace[k] = g, state.trace[k]
            else:
                trace[k] = g + momentum * state.trace[k]
                u = g + momentum * trace[k] if nesterov else trace[k]
            updates[k] = step * u
        return updates, _TraceState(state.count + 1, trace)

    return GradientTransformation(init, update)


class _RmsState(NamedTuple):
    count: int
    nu: Dict[str, torch.Tensor]
    trace: Dict[str, torch.Tensor]


def _rmsprop(lr, decay: float, eps: float, momentum: float) -> GradientTransformation:
    """optax.rmsprop (non-centred): g·rsqrt(nu + eps), then −lr, then a
    trace with decay ``momentum``."""

    def init(params):
        return _RmsState(
            0,
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(grads, state: _RmsState, params=None):
        step = -_lr_at(lr, state.count)
        updates, nu, trace = {}, {}, {}
        for k, g in grads.items():
            g = _jax_grad(g)
            nu[k] = (1 - decay) * _abs_sq(g) + decay * state.nu[k]
            u = step * (torch.rsqrt(nu[k] + eps) * g)
            trace[k] = u + momentum * state.trace[k]
            updates[k] = trace[k]
        return updates, _RmsState(state.count + 1, nu, trace)

    return GradientTransformation(init, update)


def make_optimizer(method: str = "sgdg", **hyper: Any) -> GradientTransformation:
    """Create an optimizer by reference method name.

    Supported: 'sgdg' (Stiefel SGD-G), 'adamg' (Stiefel Adam-G), 'adam',
    'sgd', 'momentum', 'nesterov', 'rmsprop'.
    """
    method = method.lower()
    lr = hyper.pop("lr", hyper.pop("learning_rate", 1e-2))
    if method == "sgdg":
        return sgdg(lr, **hyper)
    if method == "adamg":
        return adamg(lr, **hyper)
    if method == "adam":
        return _adam(
            lr,
            b1=hyper.get("beta1", 0.9),
            b2=hyper.get("beta2", 0.999),
            eps=hyper.get("epsilon", 1e-8),
        )
    if method == "sgd":
        return _sgd(lr)
    if method == "momentum":
        return _sgd(lr, momentum=hyper.get("momentum", 0.9))
    if method == "nesterov":
        return _sgd(lr, momentum=hyper.get("momentum", 0.9), nesterov=True)
    if method == "rmsprop":
        return _rmsprop(
            lr,
            decay=hyper.get("decay", 0.99),
            eps=hyper.get("epsilon", 1e-8),
            momentum=hyper.get("momentum", 0.0),
        )
    raise ValueError(f"unknown optimizer method {method!r}")
