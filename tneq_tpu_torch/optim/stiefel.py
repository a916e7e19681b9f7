"""Riemannian Stiefel-manifold optimizers as functional ``(init, update)``
pairs over ``{name: Tensor}`` dicts.

Counterpart of ``tneq_tpu/optim/stiefel.py`` (``sgdg``, ``adamg``), with the
same per-tensor semantics: reshape to ``(rows, cols) = (prod(s[:k//2]),
prod(s[k//2:]))``; if ``stiefel`` and ``rows <= cols`` apply the Cayley /
Stiefel update, else plain SGD with momentum.  ``update`` returns additive
updates (``new - old``).

Gradient convention.  For a real loss of a complex tensor, torch autograd
returns the conjugate of what ``jax.grad`` returns.  Every formula below is
written on ``conj(g)`` where the JAX code uses ``g`` (and on ``g`` where it
uses ``conj(g)``), so both packages take the same step from the same point;
the complex one-step parity tests hold this (``tests/test_torch_optim.py``).

Retraction draws.  JAX draws ``bernoulli(subkey, retraction_prob)`` from a
split key; the port draws one host-side uniform from a ``torch.Generator``
seeded with ``seed`` at ``init``.  Same-shape SGD-G leaves form one group
with ONE draw per group (Adam-G: one draw per Stiefel leaf), in sorted-name
order as JAX's dict flattening.  The streams differ, so parity is tested
with ``retraction_prob=0`` and with the retraction forced (``1``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch

__all__ = ["sgdg", "adamg", "qr_retraction", "matrix_norm_one", "unit_rows",
           "GradientTransformation"]

EPS = 1e-8

ScalarOrSchedule = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _lr_at(lr: ScalarOrSchedule, count: int) -> float:
    """The learning rate at ``count``, rounded to float32 as JAX holds it."""
    return float(np.float32(lr(count) if callable(lr) else lr))


def _mT(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes."""
    return x.conj().transpose(-2, -1)


def matrix_norm_one(w: torch.Tensor) -> torch.Tensor:
    """Induced 1-norm over the last two axes: max over columns of the
    column abs-sum."""
    return w.abs().sum(dim=-2).amax(dim=-1)


def unit_rows(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Normalise each row (last axis) to unit L2 norm."""
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def qr_retraction(x: torch.Tensor) -> torch.Tensor:
    """Retract ``(..., rows, cols)`` (rows <= cols) onto the Stiefel manifold
    of row-orthonormal matrices, with the phase/sign correction."""
    q, r = torch.linalg.qr(_mT(x))
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    ph = d / (d.abs() + 1e-12) if d.is_complex() else torch.sign(d)
    return _mT(q * ph.unsqueeze(-2)).resolve_conj()


def _rows_cols(shape) -> tuple:
    mid = len(shape) // 2
    rows = int(np.prod(shape[:mid], dtype=np.int64)) if mid else 1
    cols = int(np.prod(shape[mid:], dtype=np.int64))
    return rows, cols


def _half(alpha: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (alpha.to(w.real.dtype) / 2)[..., None, None]


def _cayley_solve(alpha, w, x):
    """Y = (I - α/2·W)⁻¹ (I + α/2·W) X via a linear solve (batched over the
    leading axes; ``alpha`` has the batch shape)."""
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    half = _half(alpha, w)
    return torch.linalg.solve(eye - half * w, (eye + half * w) @ x)


def _cayley_iterative(alpha, w, x, iters: int = 8):
    """The same Cayley step by the fixed-point iteration Y ← X + α·W·(X+Y)/2."""
    half = _half(alpha, w)
    y = x
    for _ in range(iters):
        y = x + half * (w @ (x + y))
    return y


def _cayley(alpha, w, x, method: str = "solve", iters: int = 8):
    if method == "solve":
        return _cayley_solve(alpha, w, x)
    return _cayley_iterative(alpha, w, x, iters)


def _draw(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen))


def _stiefel_step(g, p, v, x, lr, momentum, eps, cayley, cayley_iters):
    """SGD-G's Cayley update of a batch ``[B, *shape]`` given the (possibly
    retracted) manifold points x ``[B, rows, cols]``: ``(update,
    momentum)``."""
    rows, cols = x.shape[-2:]
    # JAX's gradient is conj(g) here, and JAX takes its plain transpose
    g2 = g.conj().reshape(-1, rows, cols)
    v_new = momentum * v - g2.transpose(-2, -1)  # (cols, rows)
    mx = v_new @ x  # (cols, cols)
    xmx = x @ mx  # (rows, cols)
    xxmx = _mT(x) @ xmx  # (cols, cols)
    w_hat = mx - 0.5 * xxmx
    w = w_hat - _mT(w_hat)  # skew-Hermitian
    t = 1.0 / (matrix_norm_one(w) + eps)
    alpha = t.clamp(max=lr)
    y = _cayley(alpha, w, _mT(x), cayley, cayley_iters)  # (cols, rows)
    p_new = _mT(y).reshape(p.shape)
    v_next = w @ _mT(x)  # (cols, rows), saved for next step
    return p_new - p, v_next


def _plain_step(g, p, buf, lr, count, momentum, dampening=0.0, weight_decay=0.0,
                nesterov=False):
    """SGD-G's plain update (a leaf off the manifold): ``(update, buffer)``."""
    # JAX's descent direction conj(g_jax) is torch's g
    d = g
    if weight_decay != 0:
        d = d + weight_decay * p
    if momentum != 0:
        # torch's buffer starts as the first gradient (JAX emulates the
        # clone with a where on count == 0)
        if count == 0:
            buf_new = d
        else:
            buf_new = momentum * buf + (1.0 - dampening) * d
        d = d + momentum * buf_new if nesterov else buf_new
    else:
        buf_new = buf
    return -lr * d, buf_new


class SGDGState(NamedTuple):
    momentum: Dict[str, torch.Tensor]  # (cols, rows) per Stiefel leaf
    generator: torch.Generator
    count: int


def sgdg(
    learning_rate: ScalarOrSchedule,
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    stiefel: bool = True,
    retraction_prob: float = 1.0 / 101.0,
    eps: float = EPS,
    seed: int = 0,
    cayley: str = "solve",
    cayley_iters: int = 8,
) -> GradientTransformation:
    """Stiefel SGD-G with Cayley updates (reference ``SGDG``).

    Same-shape Stiefel leaves are updated as ONE batch (one batched QR, one
    batched Cayley solve) with one retraction draw per shape group.
    """
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("nesterov momentum needs momentum > 0 and 0 dampening")

    def is_stiefel_leaf(p) -> bool:
        rows, cols = _rows_cols(p.shape)
        return stiefel and rows <= cols

    def init(params):
        def init_buf(p):
            rows, cols = _rows_cols(p.shape)
            if is_stiefel_leaf(p):
                return torch.zeros((cols, rows), dtype=p.dtype, device=p.device)
            return torch.zeros_like(p)

        return SGDGState(
            momentum={k: init_buf(p) for k, p in params.items()},
            generator=torch.Generator().manual_seed(seed),
            count=0,
        )

    def update(grads, state: SGDGState, params):
        lr = _lr_at(learning_rate, state.count)
        updates: Dict[str, torch.Tensor] = {}
        new_mom: Dict[str, torch.Tensor] = {}
        groups: Dict[tuple, list] = {}
        for name in sorted(params):
            p = params[name]
            if is_stiefel_leaf(p):
                groups.setdefault(tuple(p.shape), []).append(name)
            else:
                updates[name], new_mom[name] = _plain_step(
                    grads[name], p, state.momentum[name], lr, state.count,
                    momentum, dampening, weight_decay, nesterov)
        for shape, names in groups.items():
            rows, cols = _rows_cols(shape)
            g_b = torch.stack([grads[n] for n in names])
            p_b = torch.stack([params[n] for n in names])
            v_b = torch.stack([state.momentum[n] for n in names])
            x_b = unit_rows(p_b.reshape(-1, rows, cols), eps)
            # one draw per shape group (JAX: stiefel.py:246-256)
            if retraction_prob > 0 and _draw(state.generator) < retraction_prob:
                x_b = qr_retraction(x_b)
            u_b, m_b = _stiefel_step(g_b, p_b, v_b, x_b, lr, momentum, eps, cayley,
                                     cayley_iters)
            for j, n in enumerate(names):
                updates[n], new_mom[n] = u_b[j], m_b[j]
        return updates, SGDGState(new_mom, state.generator, state.count + 1)

    return GradientTransformation(init, update)


class AdamGState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    beta1_power: np.float32
    beta2_power: np.float32
    generator: torch.Generator
    count: int


def adamg(
    learning_rate: ScalarOrSchedule,
    momentum: float = 0.9,
    beta2: float = 0.99,
    epsilon: float = 1e-8,
    stiefel: bool = True,
    retraction_prob: float = 1.0 / 101.0,
    eps: float = EPS,
    seed: int = 0,
    cayley: str = "solve",
    cayley_iters: int = 8,
) -> GradientTransformation:
    """Adam-G Grassmann/Stiefel variant (reference ``AdamG``), with the JAX
    package's descent sign (Cayley step with −α)."""

    def is_stiefel_leaf(p) -> bool:
        rows, cols = _rows_cols(p.shape)
        return stiefel and rows <= cols

    def init(params):
        def init_m(p):
            rows, cols = _rows_cols(p.shape)
            if is_stiefel_leaf(p):
                return torch.zeros((cols, rows), dtype=p.dtype, device=p.device)
            return torch.zeros_like(p)

        return AdamGState(
            m={k: init_m(p) for k, p in params.items()},
            v={k: torch.zeros((), dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            beta1_power=np.float32(momentum),
            beta2_power=np.float32(beta2),
            generator=torch.Generator().manual_seed(seed),
            count=0,
        )

    def update(grads, state: AdamGState, params):
        lr = _lr_at(learning_rate, state.count)
        b1c = float(np.float32(1) - state.beta1_power)
        b2c = float(np.float32(1) - state.beta2_power)
        updates, m_out, v_out = {}, {}, {}
        for name in sorted(params):
            g, p, m, v = grads[name], params[name], state.m[name], state.v[name]
            if not is_stiefel_leaf(p):
                # JAX's conj(g_jax) is torch's g
                buf = momentum * m + g if momentum != 0 else g
                updates[name], m_out[name], v_out[name] = -lr * buf, buf, v
                continue
            shape = p.shape
            rows, cols = _rows_cols(shape)
            x = unit_rows(p.reshape(rows, cols), eps)
            if retraction_prob > 0 and _draw(state.generator) < retraction_prob:
                x = qr_retraction(x)
            g2 = g.conj().reshape(rows, cols)  # JAX's gradient
            m_new = momentum * m + (1 - momentum) * g2.T
            sq = torch.vdot(g2.reshape(-1), g2.reshape(-1)).real.to(torch.float32)
            v_new = beta2 * v + (1 - beta2) * sq
            m_hat = m_new / b1c
            v_hat = v_new / b2c
            mx = m_hat @ x
            xmx = x @ mx
            xxmx = _mT(x) @ xmx
            w_hat = mx - 0.5 * xxmx
            root = torch.sqrt(v_hat + epsilon).to(w_hat.dtype)
            w = (w_hat - _mT(w_hat)) / root
            t = 1.0 / (matrix_norm_one(w) + eps)
            alpha = t.clamp(max=lr)
            y = _cayley(-alpha, w, _mT(x), cayley, cayley_iters)
            updates[name] = _mT(y).reshape(shape) - p
            m_out[name] = w @ _mT(x) * root * b1c
            v_out[name] = v_new
        return updates, AdamGState(
            m=m_out,
            v=v_out,
            beta1_power=np.float32(state.beta1_power * np.float32(momentum)),
            beta2_power=np.float32(state.beta2_power * np.float32(beta2)),
            generator=state.generator,
            count=state.count + 1,
        )

    return GradientTransformation(init, update)
