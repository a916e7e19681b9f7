"""Stiefel SGD-G on complex parameters in stacked-real (pair) form.

Counterpart of ``tneq_tpu/optim/pair_stiefel.py``: ``optim/stiefel.sgdg``'s
complex path with every complex matrix operation lowered to real arithmetic
on ``[..., 2, rows, cols]`` pair tensors (``ops/complex_pair.py``) —
momentum, skew-Hermitian projection, adaptive step, Cayley solve (through
the real 2n×2n embedding ``[[Wr, −Wi], [Wi, Wr]]``) and the stochastic QR
retraction (complex modified Gram-Schmidt, positive-real diagonal).  Every
helper takes leading batch axes before the pair axis, so a same-shape
group of leaves is one batched update.

Gradient convention: a pair gradient is the real pair ``(∂L/∂xr,
∂L/∂xi)`` in both packages, so the formulas are JAX's as they are: the
update uses the pair conjugate transpose of the gradient.  The complex
conjugation that ``sgdg`` applies to torch's complex gradients (ROADMAP
§C) does not apply here.

Retraction draws: as ``sgdg``, one host-side uniform per shape group from a
``torch.Generator`` seeded at ``init``, in sorted-name order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .stiefel import (EPS, GradientTransformation, ScalarOrSchedule, _draw, _lr_at, _rows_cols,
                      _solve_unchecked)

__all__ = [
    "pair_sgdg",
    "pair_qr_retraction",
    "pair_matmul",
    "pair_h",
    "pair_norm_one",
    "pair_unit_rows",
]


def _re(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0, :, :]


def _im(p: torch.Tensor) -> torch.Tensor:
    return p[..., 1, :, :]


def _pair(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.stack([re, im], dim=-3)


def pair_h(p: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of a pair matrix ``[..., 2, m, n] -> [..., 2, n, m]``."""
    t = p.transpose(-1, -2)
    return _pair(_re(t), -_im(t))


def pair_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pair matrix product (Karatsuba: three real matmuls)."""
    t1 = _re(a) @ _re(b)
    t2 = _im(a) @ _im(b)
    t3 = (_re(a) + _im(a)) @ (_re(b) + _im(b))
    return _pair(t1 - t2, t3 - t1 - t2)


def pair_norm_one(w: torch.Tensor) -> torch.Tensor:
    """Induced 1-norm of the underlying complex matrix."""
    mod = torch.sqrt(_re(w) ** 2 + _im(w) ** 2)
    return mod.sum(dim=-2).amax(dim=-1)


def pair_unit_rows(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Each row of the underlying complex matrix scaled to unit norm."""
    n = torch.sqrt(torch.sum(_re(x) ** 2 + _im(x) ** 2, dim=-1, keepdim=True))
    return x / (n.unsqueeze(-3) + eps)


def pair_qr_retraction(x: torch.Tensor) -> torch.Tensor:
    """Retract a pair ``[..., 2, rows, cols]`` (rows <= cols) matrix onto the
    row-orthonormal Stiefel manifold: complex modified Gram-Schmidt on the
    conjugate transpose, positive-real diagonal."""
    rows = x.shape[-2]
    a = pair_h(x)  # [..., 2, cols, rows], tall
    qs = []
    for j in range(rows):
        vr, vi = _re(a)[..., j], _im(a)[..., j]  # [..., cols]
        for qr, qi in qs:
            # <q, v> = sum conj(q) v;  v -= q <q, v>
            re = torch.sum(qr * vr + qi * vi, dim=-1, keepdim=True)
            im = torch.sum(qr * vi - qi * vr, dim=-1, keepdim=True)
            vr, vi = vr - (qr * re - qi * im), vi - (qr * im + qi * re)
        nrm = torch.sqrt(torch.sum(vr ** 2 + vi ** 2, dim=-1, keepdim=True)) + 1e-12
        qs.append((vr / nrm, vi / nrm))
    q = _pair(torch.stack([r for r, _ in qs], dim=-1), torch.stack([i for _, i in qs], dim=-1))
    return pair_h(q)


def _half(alpha: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (alpha.to(w.dtype) / 2)[..., None, None]


def _pair_cayley_solve(alpha, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = (I − α/2·W)⁻¹ (I + α/2·W) X on pairs via the real 2n embedding
    (batched over the leading axes; ``alpha`` has the batch shape)."""
    n = w.shape[-1]
    half = _half(alpha, w)
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    a_re = eye - half * _re(w)
    a_im = -half * _im(w)
    b = pair_matmul(_pair(eye + half * _re(w), half * _im(w)), x)
    big = torch.cat([torch.cat([a_re, -a_im], dim=-1),
                     torch.cat([a_im, a_re], dim=-1)], dim=-2)  # E(I − hW)
    rhs = torch.cat([_re(b), _im(b)], dim=-2)  # [..., 2n, r]
    sol = _solve_unchecked(big, rhs)
    return _pair(sol[..., :n, :], sol[..., n:, :])


def _pair_cayley_iterative(alpha, w, x, iters: int = 8) -> torch.Tensor:
    """The same Cayley step by the fixed point Y ← X + α/2·W·(X+Y)."""
    half = _half(alpha, w).unsqueeze(-3)
    y = x
    for _ in range(iters):
        y = x + half * pair_matmul(w, x + y)
    return y


class PairSGDGState(NamedTuple):
    momentum: Dict[str, torch.Tensor]  # [2, cols, rows] per Stiefel leaf
    generator: torch.Generator
    count: int


def pair_sgdg(
    learning_rate: ScalarOrSchedule,
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    stiefel: bool = True,
    retraction_prob: float = 1.0 / 101.0,
    eps: float = EPS,
    seed: int = 0,
    cayley: str = "solve",
    cayley_iters: int = 8,
) -> GradientTransformation:
    """``sgdg`` for PAIR parameters ``{name: [2, *shape]}``: the same
    reshape rule on the underlying shape, the same momentum and Cayley
    algebra, one retraction draw per same-shape group."""

    def is_stiefel_leaf(p) -> bool:
        rows, cols = _rows_cols(p.shape[1:])
        return stiefel and rows <= cols

    def init(params):
        def init_buf(p):
            rows, cols = _rows_cols(p.shape[1:])
            if is_stiefel_leaf(p):
                return torch.zeros((2, cols, rows), dtype=p.dtype, device=p.device)
            return torch.zeros_like(p)

        return PairSGDGState(
            momentum={k: init_buf(p) for k, p in params.items()},
            generator=torch.Generator().manual_seed(seed),
            count=0,
        )

    def _stiefel_math(g, p, v, x, lr):
        """Cayley update of a group ``[B, 2, *shape]`` at the (possibly
        retracted) manifold points x ``[B, 2, rows, cols]``."""
        rows, cols = x.shape[-2:]
        # JAX's complex path uses g_jaxᵀ; a pair gradient is
        # pair(conj(g_jax)), so g_jaxᵀ is its pair conjugate transpose
        gt = pair_h(g.reshape(-1, 2, rows, cols))  # [B, 2, cols, rows]
        v_new = momentum * v - gt
        mx = pair_matmul(v_new, x)  # [B, 2, cols, cols]
        xmx = pair_matmul(x, mx)  # [B, 2, rows, cols]
        xxmx = pair_matmul(pair_h(x), xmx)  # [B, 2, cols, cols]
        w_hat = mx - 0.5 * xxmx
        w = w_hat - pair_h(w_hat)
        t = 1.0 / (pair_norm_one(w) + eps)
        alpha = t.clamp(max=lr)
        if cayley == "solve":
            y = _pair_cayley_solve(alpha, w, pair_h(x))
        else:
            y = _pair_cayley_iterative(alpha, w, pair_h(x), cayley_iters)
        p_new = pair_h(y).reshape(p.shape)
        return p_new - p, pair_matmul(w, pair_h(x))

    def _plain_update(g, p, buf, lr, count):
        d = g  # a pair gradient is the descent direction
        if weight_decay != 0:
            d = d + weight_decay * p
        if momentum != 0:
            buf_new = d if count == 0 else momentum * buf + (1.0 - dampening) * d
            d = buf_new
        else:
            buf_new = buf
        return -lr * d, buf_new

    def update(grads, state: PairSGDGState, params):
        lr = _lr_at(learning_rate, state.count)
        updates: Dict[str, torch.Tensor] = {}
        new_mom: Dict[str, torch.Tensor] = {}
        groups: Dict[tuple, list] = {}
        for name in sorted(params):
            p = params[name]
            if is_stiefel_leaf(p):
                groups.setdefault(tuple(p.shape), []).append(name)
            else:
                updates[name], new_mom[name] = _plain_update(
                    grads[name], p, state.momentum[name], lr, state.count)
        for shape, names in groups.items():
            rows, cols = _rows_cols(shape[1:])
            g_b = torch.stack([grads[n] for n in names])
            p_b = torch.stack([params[n] for n in names])
            v_b = torch.stack([state.momentum[n] for n in names])
            x_b = pair_unit_rows(p_b.reshape(-1, 2, rows, cols), eps)
            # one draw per shape group, as sgdg
            if retraction_prob > 0 and _draw(state.generator) < retraction_prob:
                x_b = pair_qr_retraction(x_b)
            u_b, m_b = _stiefel_math(g_b, p_b, v_b, x_b, lr)
            for j, n in enumerate(names):
                updates[n], new_mom[n] = u_b[j], m_b[j]
        return updates, PairSGDGState(new_mom, state.generator, state.count + 1)

    return GradientTransformation(init, update)

