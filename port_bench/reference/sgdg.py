"""SGD-G: Stiefel SGD with momentum by the Cayley transform, plainly.

A core of shape ``s`` is the matrix ``(rows, cols) = (prod(s[:k/2]),
prod(s[k/2:]))``.  Where ``rows <= cols`` the core lives on the Stiefel
manifold of row-orthonormal matrices and takes the Cayley step; otherwise
it takes plain SGD with momentum.  All leaves may carry leading batch axes
(lanes), and the step is taken on each batch entry alone.

Stiefel step, with ``G`` the loss's gradient in the convention in which
the descent direction of a complex leaf is ``-conj(G)`` (PyTorch's
autograd returns ``conj(G)``), ``X`` the leaf with unit rows and ``V`` the
momentum (``cols × rows``, zero at first):

    V' = μ V − Gᵀ;   M = V' X;   Ŵ = M − ½ Xᴴ X M;   W = Ŵ − Ŵᴴ
    α = min(lr, 1 / (‖W‖₁ + ε))
    Y = (I − α/2 W)⁻¹ (I + α/2 W) Xᴴ;   new leaf = Yᴴ;   momentum = W Xᴴ

Plain step: the buffer is the first gradient, then ``μ·buffer + g``; the
update is ``−lr·buffer``.

Retraction.  Before a step, with probability ``1/101``, the unit-row
points are retracted onto the manifold by QR (``Xᴴ = QR``, ``X = (Q·D)ᴴ``
with ``D`` the phases of diag R).  Leaves of one shape share one draw per
step, taken in the order of the first name of each shape among the sorted
names, as uniforms from a CPU ``torch.Generator`` seeded with the
optimizer's seed, so the reference takes the draws the configuration
states.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["SGDG", "matrix_shape", "first_retraction_step"]

EPS = 1e-8
RETRACTION_PROB = 1.0 / 101.0


def matrix_shape(shape) -> Tuple[int, int]:
    k = len(shape)
    return int(np.prod(shape[: k // 2], dtype=np.int64)), int(np.prod(shape[k // 2:], dtype=np.int64))


def _h(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-2, -1)


class SGDG:
    """``lr``, ``momentum`` and the retraction's ``seed``; ``batch`` is the
    number of leading lane axes of every leaf (0 or 1)."""

    def __init__(self, lr: float, momentum: float, seed: int, batch: int = 0):
        self.lr = float(np.float32(lr))
        self.momentum = momentum
        self.batch = batch
        self.gen = torch.Generator().manual_seed(int(seed))
        self.count = 0
        self.buf: Dict[str, torch.Tensor] = {}

    def _shape(self, p):
        return tuple(p.shape[self.batch:])

    def stiefel(self, p) -> bool:
        rows, cols = matrix_shape(self._shape(p))
        return rows <= cols

    def draws(self, shapes: Dict[str, Tuple[int, ...]]) -> Dict[Tuple[int, ...], bool]:
        """This step's retraction draws, one per shape of Stiefel leaves
        (``shapes``: each leaf's shape without lane axes)."""
        out = {}
        for name in sorted(shapes):
            shape = tuple(shapes[name])
            rows, cols = matrix_shape(shape)
            if rows <= cols and shape not in out:
                out[shape] = float(torch.rand((), generator=self.gen)) < RETRACTION_PROB
        return out

    def resume(self, buf: Dict[str, torch.Tensor], count: int,
               shapes: Dict[str, Tuple[int, ...]]) -> None:
        """Take up another optimizer's state after ``count`` steps: its
        buffers, and this seed's draws of those steps."""
        for _ in range(count):
            self.draws(shapes)
        self.buf, self.count = dict(buf), count

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """The new params; the state advances."""
        draws = self.draws({n: self._shape(p) for n, p in params.items()})
        new = {}
        for name in sorted(params):
            p, g = params[name], grads[name]
            lead = p.shape[: self.batch]
            rows, cols = matrix_shape(self._shape(p))
            if not self.stiefel(p):
                buf = g if self.count == 0 else self.momentum * self.buf[name] + g
                self.buf[name] = buf
                new[name] = p - self.lr * buf
                continue
            x = p.reshape(*lead, rows, cols)
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
            if draws[self._shape(p)]:
                q, r = torch.linalg.qr(_h(x))
                d = torch.diagonal(r, dim1=-2, dim2=-1)
                ph = d / (d.abs() + 1e-12) if d.is_complex() else torch.sign(d)
                x = _h(q * ph.unsqueeze(-2))
            gt = g.conj().reshape(*lead, rows, cols).transpose(-2, -1)
            v = self.buf.get(name)
            v_new = -gt if v is None else self.momentum * v - gt
            m = v_new @ x
            w_hat = m - 0.5 * (_h(x) @ (x @ m))
            w = w_hat - _h(w_hat)
            norm1 = w.abs().sum(dim=-2).amax(dim=-1)
            alpha = torch.clamp(1.0 / (norm1 + EPS), max=self.lr)
            half = (alpha / 2).to(w.dtype)[..., None, None]
            eye = torch.eye(cols, dtype=w.dtype, device=w.device)
            y = torch.linalg.solve(eye - half * w, (eye + half * w) @ _h(x))
            new[name] = _h(y).reshape(p.shape)
            self.buf[name] = w @ _h(x)
        self.count += 1
        return new


def first_retraction_step(shapes: Dict[str, Tuple[int, ...]], seed: int,
                          limit: int = 100_000) -> int:
    """The index of the first step at which a draw retracts, for leaves of
    ``shapes`` and the optimizer's ``seed``."""
    opt = SGDG(0.0, 0.0, seed)
    for step in range(limit):
        if any(opt.draws(shapes).values()):
            return step
    raise ValueError(f"no retraction in {limit} steps")
