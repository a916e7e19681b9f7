"""The MPS Born-rule trainer, plainly.

The chain of ``n`` qubits has ``n − 1`` cores named ``a, b, …``; core ``i``
couples qubits ``i`` and ``i + 1``.  Its axes are its in-legs then its
out-legs, each by ascending qubit: the first core ``[s₀, s₁, o₀, b₀]``, a
middle core ``[b_{i−1}, s_{i+1}, o_i, b_i]``, the last ``[b_{n−3}, s_{n−1},
o_{n−2}, o_{n−1}]`` (``s``: an input leg, ``o``: an output leg, ``b``: a
bond).  Every input leg takes the basis state with its 1 in the last slot.

``ψ(x)`` of a sample ``x`` (one real number per qubit) is the chain
contracted with the Hermite features ``φ(x_q)`` on the output legs:

    φ_k(x) = (2π)^(−1/4) · exp(−x²/4) · He_k(x) / √(k!),   k < K,

``He_k`` the probabilists' Hermite polynomials (``He_{k+1} = x·He_k −
k·He_{k−1}``).  The measurement ``φφᵀ`` contracts the chain with its
mirror to ``s(x) = ψ(x)²``.  The probability is ``s`` for real cores and
``|s|² = |ψ|⁴`` for complex ones: the Born rule taken on the siamese
value, as the upstream engine (``engine_siamese``) and the system define
it.  The loss is ``−mean(log max(P, 1e−10))`` over the batch, and each
step takes SGD-G (``sgdg.py``).

``tf32=True`` computes the contraction as TF32 matmuls do: every operand of
the chain's products rounded to TF32's 10-bit mantissa (nearest), the sums
kept in the operands' type.  It is the control, the nearest precision
below float32 with TF32 off, taken whatever the card's libraries choose
for such small products.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .sgdg import SGDG

__all__ = ["features", "probability", "nll", "train", "step_from", "to_tf32"]

LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
PROB_FLOOR = 1e-10


def core_names(n_qubits: int) -> List[str]:
    return [LETTERS[i] for i in range(n_qubits - 1)]


def features(x: torch.Tensor, K: int) -> torch.Tensor:
    """``φ(x)``: ``[B, n] -> [B, n, K]`` in ``x``'s dtype."""
    he = [torch.ones_like(x), x]
    for k in range(1, K - 1):
        he.append(x * he[k] - k * he[k - 1])
    norm = torch.tensor([math.sqrt(math.factorial(k)) for k in range(K)],
                        dtype=x.dtype, device=x.device)
    h = torch.stack(he[:K], dim=-1) / norm
    return (2 * math.pi) ** -0.25 * torch.exp(-x * x / 4)[..., None] * h


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) rounded to TF32's 10-bit mantissa, to
    nearest; the gradient passes through unchanged."""
    r = torch.view_as_real(x) if x.is_complex() else x
    bits = r.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    rounded = torch.view_as_complex(rounded) if x.is_complex() else rounded
    return x + (rounded - x).detach()


def probability(cores: Dict[str, torch.Tensor], x: torch.Tensor, K: int,
                tf32: bool = False) -> torch.Tensor:
    """``P(x)`` for each row of ``x`` ``[B, n]``: ``ψ²`` for real cores,
    ``|ψ|⁴`` for complex ones."""
    n = x.shape[1]
    names = core_names(n)
    dtype = cores[names[0]].dtype
    phi = features(x, K).to(dtype)
    r = to_tf32 if tf32 else (lambda t: t)
    last = -1  # the basis state's slot
    a0 = cores[names[0]][last, last]  # [o0, b0]
    v = r(phi[:, 0]) @ r(a0)  # [B, b0]
    for i in range(1, n - 2):
        a = cores[names[i]][:, last]  # [b, o, b']
        v = torch.einsum("zb,zo,bof->zf", r(v), r(phi[:, i]), r(a))
    a = cores[names[n - 2]][:, last]  # [b, o_{n-2}, o_{n-1}]
    psi = torch.einsum("zb,zo,zp,bop->z", r(v), r(phi[:, n - 2]), r(phi[:, n - 1]), r(a))
    s = psi * psi
    return s.real ** 2 + s.imag ** 2 if s.is_complex() else s


def nll(cores: Dict[str, torch.Tensor], x: torch.Tensor, K: int,
        tf32: bool = False) -> torch.Tensor:
    return -torch.log(torch.clamp(probability(cores, x, K, tf32), min=PROB_FLOOR)).mean()


def _grads(params, x, K, half_batch, tf32):
    leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
    loss = nll(leaves, x[: len(x) // 2] if half_batch else x, K, tf32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return float(loss.detach()), grads


def train(cores: Dict[str, torch.Tensor], batches: List[torch.Tensor], K: int, steps: int,
          lr: float, momentum: float, seed: int, half_batch: bool = False,
          tf32: bool = False):
    """``steps`` training steps on ``batches`` in turn.  Returns each step's
    loss, the optimizer's state after the first step (``{name: tensor}``),
    the norm of the first step's gradient per core and the cores after the
    last step.  ``half_batch`` takes the loss over the first half of each
    batch only: a fault, for reading what it does to the compared numbers;
    ``tf32`` is the control."""
    opt = SGDG(lr, momentum, seed)
    params = {n: v.clone() for n, v in cores.items()}
    losses, first_state, first_grad = [], None, None
    for s in range(steps):
        loss, grads = _grads(params, batches[s % len(batches)], K, half_batch, tf32)
        if first_grad is None:
            first_grad = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
        losses.append(loss)
        with torch.no_grad():
            params = opt.step({n: v.detach() for n, v in params.items()}, grads)
        if first_state is None:
            first_state = {n: v.clone() for n, v in opt.buf.items()}
    return losses, first_state, first_grad, params


def step_from(params: Dict[str, torch.Tensor], buf: Dict[str, torch.Tensor], count: int,
              x: torch.Tensor, K: int, lr: float, momentum: float, seed: int,
              half_batch: bool = False, tf32: bool = False):
    """Step ``count`` (0-based) from another trainer's state after ``count``
    steps: its cores ``params`` and its optimizer buffers ``buf``, with this
    seed's retraction draws.  Returns the loss, the norm of the gradient per
    core and the cores after the step."""
    opt = SGDG(lr, momentum, seed)
    opt.resume(buf, count, {n: tuple(v.shape) for n, v in params.items()})
    loss, grads = _grads(params, x, K, half_batch, tf32)
    with torch.no_grad():
        new = opt.step({n: v.detach() for n, v in params.items()}, grads)
    return loss, {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}, new
