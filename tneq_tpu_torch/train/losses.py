"""Loss functions: fidelity against a target tensor, data negative
log-likelihood.  Counterpart of ``tneq_tpu/train/losses.py``."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["fidelity", "fidelity_loss", "nll_loss"]

PROB_CLIP = 1e-10  # probabilities below this give the loss -log(1e-10) and no gradient


def fidelity(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|⟨t,o⟩|² / (⟨t,t⟩·⟨o,o⟩), flattening both tensors; the denominator
    is clamped at 1e-12."""
    o = out.reshape(-1)
    t = target.reshape(-1)
    overlap = torch.vdot(t, o)
    num = overlap.real ** 2 + (overlap.imag ** 2 if overlap.is_complex() else 0.0)
    den = torch.clamp(torch.vdot(t, t).real * torch.vdot(o, o).real, min=1e-12)
    return num / den


def fidelity_loss(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - fidelity."""
    return 1.0 - fidelity(out, target)


def nll_loss(probs: torch.Tensor, log_scale: Union[torch.Tensor, float] = 0.0) -> torch.Tensor:
    """-mean(log(P·S)) with the scale's log detached.

    Probabilities are clamped at 1e-10 as JAX clips them: below the clamp a
    sample contributes -log(1e-10) and a zero gradient.
    """
    probs = torch.clamp(probs.real if probs.is_complex() else probs, min=PROB_CLIP)
    log_scale = torch.as_tensor(log_scale, dtype=probs.dtype, device=probs.device).detach()
    return -torch.mean(torch.log(probs) + log_scale)
