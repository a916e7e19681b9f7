"""Log-scale companions: ``(data, log_scale)`` pairs with max-abs-normalised
data.  Counterpart of ``tneq_tpu/ops/scaling.py`` (``Scaled``,
``auto_scale``); ``scaled_siamese_fn`` waits for the port of
``ops/contract.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Scaled", "auto_scale"]


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
