"""Hermite-polynomial feature maps (measurement-operator construction).

Counterpart of ``tneq_tpu/ops/features.py``: the normalised Hermite
functions φ_k(x) = (2π)^(-¼)·exp(-x²/4)·h̃_k(x) with h̃_k = He_k/√(k!),
computed by the float32-stable recurrence

    h̃_k = x·h̃_{k-1}/√k − √((k-1)/k)·h̃_{k-2},   h̃_0 = 1, h̃_1 = x.

JAX's ``lax.scan`` over k becomes a host loop (K is small); its per-k
coefficients are float32 scalars, as JAX computes them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["hermite_weights", "hermite_phi", "measurement_matrices", "generate_data"]


def hermite_weights(
    k_max: int, dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """Normalisation weights w_k = exp(-½(½·log 2π + log k!)), k = 0..k_max."""
    log_factorial = np.array(
        [math.lgamma(k + 1.0) for k in range(k_max + 1)], dtype=np.float64
    )
    log_factor = -0.5 * (0.5 * np.log(2.0 * np.pi) + log_factorial)
    return torch.as_tensor(np.exp(log_factor), dtype=dtype, device=resolve_device(device))


def hermite_phi(x, K: int) -> torch.Tensor:
    """Feature vectors φ(x): ``[B, D] -> [B, D, K]`` float32, on ``x``'s
    device.  Complex input takes its real part."""
    x = torch.as_tensor(x)
    if x.is_complex():
        x = x.real
    x = x.to(torch.float32)
    hs = [torch.ones_like(x)]
    if K > 1:
        hs.append(x)
    for k in range(2, K):
        kf = np.float32(k)
        c1 = float(np.sqrt(kf))
        c2 = float(np.sqrt((kf - np.float32(1.0)) / kf))
        hs.append(x * hs[-1] / c1 - c2 * hs[-2])
    h = torch.stack(hs, dim=-1)  # [B, D, K]
    gauss = torch.exp(-torch.square(x) / 4.0)
    return (2.0 * math.pi) ** (-0.25) * gauss[..., None] * h


def measurement_matrices(x, K: int) -> torch.Tensor:
    """Per-qubit rank-1 measurement operators
    ``Mx[b, d, k, l] = φ_k(x[b,d])·φ_l(x[b,d])``: ``[B, D] -> [B, D, K, K]``."""
    phi = hermite_phi(x, K)
    return phi[..., :, None] * phi[..., None, :]


def generate_data(
    x, K: int, dtype: Optional[torch.dtype] = None
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(Mx_list, phi)``: a per-qubit list of ``[B, K, K]`` operators and
    the ``[B, D, K]`` features, optionally cast to ``dtype`` (complex dtypes
    take the real values)."""
    mx = measurement_matrices(x, K)
    phi = hermite_phi(x, K)
    if dtype is not None:
        mx = mx.to(dtype)
        phi = phi.to(dtype)
    return [mx[:, q] for q in range(mx.shape[1])], phi
