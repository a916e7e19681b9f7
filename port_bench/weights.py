"""Random cores made on the device from a seed, in a few large calls.

Haar-orthogonal (real) or Haar-unitary (complex) cores: one Gaussian draw
and one batched QR per group of cores of one square size, the QR's phase
fixed so that R has a positive real diagonal, then each matrix sliced to
the isometry ``[in, out]`` of its core (``in`` = the product of the first
half of its axes, ``out`` of the rest) and reshaped to the core.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["haar_cores", "weights_generator"]

WEIGHTS_STREAM = 2 ** 32  # the weights' generator is seeded apart from the traffic's


def weights_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) + WEIGHTS_STREAM)


def _in_out(shape: Sequence[int]) -> Tuple[int, int]:
    k = len(shape)
    return int(np.prod(shape[: k // 2], dtype=np.int64)), int(np.prod(shape[k // 2:], dtype=np.int64))


def haar_cores(shapes: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """``{name: core}`` for ``{name: shape}``, drawn in name order."""
    groups: Dict[int, list] = {}
    for name in sorted(shapes):
        n = max(_in_out(shapes[name]))
        groups.setdefault(n, []).append(name)
    real = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
    out = {}
    for n, names in sorted(groups.items()):
        size = (len(names), n, n)
        a = torch.randn(size, generator=generator, dtype=real, device=device)
        if dtype.is_complex:
            a = torch.complex(a, torch.randn(size, generator=generator, dtype=real, device=device))
        q, r = torch.linalg.qr(a)
        d = torch.diagonal(r, dim1=-2, dim2=-1)
        phase = d / d.abs().clamp_min(1e-30) if dtype.is_complex else torch.sign(d)
        q = q * phase.conj().unsqueeze(-2)
        for j, name in enumerate(names):
            i, o = _in_out(shapes[name])
            out[name] = q[j, :i, :o].reshape(shapes[name]).to(dtype).contiguous()
    return out
