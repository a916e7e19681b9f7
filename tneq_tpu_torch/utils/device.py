"""Device resolution and matmul-precision scoping for the port's entry points.

Entry points default to ``device="cuda"``.  On a machine without a visible
CUDA device they raise rather than carry on silently on the host: the CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

__all__ = ["resolve_device", "matmul_precision"]

DeviceLike = Union[str, torch.device]

# the JAX fits' ``jax.default_matmul_precision`` names -> torch's float32
# matmul precision ('highest' = full f32, TF32 off)
_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for on
    a machine that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tneq_tpu_torch: no CUDA device is visible. Entry points run on "
            "the card by default; pass device='cpu' to run the plain "
            "PyTorch path on the host."
        )
    return dev


@contextlib.contextmanager
def matmul_precision(name: str = "highest") -> Iterator[None]:
    """Scope ``torch.set_float32_matmul_precision`` to a block, mapping the
    JAX names: 'highest' -> full f32 (TF32 off), 'high' -> 'high',
    'default' -> 'medium'.  The previous setting is restored on exit."""
    if name not in _PRECISION:
        raise ValueError(
            f"matmul_precision must be one of {sorted(_PRECISION)}, got {name!r}"
        )
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_PRECISION[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
