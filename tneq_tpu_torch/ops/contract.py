"""Contraction helpers.  Counterpart of ``tneq_tpu/ops/contract.py``.

Only :func:`abs_square` is ported so far.  The general einsum compute
functions (``make_siamese_fn``, ``siamese_probability``, ...) need
``ops/einsum_spec.py`` and wait for the brick-wall slice (ROADMAP A, item
7); on MPS chains the Born-rule path takes the transfer sweep
(``ops/mps_sweep.py``) instead.
"""

from __future__ import annotations

import torch

__all__ = ["abs_square"]


def abs_square(x: torch.Tensor) -> torch.Tensor:
    """|x|² as a real tensor (the Born rule)."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x * x
