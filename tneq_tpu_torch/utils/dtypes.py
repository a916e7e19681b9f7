"""Dtype policy: parameter / compute / output precision control.

Counterpart of ``tneq_tpu/utils/dtypes.py`` on torch dtypes: run real
networks with bfloat16 compute (the card's tensor cores) while keeping
float32 parameters and outputs.  Complex circuits stay complex64 (torch
has no complex bfloat16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

__all__ = ["Policy", "DEFAULT", "BF16_COMPUTE"]


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.complex64
    compute_dtype: torch.dtype = torch.complex64
    output_dtype: torch.dtype = torch.float32

    def cast_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.compute_dtype) for k, v in params.items()}

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)

    @property
    def is_complex(self) -> bool:
        return self.param_dtype.is_complex


DEFAULT = Policy()
BF16_COMPUTE = Policy(
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
    output_dtype=torch.float32,
)
