"""Backend compatibility shim for users migrating from the reference.

Counterpart of ``tneq_tpu/backend.py``.  The reference routes every tensor
op through a ``ComputeBackend`` ABC with torch/jax implementations and a
factory (``tneq_qc/backends/backend_interface.py:48``,
``backend_factory.py:34``).  This package has exactly one backend —
PyTorch, on the card by default — so the ABC dissolves; this module keeps
the *entry points* familiar so reference code ports with minimal edits.
Each method is a thin delegation to torch / the ops layer.

Gradients of a real loss with respect to complex tensors follow torch's
convention: the conjugate of ``jax.grad``'s.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device

__all__ = ["TorchBackend", "create_backend", "get_default_backend", "set_default_backend"]


class TorchBackend:
    """The reference ``ComputeBackend`` surface on torch (selected methods:
    the ones the reference's own code paths actually exercise)."""

    def __init__(self, dtype: torch.dtype = torch.complex64, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(seed)

    # -- info --------------------------------------------------------------

    @property
    def backend_info(self):
        return {
            "type": "pytorch",
            "device": self.device.type,
            "dtype": str(self.dtype).removeprefix("torch."),
        }

    def set_random_seed(self, seed: int) -> None:
        self._gen = torch.Generator().manual_seed(seed)

    # -- tensor ops --------------------------------------------------------

    def convert_to_tensor(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def tensor_to_numpy(self, x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    def einsum(self, equation: str, *operands) -> torch.Tensor:
        """Pairwise ``torch.einsum`` steps along the native path finder's
        path (``ops/contract.execute``)."""
        from .ops.contract import execute

        return execute(equation, operands)

    def reshape(self, x, shape) -> torch.Tensor:
        return torch.reshape(x, tuple(shape))

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def eye(self, n: int, dtype=None) -> torch.Tensor:
        return torch.eye(n, dtype=dtype or self.dtype, device=self.device)

    def is_complex(self, x) -> bool:
        return torch.is_complex(torch.as_tensor(x))

    def abs_square(self, x) -> torch.Tensor:
        from .ops.contract import abs_square

        return abs_square(x)

    def clamp(self, x, min=None, max=None) -> torch.Tensor:
        return torch.clamp(x, min=min, max=max)

    def log(self, x) -> torch.Tensor:
        return torch.log(x)

    def mean(self, x) -> torch.Tensor:
        return torch.mean(x)

    def detach(self, x) -> torch.Tensor:
        return x.detach()

    # -- autodiff / jit ----------------------------------------------------

    def compute_value_and_grad(self, fn, argnums=0):
        """``f(*args) -> (value, grad)``, JAX's order, through
        ``torch.func.grad_and_value``."""
        grad_and_value = torch.func.grad_and_value(fn, argnums=argnums)

        def value_and_grad(*args, **kwargs):
            g, v = grad_and_value(*args, **kwargs)
            return v, g

        return value_and_grad

    def jit_compile(self, fn):
        """``fn`` unchanged: the port runs eagerly (its hot loops launch
        hand-written kernels; there is no traced program to compile)."""
        return fn

    def execute_expression(self, fn, *args):
        return fn(*args)

    # -- model init --------------------------------------------------------

    def init_random_core(self, shape: Sequence[int]) -> torch.Tensor:
        from .model.qctn import orthogonal_core

        return orthogonal_core(self._gen, shape, self.dtype, self.device)

    # -- optimizer dispatch ------------------------------------------------

    def make_optimizer(self, method: str = "sgdg", **hyper):
        from .optim.factory import make_optimizer

        return make_optimizer(method, **hyper)


_default: Optional[TorchBackend] = None


def create_backend(backend_type: str = "pytorch", device: DeviceLike = "cuda",
                   dtype: torch.dtype = torch.complex64, **_) -> TorchBackend:
    """Factory with the reference's signature; only 'pytorch' exists here
    (requests for 'jax' get a clear error instead of a silent fallback)."""
    if backend_type not in ("pytorch", "torch"):
        raise ValueError(
            f"this package is the PyTorch port; backend {backend_type!r} "
            f"does not exist here (the JAX backend is the tneq_tpu package)"
        )
    return TorchBackend(dtype=dtype, device=device)


def get_default_backend() -> TorchBackend:
    global _default
    if _default is None:
        _default = TorchBackend()
    return _default


def set_default_backend(backend: TorchBackend) -> None:
    global _default
    _default = backend
