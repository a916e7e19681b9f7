"""Manifold math helpers.  Counterpart of ``tneq_tpu/optim/manifold.py``:
polar retraction, Stiefel tangent/normal projections, sphere exponential
map and parallel transport, the closed-form Cayley step."""

from __future__ import annotations

import torch

from .stiefel import _solve_unchecked, matrix_norm_one, qr_retraction, unit_rows

__all__ = [
    "sym",
    "skew",
    "polar_retraction",
    "stiefel_project_tangent",
    "stiefel_project_normal",
    "sphere_exp",
    "sphere_transport",
    "cayley_step",
    "qr_retraction",
    "matrix_norm_one",
    "unit_rows",
]


def sym(y: torch.Tensor) -> torch.Tensor:
    return (y + y.conj().T) / 2


def skew(y: torch.Tensor) -> torch.Tensor:
    return (y - y.conj().T) / 2


def polar_retraction(tan: torch.Tensor) -> torch.Tensor:
    """Polar retraction of a (p, n) matrix, p <= n."""
    u, _, vh = torch.linalg.svd(tan, full_matrices=False)
    return u @ vh


def stiefel_project_tangent(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Project g onto the tangent space of the Stiefel point y
    (row-orthonormal (p, n))."""
    return g - sym(y @ g.conj().T) @ y


def stiefel_project_normal(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Normal-space component."""
    return sym(y @ g.conj().T) @ y


def sphere_exp(y: torch.Tensor, h: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise sphere exponential map."""
    norm = torch.linalg.norm(h, dim=1, keepdim=True)
    u = h / (norm + eps)
    return y * torch.cos(norm) + u * torch.sin(norm)


def sphere_transport(y: torch.Tensor, h: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Parallel transport of h along itself on the sphere."""
    norm = torch.linalg.norm(h, dim=1, keepdim=True)
    u = h / (norm + eps)
    return (u * torch.cos(norm) - y * torch.sin(norm)) * norm


def cayley_step(x: torch.Tensor, w: torch.Tensor, alpha) -> torch.Tensor:
    """Y = (I − α/2·W)⁻¹(I + α/2·W)·X via a linear solve, for W
    skew-Hermitian (the solve is not checked, as in JAX)."""
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    half = torch.as_tensor(alpha).to(w.real.dtype) / 2
    return _solve_unchecked(eye - half * w, (eye + half * w) @ x)
