"""Core initialisation and the numpy bridge for parameter dicts.

Counterpart of ``tneq_tpu/model/qctn.py`` (``orthogonal_core`` and
``init_params``).  Parameters are plain ``{core_name: Tensor}`` dicts with
the JAX package's axis order (``graph/dsl.py``: in-edges, then out-edges,
by ascending qubit), so the same numpy dict feeds both packages through
:func:`params_from_numpy` / :func:`params_to_numpy`.

``jax.random`` keys become explicit ``torch.Generator``s.  The two streams
differ from the same seed: tests hand both packages numpy-drawn weights and
never compare the streams.  Draws and the QR run on the host generator and
the host CPU, then move to ``device``, so one seed gives the same cores on
every device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..graph.dsl import CircuitGraph
from ..utils.device import DeviceLike, resolve_device

__all__ = [
    "init_params",
    "orthogonal_core",
    "params_from_numpy",
    "params_to_numpy",
]

Params = Dict[str, torch.Tensor]
GeneratorLike = Union[int, torch.Generator]


def _generator(gen: GeneratorLike) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def orthogonal_core(
    generator: GeneratorLike,
    shape: Sequence[int],
    dtype: torch.dtype = torch.complex64,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Haar-orthogonal (real) or Haar-unitary (complex) core with the QR
    phase correction, sliced to an isometry for non-square cores — the
    same construction as the JAX ``orthogonal_core``."""
    dev = resolve_device(device)
    gen = _generator(generator)
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    in_dim = int(np.prod(shape[: ndim // 2], dtype=np.int64)) if ndim else 1
    out_dim = int(np.prod(shape[ndim // 2 :], dtype=np.int64)) if ndim else 1
    n = max(in_dim, out_dim)
    if dtype.is_complex:
        real_dt = torch.float32 if dtype == torch.complex64 else torch.float64
        re = torch.randn((n, n), generator=gen, dtype=real_dt)
        im = torch.randn((n, n), generator=gen, dtype=real_dt)
        a = torch.complex(re, im).to(dtype)
    else:
        a = torch.randn((n, n), generator=gen, dtype=dtype)
    q, r = torch.linalg.qr(a)
    d = torch.diagonal(r)
    if dtype.is_complex:
        q = q * torch.conj(d / (d.abs() + 1e-12))[None, :]
    else:
        q = q * torch.sign(d)[None, :]
    return q[:in_dim, :out_dim].reshape(shape).contiguous().to(dev)


def init_params(
    graph: CircuitGraph,
    generator: GeneratorLike,
    dtype: torch.dtype = torch.complex64,
    device: DeviceLike = "cuda",
) -> Params:
    """Per-core orthogonal initialisation, cores drawn in graph order from
    one generator (an int seeds a fresh one)."""
    dev = resolve_device(device)
    gen = _generator(generator)
    return {
        core.name: orthogonal_core(gen, core.shape, dtype, dev)
        for core in graph.cores
    }


def params_from_numpy(
    params: Mapping[str, np.ndarray],
    device: DeviceLike,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """``{name: ndarray}`` -> ``{name: Tensor}`` on ``device`` (optionally
    cast to ``dtype``), in the shared axis order."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(v)).to(device=dev, dtype=dtype)
        for k, v in params.items()
    }


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{name: Tensor}`` -> ``{name: ndarray}`` (detached, on the host)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
