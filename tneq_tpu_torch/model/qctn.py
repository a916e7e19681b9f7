"""Core initialisation, the numpy bridge for parameter dicts, and the
``QCTN`` wrapper.

Counterpart of ``tneq_tpu/model/qctn.py`` (``orthogonal_core``,
``init_params``, ``QCTN``).  Parameters are plain ``{core_name: Tensor}`` dicts with
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

import warnings
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, parse_graph, render_dsl
from ..graph.surgery import merge_graphs, split_graph
from ..ops.contract import (
    contract_cores,
    make_two_network_fn,
    make_with_inputs_fn,
    siamese_probability,
)
from ..utils._safetensors import load_file, save_file
from ..utils.checkpoint import cores_from_tensors, cores_to_tensors
from ..utils.device import DeviceLike, resolve_device

__all__ = [
    "QCTN",
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


class QCTN:
    """Quantum Circuit Tensor Network: immutable graph + parameter dict.

    Counterpart of the JAX ``QCTN``: JAX's ``key=`` becomes an integer
    ``seed`` (drawn with :func:`init_params`), plus ``device=``.  The
    contraction conveniences run through ``ops/contract.py``, the surgery
    methods (``split``, ``merge_with``, ``merge``) through
    ``graph/surgery.py``; their halves and merges live on this model's
    device and carry its cores unchanged.  Checkpoints: ``save_cores``,
    ``load_cores`` and ``from_pretrained`` (safetensors files under the
    reference's core names, ``utils/checkpoint.py``).
    """

    def __init__(
        self,
        graph: Union[str, CircuitGraph],
        params: Optional[Mapping[str, torch.Tensor]] = None,
        *,
        seed: int = 0,
        dtype: torch.dtype = torch.complex64,
        device: DeviceLike = "cuda",
    ):
        self.graph = parse_graph(graph) if isinstance(graph, str) else graph
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            params = init_params(self.graph, seed, dtype, self.device)
        self.params: Params = dict(params)

    # -- views ------------------------------------------------------------

    @property
    def nqubits(self) -> int:
        return self.graph.nqubits

    @property
    def ncores(self) -> int:
        return self.graph.ncores

    @property
    def cores(self):
        return self.graph.core_names

    def __repr__(self):
        return (
            f"QCTN(nqubits={self.nqubits}, ncores={self.ncores}, "
            f"cores={list(self.cores)}, dtype={str(self.dtype).split('.')[-1]})"
        )

    def copy(self) -> "QCTN":
        return QCTN(self.graph, dict(self.params), dtype=self.dtype, device=self.device)

    # -- weight assignment --------------------------------------------------

    def set_cores(self, cores, strict: bool = True) -> None:
        """Set weights from a list (positional) or dict (by name).  A tensor
        of the core's element count but another shape is reshaped."""
        if isinstance(cores, (list, tuple)):
            if strict and len(cores) != self.ncores:
                raise ValueError(
                    f"strict: expected {self.ncores} tensors, got {len(cores)}"
                )
            n = min(len(cores), self.ncores)
            if len(cores) != self.ncores:
                warnings.warn(
                    f"setting only the first {n} of {self.ncores} cores",
                    stacklevel=2,
                )
            for i in range(n):
                self._set_one(self.cores[i], cores[i])
        elif isinstance(cores, dict):
            given, mine = set(cores), set(self.cores)
            if strict and given != mine:
                raise ValueError(
                    f"strict: key mismatch — missing {mine - given}, "
                    f"extra {given - mine}"
                )
            for extra in given - mine:
                warnings.warn(f"ignoring extra core {extra!r}", stacklevel=2)
            for name in mine & given:
                self._set_one(name, cores[name])
        else:
            raise TypeError(f"cores must be list or dict, got {type(cores).__name__}")

    def _set_one(self, name: str, tensor) -> None:
        target_shape = self.graph.shapes[name]
        arr = torch.as_tensor(tensor)
        if arr.numel() != int(np.prod(target_shape, dtype=np.int64)):
            raise ValueError(
                f"core {name!r}: size mismatch {tuple(arr.shape)} vs {target_shape}"
            )
        self.params[name] = arr.reshape(target_shape).to(dtype=self.dtype, device=self.device)

    # -- contraction conveniences ------------------------------------------

    def contract_core_only(self, order: str = "reference"):
        """Dense circuit tensor with open boundary legs."""
        return contract_cores(self.graph, self.params, order)

    def contract_with_inputs(self, states, batched: bool = False):
        """Apply the circuit to per-qubit input vectors."""
        return make_with_inputs_fn(self.graph, batched)(self.params, states)

    def contract_with_self(self, states, measures):
        """Siamese Born-rule probability (batched states where any state
        is 2-D)."""
        batched = any(getattr(s, "ndim", 1) == 2 for s in states)
        return siamese_probability(
            self.graph, self.params, states, measures, states_batched=batched
        )

    def contract_with_qctn(self, other: "QCTN", conj_target: bool = False):
        """Scalar overlap with another circuit."""
        return make_two_network_fn(self.graph, other.graph, conj_target)(
            self.params, other.params
        )

    # -- checkpoint I/O -----------------------------------------------------

    def save_cores(
        self,
        file_path: Union[str, Path],
        metadata: Optional[Mapping[str, str]] = None,
    ) -> None:
        """Save to safetensors with the reference's real/imag split naming
        (``utils/checkpoint.py``); ``metadata`` is stored as strings."""
        meta = {str(k): str(v) for k, v in (metadata or {}).items()}
        save_file(cores_to_tensors(self.params), file_path, metadata=meta)

    def load_cores(self, file_path: Union[str, Path], strict: bool = True) -> Dict[str, str]:
        """Load this graph's cores from a safetensors file onto the model's
        device, in its dtype; returns the file's metadata.  ``strict``: a
        core missing from the file raises ``KeyError`` (otherwise it keeps
        its current value)."""
        tensors, meta = load_file(file_path)
        cores = cores_from_tensors(tensors)
        for name in self.cores:
            if name in cores:
                self.params[name] = torch.as_tensor(cores[name]).to(
                    dtype=self.dtype, device=self.device)
            elif strict:
                raise KeyError(f"missing tensor for core {name!r} in {file_path}")
        return meta

    @classmethod
    def from_pretrained(
        cls,
        graph: Union[str, CircuitGraph],
        file_path: Union[str, Path],
        dtype: torch.dtype = torch.complex64,
        strict: bool = True,
        device: DeviceLike = "cuda",
    ) -> "QCTN":
        """A model of ``graph`` with its cores loaded from ``file_path``."""
        model = cls(graph, dtype=dtype, device=device)
        model.load_cores(file_path, strict=strict)
        return model

    # -- surgery --------------------------------------------------------------

    def split(self, split_idx: Optional[int] = None):
        """Split into two QCTNs at core index (weights carried over)."""
        src1, src2 = split_graph(self._render(), split_idx)
        halves = (QCTN(src1, dtype=self.dtype, device=self.device),
                  QCTN(src2, dtype=self.dtype, device=self.device))
        for q in halves:
            for name in q.cores:
                if name in self.params:
                    q.params[name] = self.params[name]
        return halves

    def merge_with(self, other: "QCTN") -> "QCTN":
        """Left-right merge; cores renamed contiguously, weights carried."""
        merged_src, map1, map2 = merge_graphs(self._render(), other._render())
        out = QCTN(merged_src, dtype=self.dtype, device=self.device)
        for src, mapping in ((self, map1), (other, map2)):
            for old, new in mapping.items():
                if old in src.params:
                    out.params[new] = src.params[old]
        return out

    @staticmethod
    def merge(q1: "QCTN", q2: "QCTN") -> "QCTN":
        return q1.merge_with(q2)

    def _render(self) -> str:
        return self.graph.source or render_dsl(self.graph)
