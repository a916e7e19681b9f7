"""Masked-fit helpers: identity / transparent substitution cores and the fit
result.  Counterpart of ``tneq_tpu/train/fit.py`` (``identity_cores``,
``_pair_by_kind``, ``transparent_cores``, ``FitResult``); the dense
``make_masked_fidelity_fit`` waits for the brick-wall slice.

A pruned core is substituted by an identity-like core through a mask
(``effective = mask·params + (1-mask)·identity``), so every pruning
candidate runs the same fit.  As in JAX the substitution cores are host
numpy constants; the fits move them to their device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph

__all__ = ["identity_cores", "transparent_cores", "FitResult", "numpy_dtype"]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (``torch.complex64`` -> complex64)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def identity_cores(graph: CircuitGraph, dtype=torch.complex64):
    """Per-core identity gates: I reshaped to the core's (in+out) shape
    (requires input_dim == output_dim per core)."""
    out = {}
    for core in graph.cores:
        if core.input_dim != core.output_dim:
            raise ValueError(
                f"core {core.name!r} has input_dim {core.input_dim} != "
                f"output_dim {core.output_dim}; identity masking undefined"
            )
        eye = np.eye(core.input_dim, dtype=numpy_dtype(dtype))
        out[core.name] = eye.reshape(core.shape)
    return out


def _pair_by_kind(core) -> list:
    """Kind-preserving leg pairing: interior (bond, ``neighbor >= 0``) in
    legs pair only with interior out legs, boundary (``neighbor == -1``)
    only with boundary, equal rank required, same qubit preferred within a
    kind.  Returns ``[]`` when no complete pairing exists."""
    n_in, n_out = len(core.in_edges), len(core.out_edges)
    if n_in != n_out:
        return []
    pairs, used = [], set()
    for i, e_in in enumerate(core.in_edges):
        kind_in = e_in.neighbor >= 0
        candidates = [
            j for j, e_out in enumerate(core.out_edges)
            if j not in used and e_out.rank == e_in.rank
            and (e_out.neighbor >= 0) == kind_in
        ]
        if not candidates:
            return []
        j = min(candidates,
                key=lambda j: (core.out_edges[j].qubit != e_in.qubit, j))
        used.add(j)
        pairs.append((i, j))
    return pairs


def transparent_cores(graph: CircuitGraph, dtype=torch.complex64, *,
                      pairing: str = "auto"):
    """Pass-through ("transparent") identity cores for general core shapes:
    the product of Kronecker deltas over a one-to-one pairing of input and
    equal-rank output legs.

    ``pairing='auto'`` (gate-style graphs) prefers positional pairing and
    falls back to first-equal-rank matching; ``'kind'`` (chain/MPS graphs)
    pairs bond legs with bond legs and boundary legs with boundary legs at
    every bond rank, so a masked interior MPS core contracts away as a
    trivial site.  Returns ``(idents, unmaskable)``: cores with no perfect
    pairing get ZERO tensors (masking one zeroes every overlap) and are
    listed in ``unmaskable``.
    """
    if pairing not in ("auto", "kind"):
        raise ValueError(f"unknown pairing {pairing!r} "
                         "(expected 'auto' or 'kind')")
    np_dt = numpy_dtype(dtype)
    idents, unmaskable = {}, []
    for core in graph.cores:
        n_in, n_out = len(core.in_edges), len(core.out_edges)
        pairs, used = [], set()
        if pairing == "kind":
            pairs = _pair_by_kind(core)
        elif n_in == n_out:
            if all(core.in_edges[k].rank == core.out_edges[k].rank
                   for k in range(n_in)):
                pairs = [(k, k) for k in range(n_in)]
            else:
                for i in range(n_in):
                    j = next(
                        (j for j in range(n_out)
                         if j not in used
                         and core.out_edges[j].rank == core.in_edges[i].rank),
                        None,
                    )
                    if j is None:
                        pairs = []
                        break
                    used.add(j)
                    pairs.append((i, j))
        if not pairs and (n_in or n_out):
            unmaskable.append(core.index)
            idents[core.name] = np.zeros(core.shape, np_dt)
            continue
        terms, operands = [], []
        out_letters = [None] * n_out
        for i, j in pairs:
            a, b = chr(ord("a") + i), chr(ord("A") + j)
            out_letters[j] = b
            terms.append(a + b)
            operands.append(np.eye(core.in_edges[i].rank, dtype=np.float64))
        eq = (",".join(terms) + "->"
              + "".join(chr(ord("a") + i) for i in range(n_in))
              + "".join(out_letters))
        idents[core.name] = np.einsum(eq, *operands).astype(np_dt)
    return idents, tuple(unmaskable)


class FitResult(NamedTuple):
    params: dict
    infidelity: torch.Tensor  # 1 - fidelity at exit
    steps: int  # updates applied
    opt_state: object
