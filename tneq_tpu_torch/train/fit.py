"""Masked fidelity fits against a dense target, and their helpers.

Counterpart of ``tneq_tpu/train/fit.py``: ``identity_cores``,
``_pair_by_kind``, ``transparent_cores``, ``FitResult``,
``pair_identity_cores`` and :func:`make_masked_fidelity_fit` with its
stacked-real pair form (``complex_as_real=True``) and its vmapped
``.batched`` lanes.

A pruned core is substituted by an identity-like core through a mask
(``effective = mask·params + (1-mask)·identity``,
:func:`masked_cores`), so every pruning candidate runs the same fit.  As in
JAX the substitution cores are host numpy constants; a fit moves them to
its device once, when it is built.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value

from ..graph.dsl import CircuitGraph
from ..ops.complex_pair import make_pair_core_only_fn, pair_fidelity
from ..ops.contract import make_core_only_fn
from ..optim.stiefel import GradientTransformation
from ..utils.device import DeviceLike, resolve_device
from ._fit_driver import FitDrivers
from .losses import fidelity

__all__ = [
    "identity_cores",
    "transparent_cores",
    "masked_cores",
    "make_masked_fidelity_fit",
    "FitResult",
    "numpy_dtype",
    "pair_identity_cores",
    "functional_step",
]


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
    infidelity: torch.Tensor  # 1 - fidelity at exit (per lane for .batched)
    steps: int  # updates applied
    opt_state: object


def pair_identity_cores(graph: CircuitGraph):
    """Pair-form identity gates (host numpy, float32): real part I, imaginary
    part 0.  Used by the complex-as-real fits (``ops/complex_pair.py``)."""
    out = {}
    for core in graph.cores:
        if core.input_dim != core.output_dim:
            raise ValueError(
                f"core {core.name!r} has input_dim {core.input_dim} != "
                f"output_dim {core.output_dim}; identity masking undefined"
            )
        eye = np.eye(core.input_dim, dtype=np.float32).reshape(core.shape)
        out[core.name] = np.stack([eye, np.zeros_like(eye)])
    return out


def functional_step(loss_fn: Callable, optimizer: GradientTransformation) -> Callable:
    """``step(params, opt_state, *args) -> (params, opt_state, metric)`` for
    ``loss_fn(params, *args) -> (loss, metric)``: ``torch.func`` gradient of
    the loss, then the optimizer's update.  Pure, so ``FitDrivers.batched``
    can vmap it over lanes; the scalar scopes run the same function."""
    grad_fn = grad_and_value(loss_fn, has_aux=True)

    def step(params, opt_state, *args):
        grads, (_, metric) = grad_fn(params, *args)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return {k: params[k] + updates[k] for k in params}, opt_state, metric

    return step


def masked_cores(
    params: Mapping[str, torch.Tensor],
    mask: torch.Tensor,
    idents: Mapping[str, torch.Tensor],
    names,
    dtype: torch.dtype,
) -> dict:
    """``mask[i]·params_i + (1 − mask[i])·identity_i`` for core ``names[i]``:
    1 keeps the trained core, 0 substitutes its identity."""
    keep, drop = mask.to(dtype), (1.0 - mask).to(dtype)
    return {n: keep[i] * params[n] + drop[i] * idents[n] for i, n in enumerate(names)}


def make_masked_fidelity_fit(
    graph: CircuitGraph,
    optimizer: GradientTransformation,
    max_steps: int,
    tol: float = 1e-3,
    dtype: torch.dtype = torch.complex64,
    order: str = "reference",
    loss_kind: str = "raw",
    complex_as_real: bool = False,
    jit_scope: str = "fit",
    sync_every: int = 1,
    matmul_precision: str = "highest",
    device: DeviceLike = "cuda",
) -> Callable:
    """Build ``fit(params, mask, target) -> FitResult``.

    - ``mask``: float vector ``(ncores,)`` — 1 keeps the trained core, 0
      substitutes the identity gate (pruned).
    - ``target``: dense target tensor with the graph's boundary legs (in
      ``order`` axis convention), on ``device``.
    - The loop exits once ``1 - fidelity < tol``; ``loss_kind='raw'``
      minimises 1 − F (the reference objective), ``'log'`` −log F.
    - ``complex_as_real``: params and target are stacked-real pairs
      (``[2, *shape]``, ``ops/complex_pair.py``) and the fit runs on real
      tensors only; pass a pair optimizer (``optim.pair_stiefel.pair_sgdg``).
    - ``jit_scope`` keeps the JAX names and selects the driver: 'fit' tests
      the exit before every step, 'step' every ``sync_every`` steps,
      'chunk' after whole ``sync_every``-step chunks (``_fit_driver``).
    - ``matmul_precision`` ('highest' default: full f32, TF32 off) holds
      within the fit only.  ``device``: where the identity cores live — the
      params, mask and target handed to ``fit`` must be there too.

    ``fit.batched(params, masks, target, chunk_steps=0)`` runs one lane per
    row of ``masks`` in lockstep from ``params`` (``FitDrivers.batched``).
    """
    if jit_scope not in ("fit", "step", "chunk"):
        raise ValueError(
            f"jit_scope must be 'fit', 'step' or 'chunk', got {jit_scope!r}"
        )
    if loss_kind not in ("raw", "log"):
        raise ValueError(f"loss_kind must be 'raw' or 'log', got {loss_kind!r}")
    dev = resolve_device(device)
    if complex_as_real:
        core_fn, fid_fn = make_pair_core_only_fn(graph, order), pair_fidelity
        cast, idents_np = torch.float32, pair_identity_cores(graph)
    else:
        core_fn, fid_fn = make_core_only_fn(graph, order), fidelity
        cast, idents_np = dtype, identity_cores(graph, dtype)
    idents = {k: torch.as_tensor(v).to(device=dev, dtype=cast) for k, v in idents_np.items()}
    names = graph.core_names

    def loss_fn(params, mask, target):
        """(loss, 1 − F): 'log' gives a scale-free gradient where a cold
        start sits at F ~ 2^-2n and the raw gradient ∝ F dies."""
        fid = fid_fn(core_fn(masked_cores(params, mask, idents, names, cast)), target)
        if loss_kind == "log":
            return -torch.log(fid + 1e-30), 1.0 - fid
        return 1.0 - fid, 1.0 - fid

    drivers = FitDrivers(
        functional_step(loss_fn, optimizer), optimizer, max_steps, sync_every,
        running=lambda infid: infid >= tol, init_metric=1.0,
        matmul_precision=matmul_precision,
    )
    run = {"fit": drivers.fit_while, "step": drivers.fit_host,
           "chunk": drivers.fit_chunked}[jit_scope]

    def fit(params, mask, target) -> FitResult:
        p, o, steps, infid = run(params, mask, target)
        return FitResult(p, infid, steps, o)

    def batched(params, masks, target, chunk_steps: int = 0) -> FitResult:
        """Lockstep lanes over mask rows (see ``FitDrivers.batched``)."""
        p_b, o_b, steps, infid_b = drivers.batched(params, masks, target,
                                                   chunk_steps=chunk_steps)
        return FitResult(p_b, infid_b, steps, o_b)

    fit.batched = batched
    fit.scope = jit_scope
    fit.drivers = drivers  # its step is one update, for measuring a step alone
    return fit
