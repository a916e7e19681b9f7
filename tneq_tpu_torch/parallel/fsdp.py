"""Model-state sharding (ZeRO/FSDP-style): params and optimizer state split
across the ``model`` mesh axis.

Counterpart of ``tneq_tpu/parallel/fsdp.py``.  Cores are grouped by shape
and stacked into ``[n_cores, *core_shape]`` tensors.  A group of at least
``pad_to`` cores is padded with identity cores to a multiple of
``pad_to`` and split on axis 0 over ``model``; smaller groups replicate.
The padding never drifts: a padded core gets a zero gradient, and a
zero-W Cayley step leaves it exactly the identity.

- **ranks** (one per mesh position, ``parallel/mesh.py``): each rank keeps
  only its rows of every split group, params and SGD-G momentum both, so
  the model state per rank scales as 1/mesh[model].  The step all-gathers
  the split groups over the rank's ``model`` line, computes −log F on the
  unstacked cores (every rank the same full loss) and updates its own
  rows.  JAX computes the loss replicated on the gathered cores, so XLA's
  reduce-scatter of the stacked gradient is, in numbers, each owner taking
  its own rows: the gather's backward hands each rank its own rows of the
  cotangent unchanged (``parallel/_collectives.gather_rows``; a
  reduce-scatter SUM would multiply the gradient by the ranks).
- **one process**: the positions share one device; the stacks stay whole
  and the placement is only recorded (:func:`group_shardings`).

The SGD-G update runs batched over the stack axis (``optim/stiefel.py``'s
step, so each core's update is ``sgdg``'s) with one retraction draw per
stack per step from the optimizer's generator, seeded alike on every rank.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..graph.dsl import CircuitGraph
from ..optim.stiefel import (
    EPS,
    GradientTransformation,
    _draw,
    _lr_at,
    _plain_step,
    _rows_cols,
    _stiefel_step,
    qr_retraction,
    unit_rows,
)
from ._collectives import gather_rows
from .mesh import Mesh, Placement, rank_form

__all__ = [
    "StackedParams",
    "StackedSGDGState",
    "stack_params",
    "unstack_params",
    "group_shardings",
    "shard_stacked",
    "stacked_sgdg",
    "make_fsdp_network_fit_step",
]


class StackedParams(NamedTuple):
    """Cores grouped by shape and stacked: ``arrays[g][i] == params[names[g][i]]``.

    ``n_real[g]`` counts genuine cores in group g; rows beyond that are
    identity padding for mesh divisibility.
    """

    arrays: Tuple[torch.Tensor, ...]
    names: Tuple[Tuple[str, ...], ...]
    n_real: Tuple[int, ...]


def _identity_like(shape, like: torch.Tensor) -> torch.Tensor:
    """The identity of ``(prod(shape[:k//2]), prod(shape[k//2:]))`` in
    ``shape``."""
    rows, cols = _rows_cols(shape)
    return torch.eye(rows, cols, dtype=like.dtype, device=like.device).reshape(shape)


def stack_params(graph: CircuitGraph, params: Dict[str, torch.Tensor],
                 pad_to: int = 1) -> StackedParams:
    """Group cores by shape (groups in sorted shape order) and stack.
    Groups with at least ``pad_to`` cores are padded with identity cores
    to a multiple of ``pad_to`` so they can split over the model axis;
    smaller groups stay unpadded and replicate (padding a 1-core group to
    the mesh size would multiply its memory instead of splitting it)."""
    groups: Dict[Tuple[int, ...], List[str]] = {}
    for name in graph.core_names:
        groups.setdefault(tuple(params[name].shape), []).append(name)
    arrays, names, n_real = [], [], []
    for shape, ns in sorted(groups.items()):
        stack = torch.stack([params[n] for n in ns])
        n = len(ns)
        pad = (-n) % pad_to if n >= pad_to else 0
        if pad:
            ident = _identity_like(shape, stack)
            stack = torch.cat([stack, ident.expand((pad,) + shape)])
        arrays.append(stack)
        names.append(tuple(ns))
        n_real.append(n)
    return StackedParams(tuple(arrays), tuple(names), tuple(n_real))


def unstack_params(stacked: StackedParams) -> Dict[str, torch.Tensor]:
    """Back to the ``{name: core}`` dict the contraction layer takes
    (padding rows dropped)."""
    out = {}
    for arr, ns in zip(stacked.arrays, stacked.names):
        for i, n in enumerate(ns):
            out[n] = arr[i]
    return out


def group_shardings(stacked: StackedParams, mesh: Mesh,
                    axis: str = "model") -> Tuple[Placement, ...]:
    """Per-group placement: axis 0 split over ``axis`` when the stack
    divides the mesh axis, replicated otherwise (small groups)."""
    n = mesh.shape[axis]
    return tuple(Placement(mesh, (axis,) if a.shape[0] % n == 0 and a.shape[0] >= n else ())
                 for a in stacked.arrays)


def shard_stacked(stacked: StackedParams, mesh: Mesh, axis: str = "model") -> StackedParams:
    """Each stack as this process keeps it: its rows of the split groups
    in the rank form (a copy, so the whole stack can be freed), the whole
    stack in one process."""
    placements = group_shardings(stacked, mesh, axis)
    arrays = tuple(pl.local(a).clone() if rank_form() and pl.spec else a
                   for a, pl in zip(stacked.arrays, placements))
    return StackedParams(arrays, stacked.names, stacked.n_real)


class StackedSGDGState(NamedTuple):
    momentum: Tuple[torch.Tensor, ...]  # [n, cols, rows] per Stiefel stack
    generator: torch.Generator  # JAX's PRNG key
    count: int


def stacked_sgdg(
    learning_rate,
    momentum: float = 0.0,
    stiefel: bool = True,
    retraction_prob: float = 1.0 / 101.0,
    eps: float = EPS,
    seed: int = 0,
    cayley: str = "solve",
    cayley_iters: int = 8,
) -> GradientTransformation:
    """``optim.stiefel.sgdg`` on stacked ``[n, *shape]`` leaves: the update
    runs batched over axis 0, so when that axis is split the optimizer
    state splits with it.  Per core the update is ``sgdg``'s (same math;
    one retraction draw per stack per step)."""

    def init(stacks: Tuple[torch.Tensor, ...]) -> StackedSGDGState:
        bufs = []
        for arr in stacks:
            rows, cols = _rows_cols(arr.shape[1:])
            if stiefel and rows <= cols:
                bufs.append(torch.zeros((arr.shape[0], cols, rows), dtype=arr.dtype,
                                        device=arr.device))
            else:
                bufs.append(torch.zeros_like(arr))
        return StackedSGDGState(tuple(bufs), torch.Generator().manual_seed(seed), 0)

    def update(grads, state: StackedSGDGState, stacks):
        lr = _lr_at(learning_rate, state.count)
        updates, moms = [], []
        for arr, g, v in zip(stacks, grads, state.momentum):
            rows, cols = _rows_cols(arr.shape[1:])
            if not (stiefel and rows <= cols):
                u, buf = _plain_step(g, arr, v, lr, state.count, momentum)
            else:
                x = unit_rows(arr.reshape(-1, rows, cols), eps)
                if retraction_prob > 0 and _draw(state.generator) < retraction_prob:
                    x = qr_retraction(x)
                u, buf = _stiefel_step(g, arr, v, x, lr, momentum, eps, cayley, cayley_iters)
            updates.append(u)
            moms.append(buf)
        return tuple(updates), StackedSGDGState(tuple(moms), state.generator, state.count + 1)

    return GradientTransformation(init, update)


def make_fsdp_network_fit_step(
    graph: CircuitGraph,
    mesh: Mesh,
    learning_rate: float = 1e-2,
    momentum: float = 0.9,
    axis: str = "model",
    cayley: str = "solve",
):
    """The FSDP training step of the network-fidelity loss.

    Returns ``(step, prepare, optimizer)``: ``prepare(params)`` stacks and
    splits a core dict into a tuple of ``[n, *shape]`` tensors (this
    process's rows), and ``step(arrays, opt_state, target_arrays) ->
    (arrays, opt_state, loss)`` keeps params and momentum split over
    ``axis``; ``step.value_and_grad(arrays, target_arrays)`` gives the loss
    and the gradient of this process's rows.  Cores live on the mesh's
    device.
    """
    # imported here: train/network_fit imports this package lazily
    from ..train.network_fit import network_log_fidelity

    n_model = mesh.shape[axis]
    optimizer = stacked_sgdg(learning_rate, momentum=momentum, stiefel=True, cayley=cayley)
    # the group structure is a property of the graph: computed once
    template = stack_params(
        graph, {c.name: torch.empty(c.shape, device="meta") for c in graph.cores}, n_model)
    names, n_real = template.names, template.n_real
    split = tuple(bool(pl.spec) for pl in group_shardings(template, mesh, axis))
    line = mesh.line((axis,)) if rank_form() else None

    def prepare(params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return shard_stacked(stack_params(graph, params, n_model), mesh, axis).arrays

    def _cores(arrays) -> Dict[str, torch.Tensor]:
        if line is not None:
            arrays = [gather_rows(a, line) if s else a for a, s in zip(arrays, split)]
        return unstack_params(StackedParams(tuple(arrays), names, n_real))

    def value_and_grad(arrays, target_arrays):
        """−log F and its gradient with respect to this process's rows."""
        leaves = tuple(a.detach().requires_grad_(True) for a in arrays)
        with torch.no_grad():
            target = _cores(target_arrays)
        loss = -network_log_fidelity(graph, _cores(leaves), target)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(arrays, opt_state, target_arrays):
        loss, grads = value_and_grad(arrays, target_arrays)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, arrays)
            arrays = tuple(a + u for a, u in zip(arrays, updates))
        return arrays, opt_state, loss

    # the loss and gradient alone, for holding them against the unstacked ones
    step.value_and_grad = value_and_grad
    return step, prepare, optimizer
