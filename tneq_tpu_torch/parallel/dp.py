"""Data parallelism: the batch split over the mesh's ``data`` axis, the
gradient averaged over it.

Counterpart of ``tneq_tpu/parallel/dp.py``.  JAX shards the batch over
``data`` and GSPMD inserts the ``psum`` of the mean-loss gradient.  Here:

- **one process**: every position is in this process and shares one
  device, so the whole batch is contracted: ``Trainer.train_step``, the
  same numbers.
- **ranks** (one per mesh position, ``parallel/mesh.py``): each rank takes
  its rows (``B / d``; the batch must divide, as in JAX) and steps
  ``Trainer.loss`` on them.  With equal shards the global mean loss is the
  mean of the ranks' means, so the gradients are SUM-all-reduced over the
  rank's ``data`` line through one flat buffer and divided by ``d``, and
  the loss the same for the report.  Params and optimizer state stay
  replicated: every rank applies the same update from the same gradient
  (the SGD-G retraction's generator seeded alike on every rank), so the
  replicas stay bit-equal.  Ranks on one line of another axis compute the
  same.

Gradients keep torch's convention, the conjugate of ``jax.grad``'s for
complex params (the optimizers take that into account).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..train.trainer import Trainer
from ._collectives import all_reduce, sum_flat
from .mesh import Mesh, data_sharding, rank_form

__all__ = ["shard_batch", "make_dp_train_step"]


def shard_batch(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The batch ``x`` on this process's device, its leading axis to be
    split over ``axis``: the step takes this process's rows
    (``data_sharding(mesh, axis).local``).  The batch size must divide by
    the axis size (the reference gives remainders to early ranks; pad or
    trim to a multiple)."""
    x = torch.as_tensor(x, device=mesh.device())
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not divide over '{axis}' of size {n}")
    return x


def _mean_over_rows(mesh: Mesh, axis: str) -> Callable:
    """``(loss, grads) -> (loss, grads)`` of the rank's rows -> those of the
    global batch: sums over the ``axis`` line divided by its size."""
    line = mesh.line((axis,))
    d = line.size

    def reduce(loss, grads):
        grads = sum_flat(grads, line)
        return all_reduce(loss, line) / d, {k: g / d for k, g in grads.items()}

    return reduce


def make_dp_train_step(trainer: Trainer, mesh: Mesh, axis: str = "data") -> Callable:
    """The data-parallel train step: ``step(params, opt_state, states, x)
    -> (params, opt_state, loss)`` like ``Trainer.train_step``, with ``x``
    the whole batch (:func:`shard_batch`); params and optimizer state
    replicated.  The trainer contracts unsliced (no ``mesh``)."""
    if trainer._reduce_gradients is not None:
        raise ValueError("the trainer's contraction is sliced over a mesh and splits its "
                         "batch itself; build the data-parallel step on an unsliced trainer")
    if not rank_form():
        mesh.device()  # one device for every position
        return trainer.train_step
    rows = data_sharding(mesh, axis)
    reduce = _mean_over_rows(mesh, axis)

    def step(params, opt_state, states, x):
        return trainer._step(params, opt_state, states, rows.local(x), reduce=reduce)

    return step
