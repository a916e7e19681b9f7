"""A named device mesh: the ``data`` and ``model`` axes of the parallel layer.

Counterpart of ``tneq_tpu/parallel/mesh.py`` (``make_mesh``,
``data_sharding``, ``replicated``).  PyTorch has no ``jax.sharding.Mesh``;
:class:`Mesh` keeps its reading surface (``shape``, ``axis_names``,
``devices``) over an array of ``torch.device``.  A device may repeat: two
positions on ``cuda:0`` are the one-card form, as JAX's tests run on eight
virtual CPU devices.

Two execution forms:

- **one process** (``torch.distributed`` not initialised, or one rank):
  this process holds every position, and they share one device.  A
  placement changes no number and is only recorded.
- **ranks**: one ``torch.distributed`` rank per position, rank ``r`` at the
  ``r``-th position in row-major order.  :meth:`Mesh.line` gives the
  process group of this rank's line along an axis (the positions that
  differ from it in that axis only) or along every axis (the world).
  All groups of a mesh are made at its first :meth:`Mesh.line` call, in
  one order, on every rank: ``new_group`` is collective.

PyTorch has no ``NamedSharding`` either: :class:`Placement` records a mesh
and a spec, ``("data",)`` for the leading axis split over ``data``, ``()``
for replicated, and :meth:`Placement.local` gives this process's share.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from ._collectives import Line, routes

__all__ = ["Mesh", "Placement", "make_mesh", "data_sharding", "replicated", "rank_form"]


def rank_form() -> bool:
    """True inside a ``torch.distributed`` group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


class Mesh:
    """Devices laid out on named axes; ``devices[i, j, ...]`` is the device
    at position ``(i, j, ...)``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._lines: Optional[Dict[frozenset, Line]] = None

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"

    def _check_ranks(self) -> None:
        if dist.get_world_size() != self.size:
            raise ValueError(
                f"the rank form takes one rank per mesh position: mesh "
                f"{dict(self.shape)} has {self.size} positions, the group "
                f"{dist.get_world_size()} ranks"
            )

    def position(self) -> Tuple[int, ...]:
        """This rank's position (rank form); ``()`` in one process."""
        if not rank_form():
            return ()
        self._check_ranks()
        return tuple(int(i) for i in np.unravel_index(dist.get_rank(), self.devices.shape))

    def device(self) -> torch.device:
        """The device this process computes on: its position's in the rank
        form, the one device every position shares in one process."""
        if rank_form():
            return self.devices[self.position()]
        devices = {str(d) for d in self.devices.flat}
        if len(devices) > 1:
            raise ValueError(
                f"one process runs its positions on one device, the mesh holds "
                f"{sorted(devices)}: give each position a torch.distributed "
                f"rank of its own (the rank form)"
            )
        return self.devices.flat[0]

    def line(self, axes: Sequence[str]) -> Line:
        """This rank's line along ``axes`` (one axis, or all of them) in the
        rank form: its process group, the lines' ranks and its index there."""
        key = frozenset(axes)
        if self._lines is None:
            self._check_ranks()
            self._lines = self._make_lines()
        if key not in self._lines:
            raise ValueError(f"no process group over axes {sorted(key)} of {dict(self.shape)}: "
                             f"one axis or all of them")
        return self._lines[key]

    def _make_lines(self) -> Dict[frozenset, Line]:
        """Every line of every axis, then the world; every rank calls
        ``new_group`` for every line, in this order."""
        ranks = np.arange(self.size).reshape(self.devices.shape)
        me = dist.get_rank()
        table = routes(dist.get_backend(), self.devices.flat[me].type)
        out = {}
        kinds = [(a,) for a in self.axis_names]
        if len(self.axis_names) > 1:
            kinds.append(self.axis_names)
        for axes in kinds:
            idx = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(ranks.ndim) if i not in idx]
            lines = ranks.transpose(rest + idx).reshape(-1, int(np.prod([ranks.shape[i]
                                                                          for i in idx])))
            for members in lines:
                members = tuple(int(r) for r in members)
                if len(members) == 1:
                    group = None
                elif len(members) == self.size:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(list(members))
                if me in members:
                    out[frozenset(axes)] = Line(group, members, members.index(me), table)
        return out


class Placement(NamedTuple):
    """Where an array lives on a mesh: ``spec == (axis,)`` splits its
    leading axis over ``axis``, ``spec == ()`` replicates it."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's share of ``x``: the rows of its position along
        the split axis in the rank form (the leading axis must divide), the
        whole of ``x`` in one process or when replicated."""
        if not self.spec:
            return x
        axis = self.spec[0]
        n = self.mesh.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                             f"'{axis}' of size {n}")
        if not rank_form():
            return x
        i = self.mesh.position()[self.mesh.axis_names.index(axis)]
        rows = x.shape[0] // n
        return x.narrow(0, i * rows, rows)


def data_sharding(mesh: Mesh, axis: str = "data") -> Placement:
    """Split the leading (batch) axis over ``axis``."""
    return Placement(mesh, (axis,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def make_mesh(
    axes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Create a mesh with named axes, e.g. ``{'data': 4, 'model': 2}``.

    Defaults to every visible card on one ``data`` axis.  The axis-size
    product must equal the device count.  Devices may repeat
    (``devices=['cuda:0'] * 2``); naming a card where there is none raises,
    as every entry point does, so the host runs only when asked for
    (``devices=['cpu'] * 2``).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    # 'cuda' and 'cuda:0' are one device
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if axes is None:
        axes = {"data": len(devs)}
    sizes = [int(s) for s in axes.values()]
    if int(np.prod(sizes)) != len(devs):
        raise ValueError(
            f"mesh axes {axes} need {int(np.prod(sizes))} devices, have {len(devs)}"
        )
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), tuple(axes.keys()))
