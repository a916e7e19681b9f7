"""A named device mesh: the ``data`` and ``model`` axes of the parallel layer.

Counterpart of ``tneq_tpu/parallel/mesh.py`` (``make_mesh``).  PyTorch has
no ``jax.sharding.Mesh``; :class:`Mesh` keeps its reading surface
(``shape``, ``axis_names``, ``devices``) over an array of
``torch.device``.  A position of the ``model`` axis is a share of the
slices of a bond-sliced contraction (``parallel/mp.py``): one process may
hold every position, on one device, or ``torch.distributed`` may give each
position a rank of its own.  A device may repeat: two positions on
``cuda:0`` are the one-card form, as JAX's tests run on eight virtual CPU
devices.

``data_sharding`` and ``replicated`` serve the data-parallel step
(ROADMAP A, item 11b) and come with it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Devices laid out on named axes; ``devices[i, j, ...]`` is the device
    at position ``(i, j, ...)``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


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
