"""The collectives of the parallel layer's rank form, and their routes.

JAX's collectives (``psum``, ``all_gather``, ``ppermute``) run inside
``shard_map`` and are differentiable.  Here each is a function of a
:class:`Line` (a process group and this rank's place in it), with the
gradient rule the port needs written out as an ``autograd.Function``:

- :func:`all_reduce`: the backward passes the cotangent through unchanged
  (torch's differentiable ``all_reduce`` sums the cotangent too, which
  would multiply the gradient by the number of ranks); each rank's
  gradient holds its own terms, and the caller sums the parameter
  gradients with :func:`sum_flat`.  It has a ``vmap`` rule: an all-reduce
  of a lane-batched tensor is elementwise, so it commutes with the lanes.
- :func:`gather_rows`: the backward hands each rank its own rows of the
  cotangent unchanged (every rank computes the same loss on the gathered
  rows, so a reduce-scatter SUM would multiply the gradient by the ranks).

Routes.  The primitive each collective runs is chosen from the backend
and the device type when a mesh makes its groups (:func:`routes`), never
by trying one and catching its failure.  gloo (torch 2.11 on an H100)
takes CUDA tensors for ``all_reduce`` (SUM, MAX, MIN, complex64),
``broadcast``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and ``barrier``, and
refuses them for point-to-point: ``send`` aborts the process and
``batch_isend_irecv`` raises (``writev ... Bad address``: the TCP
transport is handed the device pointer).  So on gloo with CUDA tensors
the ring goes through ``broadcast`` (``chip_smoke.py`` phase 14 (d)
probes each primitive).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Line", "routes", "all_reduce", "gather_rows", "ring", "sum_flat"]

# the native primitive of each collective
_NATIVE = {"all_reduce": "all_reduce", "all_gather": "all_gather", "ring": "send_recv"}
# gloo with CUDA tensors: the collectives whose native primitive it refuses,
# each with the route it takes instead
_GLOO_CUDA = {"ring": "broadcast"}


def routes(backend: str, device_type: str) -> Dict[str, str]:
    """The primitive each collective runs on ``backend`` for tensors on
    ``device_type``."""
    table = dict(_NATIVE)
    if backend == "gloo" and device_type == "cuda":
        table.update(_GLOO_CUDA)
    return table


class Line(NamedTuple):
    """A rank's line of a mesh: its process group (``None`` for a line of
    one rank), the global ranks of the line in order, its index there and
    the routes of the line's collectives."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int
    routes: Dict[str, str]

    @property
    def size(self) -> int:
        return len(self.ranks)


class _AllReduce(torch.autograd.Function):
    """``all_reduce`` of a copy of ``x`` whose backward passes the cotangent
    through unchanged.  Its forward sees plain tensors under the
    ``torch.func`` transforms, which the collectives need."""

    @staticmethod
    def forward(x, op, group):
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, op, group):
        # every rank runs the same lanes: reduce the whole batched tensor
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y, in_dims[0]


def all_reduce(x: torch.Tensor, line: Line, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the line, differentiable with the pass-through rule."""
    if line.size == 1:
        return x
    return _AllReduce.apply(x, op, line.group)


def _gather(x: torch.Tensor, line: Line) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(line.size)]
    dist.all_gather(parts, x, group=line.group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(x, line):
        return _gather(x, line)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, line = inputs
        ctx.rows, ctx.index = x.shape[0], line.index

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, line: Line) -> torch.Tensor:
    """The line's ranks' ``x`` concatenated along axis 0, in line order;
    the gradient of each rank's rows is its own rows of the cotangent."""
    if line.size == 1:
        return x
    return _GatherRows.apply(x, line)


def ring(x: torch.Tensor, line: Line) -> torch.Tensor:
    """Each rank's ``x`` sent one step along the line: the result is the
    predecessor's ``x`` (JAX's ``ppermute`` with ``i -> i + 1``)."""
    if line.size == 1:
        return x.clone()
    x = x.contiguous()
    prev = line.ranks[(line.index - 1) % line.size]
    nxt = line.ranks[(line.index + 1) % line.size]
    if line.routes["ring"] == "send_recv":
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, nxt, group=line.group),
               dist.P2POp(dist.irecv, y, prev, group=line.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return y
    # through broadcast: each rank in turn sends to the line, and each
    # keeps what its predecessor sent
    y = None
    for src in line.ranks:
        buf = x.clone() if src == line.ranks[line.index] else torch.empty_like(x)
        dist.broadcast(buf, src=src, group=line.group)
        if src == prev:
            y = buf
    return y


def sum_flat(tensors: Dict[str, torch.Tensor], line: Line) -> Dict[str, torch.Tensor]:
    """``tensors`` summed over the line through one flat buffer per dtype
    (one collective, not one per tensor).  Safe under ``torch.func.vmap``."""
    if line.size == 1:
        return dict(tensors)
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    out = {}
    for names in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[k].reshape(-1) for k in names]), line)
        offset = 0
        for k in names:
            n = tensors[k].numel()
            out[k] = flat[offset:offset + n].reshape(tensors[k].shape)
            offset += n
    return {k: out[k] for k in tensors}
