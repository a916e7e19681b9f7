"""Mesh health checks: collective self-tests with their times.

Counterpart of ``tneq_tpu/parallel/health.py``.  Along every mesh axis
each position contributes its index through three collectives and the
results are checked: the all-gather must give every index in order, the
sum (JAX's ``psum``) size·(size−1)/2, and the ring (JAX's ``ppermute``,
``i -> i + 1``) a permutation of the indices.  Each is timed in ms.

In the rank form each rank runs its line of each axis (a process group
per line, ``parallel/mesh.py``) through the route its backend takes
(``parallel/_collectives.py``), and the ranks agree on one report.  In one
process every position is here: the collectives are computed over the
positions' tensors, and the route is ``"one process"``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import _collectives as coll
from .mesh import Mesh, rank_form
from .multihost import is_main_process

__all__ = ["check_mesh_health"]


def _checks(size: int) -> Dict[str, Callable[[np.ndarray], bool]]:
    """Each collective's check on what every position received, as rows
    ``[position, ...]``."""
    idx = np.arange(size, dtype=np.float32)
    return {
        "all_gather": lambda out: np.array_equal(out.ravel(), np.tile(idx, size)),
        "psum": lambda out: np.allclose(out, size * (size - 1) / 2.0),
        "ppermute": lambda out: np.array_equal(np.sort(out.ravel()), idx),
    }


def _one_process(size: int, dev: torch.device) -> Dict[str, Callable[[], List[torch.Tensor]]]:
    xs = [torch.full((1,), float(i), device=dev) for i in range(size)]
    return {
        "all_gather": lambda: [torch.cat(xs) for _ in xs],
        "psum": lambda: [sum(xs[1:], xs[0].clone()) for _ in xs],
        "ppermute": lambda: [xs[(i - 1) % size].clone() for i in range(size)],
    }


def _ranks(line: coll.Line, dev: torch.device) -> Dict[str, Callable[[], List[torch.Tensor]]]:
    x = torch.full((1,), float(line.index), device=dev)
    return {
        "all_gather": lambda: [coll.gather_rows(x, line)],
        "psum": lambda: [coll.all_reduce(x, line)],
        "ppermute": lambda: [coll.ring(x, line)],
    }


# the collective of _collectives each check runs
_COLLECTIVE = {"all_gather": "all_gather", "psum": "all_reduce", "ppermute": "ring"}


def _gathered(line: coll.Line, rows: List[torch.Tensor]) -> np.ndarray:
    """Every rank's result on the line, as rows in line order (for the
    check of the whole line)."""
    return coll.gather_rows(torch.stack(rows), line).cpu().numpy()


def check_mesh_health(mesh: Mesh, verbose: bool = True) -> Dict[str, Any]:
    """Run the all-gather / sum / ring tests over every mesh axis.

    Returns ``{"ok", "axes": {axis: {"size", "all_gather": {"ok", "ms",
    "route"}, "psum": ..., "ppermute": ...}}}``; ``ok`` is False if any
    collective returned wrong values.
    """
    ranks = rank_form()
    dev = mesh.device()
    report: Dict[str, Any] = {"axes": {}, "ok": True}
    for axis, size in mesh.shape.items():
        axis_report: Dict[str, Any] = {"size": size}
        line = mesh.line((axis,)) if ranks else None
        prims = _ranks(line, dev) if ranks else _one_process(size, dev)
        for name, check in _checks(size).items():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = prims[name]()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if ranks:
                rows = _gathered(line, out)
                route = "local" if line.size == 1 else line.routes[_COLLECTIVE[name]]
            else:
                rows = torch.stack(out).cpu().numpy()
                route = "one process"
            axis_report[name] = {"ok": bool(check(rows)), "ms": dt * 1e3, "route": route}
        report["axes"][axis] = axis_report
    if ranks:
        # one report on every rank: a check fails if it failed anywhere
        flags = torch.tensor([float(r[n]["ok"]) for r in report["axes"].values()
                              for n in _checks(1)], device=dev)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        flat = iter(flags.tolist())
        for r in report["axes"].values():
            for n in _checks(1):
                r[n]["ok"] = bool(next(flat))
    report["ok"] = all(r[n]["ok"] for r in report["axes"].values() for n in _checks(1))
    if verbose and is_main_process():
        for axis, r in report["axes"].items():
            print(f"mesh axis {axis!r}: {r}", flush=True)
    return report
