"""DeviceFarm: per-device candidate-evaluation workers.

Counterpart of ``tneq_tpu/genetic/farm.py`` (the reference's MPI job farm,
``tneq_qc/distributed/mpi_overlord.py`` dispatch loop + ``mpi_agent.py``
worker processes): one process drives every local CUDA device.  Each device
gets one worker thread with its own
:class:`~tneq_tpu_torch.genetic.evaluator.CandidateEvaluator` clone (goal
cores committed to that device, chunk cache shared).  Jobs go to the worker
with the fewest outstanding jobs; a worker runs its job under
``torch.cuda.device(d)`` when ``d`` is a CUDA device, so concurrent
candidates train on different cards while the host does the bookkeeping.

Threads are enough where the launches do not hold the interpreter lock for
long: the eager fit step is host-bound (one Python thread issues every
launch), so two workers on one host overlap only their device time.  Two
host workers (``[torch.device("cpu")] * 2``) check correctness, not speed.
Determinism: the search draws the evaluation seeds in submission order on
its own thread, so a farmed search reproduces the serial search exactly.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

from ..utils.device import DeviceLike, resolve_device
from .evaluator import CandidateEvaluator

__all__ = ["DeviceFarm"]


class DeviceFarm:
    """A pool of device-pinned evaluation workers.

    Args:
        evaluator: the template evaluator; each worker gets a
            :meth:`CandidateEvaluator.clone` with the goal cores committed
            to its device.
        devices: devices to farm over (default: every visible CUDA device,
            ``torch.device("cuda", i)`` for ``i < torch.cuda.device_count()``).
    """

    def __init__(
        self,
        evaluator: CandidateEvaluator,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if devices is None:  # no card: resolve_device raises
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
                or [resolve_device("cuda")]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("DeviceFarm needs at least one device")
        self.evaluators = [evaluator.clone(device=d) for d in self.devices]
        # One single-thread executor per device: each worker is a serial
        # agent queue (an MPI rank), not a shared pool — two jobs must not
        # interleave host-side state on one evaluator.
        self._executors: List[ThreadPoolExecutor] = [
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tneq-agent{i}")
            for i in range(len(self.devices))
        ]
        self._outstanding = [0] * len(self.devices)
        self._lock = threading.Lock()

    @property
    def n_workers(self) -> int:
        return len(self.devices)

    def submit(self, graph_string: str, seed: int, repeats: int = 1) -> Future:
        """Queue one candidate evaluation on the least-loaded worker.

        Returns a future resolving to the evaluator's
        ``(losses, iterations, reason)`` tuple.
        """
        with self._lock:
            i = min(range(len(self.devices)), key=lambda j: self._outstanding[j])
            self._outstanding[i] += 1
        fut = self._executors[i].submit(self._run, i, graph_string, seed, repeats)
        fut.add_done_callback(lambda _f, i=i: self._done(i))
        return fut

    def _done(self, i: int) -> None:
        with self._lock:
            self._outstanding[i] -= 1

    def _run(self, i: int, graph_string: str, seed: int, repeats: int):
        d = self.devices[i]
        with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
            return self.evaluators[i].evaluate(graph_string, seed, repeats)

    def shutdown(self, wait: bool = True) -> None:
        for ex in self._executors:
            ex.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
