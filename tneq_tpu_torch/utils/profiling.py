"""Profiling and step-timing utilities.

Counterpart of ``tneq_tpu/utils/profiling.py``, on ``torch.profiler``
where the reference package uses ``jax.profiler``: :func:`trace` captures
the host's activity and, when a card is present, the card's kernels, and
writes a Chrome trace (``.json``, viewable in Perfetto or
``chrome://tracing``); :func:`annotate` names a region in that timeline;
:class:`StepTimer` accumulates host wall-time spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "StepTimer", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the block (CPU, and CUDA when a
    card is visible) and write it as a Chrome trace into ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in profiler timelines
    (``torch.profiler.record_function``)."""
    return record_function(name)


class StepTimer:
    """Accumulates wall-time spans by name; ``summary()`` reports
    count/total/mean per span.

    The spans are host wall time, as in the reference package: work the
    block queues on the card counts only where the caller waits for it
    (a ``float(loss)``, ``torch.cuda.synchronize()``) inside the span."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": self.counts[name],
                "total_s": round(self.totals[name], 4),
                "mean_ms": round(
                    1e3 * self.totals[name] / max(1, self.counts[name]), 3
                ),
            }
            for name in self.totals
        }

    def __str__(self) -> str:
        return "\n".join(
            f"{k}: {v['count']}x mean {v['mean_ms']}ms total {v['total_s']}s"
            for k, v in self.summary().items()
        )
