"""The traced window: torch.profiler over the card's activity, reduced to the
numbers the per-layer readers take.

Only the CUDA activity is recorded: every device operation (kernels,
copies, fills) with its interval, and the host's CUDA runtime calls that
CUPTI reports beside them.  Host-side operator events are left out, since
recording them adds several events per launch and slows the host that
paces most steps.  A window whose trace holds no device operation yields
a ``Trace`` with none, and the harness fails the run on it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import torch

__all__ = ["Trace", "traced"]

Interval = Tuple[str, int, int]  # name, start ns, end ns


def _start_end(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        return int(ev.start_ns()), int(ev.end_ns())
    start = int(ev.start_us()) * 1000
    return start, start + int(ev.duration_us()) * 1000


@dataclass
class Trace:
    """Device operations and host runtime calls of one traced window."""

    device_ops: List[Interval] = field(default_factory=list)
    runtime: List[Interval] = field(default_factory=list)
    window_s: float = 0.0

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "Trace":
        device_ops, runtime = [], []
        for ev in prof.profiler.kineto_results.events():
            start, end = _start_end(ev)
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                device_ops.append((ev.name(), start, end))
            elif ev.name().startswith("cuda"):
                runtime.append((ev.name(), start, end))
        device_ops.sort(key=lambda iv: iv[1])
        runtime.sort(key=lambda iv: iv[1])
        return cls(device_ops, runtime, window_s)

    @property
    def launches(self) -> int:
        return len(self.device_ops)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        merged: List[List[int]] = []
        for _, start, end in self.device_ops:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_of(self, predicate) -> float:
        """Device seconds of the operations whose name satisfies
        ``predicate`` (summed; such operations do not overlap here: one
        stream)."""
        return sum(e - s for n, s, e in self.device_ops if predicate(n)) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations that took most time, summed by name."""
        by_name = defaultdict(int)
        for name, start, end in self.device_ops:
            by_name[name] += end - start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time between device operations, summed by what the host was
        doing: the CUDA runtime call it was in when the device went idle
        (``python`` when none: the host was between calls), and the device
        operation that ended the gap."""
        busy = self.busy_intervals()
        starts = {}
        for name, start, _ in self.device_ops:
            starts.setdefault(start, name)
        rt = self.runtime
        j = 0
        by_name = defaultdict(int)
        for (s0, e0), (s1, _) in zip(busy, busy[1:]):
            while j < len(rt) and rt[j][2] < e0:
                j += 1
            host = rt[j][0] if j < len(rt) and rt[j][1] <= e0 <= rt[j][2] else "python"
            nxt = starts.get(s1, "?")
            by_name[f"host {host} -> {nxt[:80]}"] += s1 - e0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]


@contextlib.contextmanager
def traced(device: torch.device) -> Iterator[list]:
    """Profile the block's card activity; yields a list that holds the
    :class:`Trace` once the block has ended (the device synchronised)."""
    from torch.profiler import ProfilerActivity, profile

    box: list = []
    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        prof.stop()
    box.append(Trace.from_profile(prof, window_s))
