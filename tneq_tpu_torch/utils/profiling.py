"""Profiling and step-timing utilities.

Counterpart of ``tneq_tpu/utils/profiling.py``, on ``torch.profiler``
where the reference package uses ``jax.profiler``: :func:`trace` captures
the host's activity and, when a card is present, the card's kernels, and
writes a Chrome trace (``.json``, viewable in Perfetto or
``chrome://tracing``); :func:`annotate` names a region in that timeline;
:class:`StepTimer` accumulates host wall-time spans.

Spans.  While a ``torch.profiler`` session runs, :func:`annotate` also
records each region as a :class:`Span` in memory, stamped with
``time.time_ns()``: the Unix-epoch clock of the profiler's own events, so
spans and the card's kernel intervals compare directly.  :func:`spans`
returns them and :func:`clear_spans` empties the list (``trace`` clears it
when it starts).  With no profiler running, ``annotate`` returns one shared
no-op context: it reads no clock, allocates nothing and enters no
``record_function``.

The port's spans name their layer first (``fit.*``, ``driver.*``,
``step.*``, ``loss.*``, ``row_sweep.*``, ``pairwise.*``, ``optim.*``);
``Trainer.fit``'s steps are ``train_step``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "StepTimer", "annotate", "Span", "spans", "clear_spans"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the block (CPU, and CUDA when a
    card is visible) and write it as a Chrome trace into ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Span(NamedTuple):
    """One region :func:`annotate` recorded: its interval on the Unix-epoch
    nanosecond clock (``end_ns`` is None while it is open), the index in
    :func:`spans` of the span that encloses it on its thread (-1: none) and
    the thread's ident."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    thread: int


_SPANS: List[Span] = []
_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: (list, index) of the thread's open spans


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorded:
    """A span while a profiler runs: a ``record_function`` region inside an
    interval kept in ``_SPANS``."""

    __slots__ = ("name", "region", "where")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        start = time.time_ns()
        with _LOCK:
            spans_ = _SPANS
            parent = stack[-1][1] if stack and stack[-1][0] is spans_ else -1
            self.where = (spans_, len(spans_))
            spans_.append(Span(self.name, start, None, parent, threading.get_ident()))
        stack.append(self.where)
        self.region = record_function(self.name)
        self.region.__enter__()
        return None

    def __exit__(self, *exc):
        self.region.__exit__(*exc)
        end = time.time_ns()
        _LOCAL.stack.pop()
        spans_, i = self.where
        with _LOCK:
            spans_[i] = spans_[i]._replace(end_ns=end)
        return False


def annotate(name: str):
    """Named region: while a ``torch.profiler`` session runs, a
    ``record_function`` region in its timeline and a :class:`Span` in
    :func:`spans`; otherwise a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name)


def spans() -> List[Span]:
    """The spans recorded since the last :func:`clear_spans`, in the order
    they opened."""
    with _LOCK:
        return list(_SPANS)


def clear_spans() -> None:
    """Empty :func:`spans` (spans still open close into the old list)."""
    global _SPANS
    with _LOCK:
        _SPANS = []


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
