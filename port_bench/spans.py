"""The program's spans against the traced window's device operations.

The port records a span per layer boundary while a profiler runs
(``tneq_tpu_torch.utils.profiling.spans()``: name, start and end on the
Unix-epoch nanosecond clock the device trace uses, parent index, thread).
From the fit thread's spans and ``ctx.trace`` this module computes:

- the self time of each span: its interval less the parts its children
  cover;
- the idle attribution: each gap between consecutive busy intervals of the
  device goes to the innermost span open on the fit thread during it, and
  time that no span covers to ``outside`` (the harness's own code between
  pieces);
- the synchronising CUDA runtime calls (a name holding ``Synchronize``)
  that start inside a span.

Spans fall into four groups by name: ``loss`` (``loss.*``,
``row_sweep.*``, ``pairwise.*`` and the self time of ``fit.prepare``),
``backward`` (the self time of ``step.grad``: the fit thread waits there
while autograd runs the backward pass), ``optim`` (``step.update``,
``optim.*``) and ``driver`` (``fit.batched``, ``driver.*``); any other name
goes to ``other``.  A program that records no spans gives ``None``.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["GROUPS", "group_of", "recorded", "breakdown", "per_step"]

GROUPS = ("loss", "backward", "optim", "driver")
_PREFIX = {"loss": "loss", "row_sweep": "loss", "pairwise": "loss", "optim": "optim",
           "driver": "driver"}
_NAMED = {"fit.prepare": "loss", "step.grad": "backward", "step.update": "optim",
          "fit.batched": "driver"}


def group_of(name: str) -> str:
    """The group a span's self time belongs to."""
    return _NAMED.get(name) or _PREFIX.get(name.split(".", 1)[0], "other")


def recorded() -> Optional[list]:
    """The program's spans, or ``None`` where the program records none (a
    port without ``utils.profiling.spans``)."""
    try:
        from tneq_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "spans", None)
    return list(get()) if get is not None else None


def _fit_thread(spans: Sequence) -> int:
    """The thread that recorded ``fit.batched`` (else the most spans)."""
    fits = Counter(s.thread for s in spans if s.name == "fit.batched")
    return (fits or Counter(s.thread for s in spans)).most_common(1)[0][0]


def _self_segments(spans: Sequence, keep: List[int]) -> List[Tuple[int, int, int]]:
    """``(start, end, span index)`` of each span's own time (its interval
    less its children's), sorted; disjoint, since one thread's spans
    nest."""
    kids: Dict[int, List[int]] = defaultdict(list)
    for i in keep:
        if spans[i].parent >= 0:
            kids[spans[i].parent].append(i)
    segs = []
    for i in keep:
        s = spans[i]
        at = s.start_ns
        for c in sorted(kids.get(i, ()), key=lambda c: spans[c].start_ns):
            if spans[c].start_ns > at:
                segs.append((at, spans[c].start_ns, i))
            at = max(at, spans[c].end_ns)
        if s.end_ns > at:
            segs.append((at, s.end_ns, i))
    segs.sort()
    return segs


def breakdown(spans: Sequence, trace) -> Optional[dict]:
    """Nanoseconds by group of the fit thread's spans: ``host`` (self
    time; ``outside`` is the traced extent less the spans), ``idle`` (the
    device's gaps between operations; ``outside``: no span open), and
    ``syncs``, the synchronising runtime calls that start inside a span.
    ``None`` without spans or without device operations."""
    busy = trace.busy_intervals()
    if not spans or not busy:
        return None
    thread = _fit_thread(spans)
    keep = [i for i, s in enumerate(spans) if s.thread == thread and s.end_ns is not None]
    if not keep:
        return None
    segs = _self_segments(spans, keep)
    groups = {i: group_of(spans[i].name) for i in keep}
    host = defaultdict(int)
    for start, end, i in segs:
        host[groups[i]] += end - start
    roots = [(spans[i].start_ns, spans[i].end_ns) for i in keep if spans[i].parent < 0]
    first = min(busy[0][0], min(s for s, _ in roots))
    last = max(busy[-1][1], max(e for _, e in roots))
    host["outside"] = (last - first) - sum(e - s for s, e in roots)

    idle = defaultdict(int)
    k = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        covered = 0
        while k < len(segs) and segs[k][1] <= e0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < s1:
            start, end, i = segs[j]
            part = min(end, s1) - max(start, e0)
            if part > 0:
                idle[groups[i]] += part
                covered += part
            j += 1
        idle["outside"] += (s1 - e0) - covered

    roots.sort()
    starts = [s for s, _ in roots]
    syncs = 0
    for name, start, _ in trace.runtime:
        if "Synchronize" in name:
            r = bisect.bisect_right(starts, start) - 1
            syncs += r >= 0 and start < roots[r][1]
    return {"host": dict(host), "idle": dict(idle), "syncs": syncs}


def per_step(ctx) -> Optional[dict]:
    """:func:`breakdown` of the traced run in ``ctx`` (``ctx.trace``, the
    program's recorded spans), with the piece steps it ran (``pieces ×
    steps_per_piece`` of the driver's counters); ``None`` where either has
    nothing to read.  Kept on ``ctx``, so the readers of one run compute it
    once."""
    steps = ctx.counters.get("pieces", 0) * ctx.counters.get("steps_per_piece", 0)
    if not steps or not ctx.trace.launches:
        return None
    if not hasattr(ctx, "span_breakdown"):
        spans = recorded()
        ctx.span_breakdown = breakdown(spans, ctx.trace) if spans else None
    b = ctx.span_breakdown
    return None if b is None else {**b, "steps": steps}
