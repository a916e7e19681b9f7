"""The span readers (``port_bench/spans.py`` and its eight metrics) on
synthetic spans and traces: times in nanoseconds, one piece of 2 steps."""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from port_bench import spans as S
from port_bench import spec
from port_bench.trace import Trace

MS = 1_000_000
METRICS = ["host_ms_per_step.loss", "host_ms_per_step.backward", "host_ms_per_step.optim",
           "idle_ms_per_step.loss", "idle_ms_per_step.backward", "idle_ms_per_step.optim",
           "idle_ms_per_step.driver", "syncs_per_step.fit"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    thread: int


def _tree(thread=1):
    """fit.batched [0, 100] ms > driver.chunk [10, 90] > step.grad [10, 60]
    (> row_sweep.overlap [20, 40] > pairwise.execute [25, 30]) and
    step.update [60, 90] (> optim.cayley [70, 80])."""
    rows = [("fit.batched", 0, 100, -1), ("driver.chunk", 10, 90, 0),
            ("step.grad", 10, 60, 1), ("row_sweep.overlap", 20, 40, 2),
            ("pairwise.execute", 25, 30, 3), ("step.update", 60, 90, 1),
            ("optim.cayley", 70, 80, 5)]
    return [Span(n, a * MS, b * MS, p, thread) for n, a, b, p in rows]


def _ctx(spans, trace, monkeypatch, steps=2):
    monkeypatch.setattr(S, "recorded", lambda: list(spans))
    return SimpleNamespace(trace=trace, counters={"pieces": 1, "steps_per_piece": steps},
                           config={}, traffic={}, units=None, peak_bytes=0)


def _read(ctx):
    return {m: spec.load_reader(m)(ctx) for m in METRICS}


def test_self_times_are_exact(monkeypatch):
    tr = Trace([("k", 0, 5 * MS), ("k", 95 * MS, 100 * MS)], [], 0.1)
    b = S.breakdown(_tree(), tr)
    # loss: row sweep 20 - 5, pairwise 5; backward: grad 50 - 20; optim: 30;
    # driver: fit.batched 100 - 80 and driver.chunk 80 - 80
    assert b["host"] == {"loss": 20 * MS, "backward": 30 * MS, "optim": 30 * MS,
                         "driver": 20 * MS, "outside": 0}
    got = _read(_ctx(_tree(), tr, monkeypatch))
    assert got["host_ms_per_step.loss"] == pytest.approx(10.0)
    assert got["host_ms_per_step.backward"] == pytest.approx(15.0)
    assert got["host_ms_per_step.optim"] == pytest.approx(15.0)


def test_one_gap_splits_over_two_spans_and_outside(monkeypatch):
    # busy until 55 ms, then from 130 ms: the gap covers the end of
    # step.grad's own time (55-60), all of step.update (60-90),
    # driver time (90-100) and 30 ms after fit.batched ended
    tr = Trace([("k", 0, 55 * MS), ("k", 130 * MS, 131 * MS)], [], 0.131)
    b = S.breakdown(_tree(), tr)
    assert b["idle"] == {"backward": 5 * MS, "optim": 30 * MS, "driver": 10 * MS,
                         "outside": 30 * MS}
    got = _read(_ctx(_tree(), tr, monkeypatch, steps=5))
    assert got["idle_ms_per_step.backward"] == pytest.approx(1.0)
    assert got["idle_ms_per_step.optim"] == pytest.approx(6.0)
    assert got["idle_ms_per_step.driver"] == pytest.approx(2.0)
    assert got["idle_ms_per_step.loss"] == 0


def test_syncs_count_only_inside_spans(monkeypatch):
    rt = [("cudaStreamSynchronize", 75 * MS, 76 * MS),  # inside optim.cayley
          ("cudaDeviceSynchronize", 120 * MS, 121 * MS),  # after fit.batched
          ("cudaLaunchKernel", 30 * MS, 31 * MS)]
    tr = Trace([("k", 0, 5 * MS), ("k", 125 * MS, 126 * MS)], rt, 0.126)
    assert S.breakdown(_tree(), tr)["syncs"] == 1
    assert _read(_ctx(_tree(), tr, monkeypatch))["syncs_per_step.fit"] == pytest.approx(0.5)


def test_groups_and_outside_add_up_to_the_idle_between_operations():
    ops = [("k", t * MS, (t + 3) * MS) for t in (0, 8, 12, 27, 31, 44, 58, 63, 77, 93, 97, 104)]
    tr = Trace(ops, [], 0.2)
    busy = tr.busy_intervals()
    idle = sum(s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:]))
    b = S.breakdown(_tree(), tr)
    assert set(b["idle"]) <= set(S.GROUPS) | {"outside"}
    assert sum(b["idle"].values()) == idle
    assert all(v >= 0 for v in b["idle"].values())


def test_other_threads_spans_are_left_out():
    tr = Trace([("k", 0, 5 * MS), ("k", 95 * MS, 100 * MS)], [], 0.1)
    worker = [Span("loss.mask", 0, 100 * MS, -1, 2)]
    assert S.breakdown(_tree() + worker, tr) == S.breakdown(_tree(), tr)


def test_nothing_to_read_gives_none(monkeypatch):
    full = Trace([("k", 0, 5 * MS), ("k", 95 * MS, 100 * MS)], [], 0.1)
    assert S.breakdown(_tree(), Trace([], [], 1.0)) is None
    assert S.breakdown([], full) is None
    for spans, tr in (([], full), (_tree(), Trace([], [], 1.0))):
        assert all(v is None for v in _read(_ctx(spans, tr, monkeypatch)).values())


def test_a_program_without_spans_gives_none(monkeypatch):
    """A port that records no spans (an older ``utils.profiling``) reads as
    nothing, and does not raise."""
    from tneq_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert S.recorded() is None
    ctx = SimpleNamespace(trace=Trace([("k", 0, 5 * MS), ("k", 9 * MS, 10 * MS)], [], 0.01),
                          counters={"pieces": 1, "steps_per_piece": 2}, config={},
                          traffic={}, units=None, peak_bytes=0)
    assert all(v is None for v in _read(ctx).values())
