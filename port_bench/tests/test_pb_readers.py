"""Per-layer readers find nothing in an empty trace and say so (``None``,
never 0), and a traced run whose trace holds no device operation fails."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench import spec
from port_bench.run import EXIT_NO_DEVICE_EVENTS, RunError
from port_bench.tests.conftest import BORN, BRICK, toy_run
from port_bench.trace import Trace

# every reader: the benchmark's metrics and those kept for the Born-rule trainer's cells
READERS = sorted(f.name[: -len(".py")] for f in (spec.PKG / "metrics").glob("*.py"))
COUNTERS = {
    "pieces": 2, "steps_per_piece": 16, "useful_lanes_per_round": 0, "lanes_per_round": 0,
    "useful_lane_steps": 256, "flops_per_lane_step": 1.0, "steps": 10, "flops_per_step": 1.0,
    "sweep": {"B": 8, "D": 4, "K": 2, "n": 3, "complex": False, "passes_per_step": 2},
}


@pytest.mark.parametrize("metric", READERS)
def test_reader_of_an_empty_trace_returns_nothing(metric):
    ctx = SimpleNamespace(trace=Trace([], [], 1.0), counters=COUNTERS, config={}, traffic={},
                          units=None, peak_bytes=0)
    assert spec.load_reader(metric)(ctx) is None


def test_readers_of_a_trace():
    ops = [("void transfer_wide_kernel<WReal>(...)", 0, 4_000_000),
           ("gemm", 5_000_000, 6_000_000), ("gemm", 5_500_000, 7_000_000)]
    tr = Trace(ops, [("cudaLaunchKernel", 4_100_000, 4_200_000)], window_s=0.01)
    assert tr.launches == 3
    assert tr.busy_s == pytest.approx(0.006)
    assert tr.idle_gaps()[0][1] == pytest.approx(0.001)
    ctx = SimpleNamespace(trace=tr, counters=COUNTERS, config={}, traffic={}, units=None,
                          peak_bytes=2e9)
    read = {name: spec.load_reader(name)(ctx) for name in READERS}
    assert read["device_idle_share.train"] == pytest.approx(40.0)
    assert read["transfer_sweep_ms_per_step"] == pytest.approx(0.4)
    assert read["launches_per_step.fit"] == pytest.approx(3 / 32)
    assert read["peak_mem_gb.fit"] == pytest.approx(2.0)
    assert all(v is None or 0 <= v for v in read.values())


@pytest.mark.parametrize("workload", [BRICK, BORN])
def test_traced_run_without_device_events_fails(workload):
    with pytest.raises(RunError) as err:
        toy_run(workload, trace=True)
    assert err.value.code == EXIT_NO_DEVICE_EVENTS
