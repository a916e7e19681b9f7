"""Spans of the port (``utils/profiling.annotate``): recorded in memory, on
the profiler's clock, only while a ``torch.profiler`` session runs.

The host tests drive a 4 × 2 brick wall's network-mode ``fit.batched`` (2
lanes, a chunk of 2 steps).  The card test imports no JAX and runs on the
machine with the card with the repository's conftest left out::

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

from __future__ import annotations

import glob
import json
import sys
import threading
from collections import Counter

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from tneq_tpu_torch.utils import profiling
from tneq_tpu_torch.utils.profiling import annotate, clear_spans, spans, trace

K = 2  # steps of the chunk
ROWS = 4  # the 4 × 2 wall's rows, each in a row_sweep.row span
SLACK_NS = 500_000  # the profiler's clock converter against time.time_ns()


@pytest.fixture(scope="module")
def toy():
    from tneq_tpu_torch.apps.symmetry_breaking import SymmetryBreakingConfig, make_experiment
    from tneq_tpu_torch.model.qctn import init_params

    exp = make_experiment(SymmetryBreakingConfig(
        n_qubits=4, n_cells=2, fidelity_mode="network", prune_steps=K, device="cpu"))
    g = exp.graph
    params = init_params(g, 0, torch.complex64, device="cpu")
    target = init_params(g, 1, torch.complex64, device="cpu")
    masks = torch.ones(2, g.ncores)
    masks[0, 0] = 0.0
    masks[1, 1] = 0.0
    target_mask = torch.ones(g.ncores)

    def piece():
        return exp.prune_fit.batched(params, masks, target, target_mask, chunk_steps=K)

    return piece


@pytest.fixture
def threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    clear_spans()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, spans(), prof


def test_without_a_profiler_annotate_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    clear_spans()
    assert not autograd_profiler._is_profiler_enabled
    assert annotate("a") is annotate("b")
    with annotate("a"):
        with annotate("b"):
            pass
    assert spans() == []


def test_profiler_flag_follows_start_and_stop():
    """``annotate`` reads ``torch.autograd.profiler._is_profiler_enabled``;
    a torch that moves the flag fails here."""
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not autograd_profiler._is_profiler_enabled
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        assert torch._C._autograd._profiler_enabled()
        assert annotate("x") is not annotate("x")
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    assert not torch._C._autograd._profiler_enabled()


def test_batched_piece_records_the_span_tree(toy, threads):
    _, sp, _ = _profiled(toy)
    assert all(s.end_ns is not None for s in sp)
    overlaps = 2 * K + 1  # two per step, and ⟨t,t⟩ once in prepare
    assert Counter(s.name for s in sp) == {
        "fit.batched": 1, "fit.prepare": 1, "driver.batched": 1, "driver.exit_test": 1,
        "driver.chunk": 1, "step.grad": K, "step.update": K, "loss.mask": K + 1,
        "row_sweep.overlap": overlaps, "row_sweep.row": overlaps * ROWS,
        "optim.cayley": K,
    }
    parent = Counter((s.name, sp[s.parent].name if s.parent >= 0 else None) for s in sp)
    assert parent == {
        ("fit.batched", None): 1,
        ("fit.prepare", "fit.batched"): 1,
        ("loss.mask", "fit.prepare"): 1,
        ("row_sweep.overlap", "fit.prepare"): 1,
        ("driver.batched", "fit.batched"): 1,
        ("driver.exit_test", "driver.batched"): 1,
        ("driver.chunk", "driver.batched"): 1,
        ("step.grad", "driver.chunk"): K,
        ("loss.mask", "step.grad"): K,
        ("row_sweep.overlap", "step.grad"): 2 * K,
        ("row_sweep.row", "row_sweep.overlap"): overlaps * ROWS,
        ("step.update", "driver.chunk"): K,
        ("optim.cayley", "step.update"): K,
    }
    assert len({s.thread for s in sp}) == 1


def test_spans_nest(toy, threads):
    _, sp, _ = _profiled(toy)
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    kids = {}
    for s in sp:
        kids.setdefault(s.parent, []).append(s)
    for group in kids.values():
        for a, b in zip(group, group[1:]):
            assert a.end_ns <= b.start_ns  # siblings in order, disjoint


def test_fit_is_bit_identical_under_the_profiler(toy, threads):
    plain = toy()
    traced, sp, _ = _profiled(toy)
    assert sp
    assert traced.steps == plain.steps == K
    assert torch.equal(traced.infidelity, plain.infidelity)
    for name, v in plain.params.items():
        assert torch.equal(traced.params[name], v), name


def test_spans_enclose_the_profilers_events(toy, threads):
    """Same clock: each span holds the ``record_function`` event the
    profiler stamped for it."""
    _, sp, prof = _profiled(toy)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        events.setdefault(ev.name(), []).append((int(ev.start_ns()), int(ev.end_ns())))
    for name in {s.name for s in sp}:
        mine = [s for s in sp if s.name == name]
        theirs = sorted(events[name])
        assert len(theirs) == len(mine), name
        for s, (start, end) in zip(mine, theirs):
            assert s.start_ns - SLACK_NS <= start <= end <= s.end_ns + SLACK_NS, name


def test_trace_clears_the_spans_and_names_them_in_its_file(tmp_path):
    def stale():
        with annotate("stale"):
            pass

    _profiled(stale)
    assert [s.name for s in spans()] == ["stale"]
    x = torch.ones(8, 8)
    with trace(str(tmp_path)):
        with annotate("outer"):
            with annotate("inner"):
                (x @ x).sum()
    sp = spans()
    assert [(s.name, s.parent) for s in sp] == [("outer", -1), ("inner", 0)]
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"outer", "inner"} <= names


def test_spans_on_two_threads_keep_their_own_parents():
    both = threading.Barrier(2)

    def work(tag):
        with annotate(f"{tag}.outer"):
            both.wait()
            with annotate(f"{tag}.inner"):
                both.wait()

    def run():
        ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    _, sp, _ = _profiled(run)
    assert len(sp) == 4
    for s in sp:
        if s.name.endswith(".inner"):
            p = sp[s.parent]
            assert p.name == s.name.split(".")[0] + ".outer" and p.thread == s.thread
        else:
            assert s.parent == -1
    assert len({s.thread for s in sp}) == 2


def test_spans_from_many_threads_are_all_kept_whole():
    """More threads than cores, switching often: no span is lost, each
    closes, and each parent is the enclosing span of its own thread."""
    n_threads, depth, reps = 16, 3, 50
    prev = sys.getswitchinterval()

    def work(t):
        for _ in range(reps):
            with annotate(f"{t}.0"):
                with annotate(f"{t}.1"):
                    with annotate(f"{t}.2"):
                        pass

    def run():
        ts = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)

    sys.setswitchinterval(1e-6)
    try:
        _, sp, _ = _profiled(run)
    finally:
        sys.setswitchinterval(prev)
    assert len(sp) == n_threads * depth * reps
    for s in sp:
        assert s.end_ns is not None
        t, level = s.name.split(".")
        if level == "0":
            assert s.parent == -1
        else:
            p = sp[s.parent]
            assert p.name == f"{t}.{int(level) - 1}" and p.thread == s.thread


@pytest.mark.cuda
def test_span_holds_the_runtime_calls_of_a_blocking_read():
    """On the card, under a profiler of CUDA activity only: a span around a
    blocking ``.cpu()`` read contains the runtime calls of that read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1 << 20, device="cuda")
    (x * 2).sum().cpu()

    def read():
        y = (x * 2).sum()
        with annotate("read"):
            y.cpu()

    _, sp, prof = _profiled(read, activities=(ProfilerActivity.CUDA,))
    (s,) = sp
    calls = [(ev.name(), int(ev.start_ns()), int(ev.end_ns()))
             for ev in prof.profiler.kineto_results.events()
             if ev.name() in ("cudaMemcpyAsync", "cudaStreamSynchronize")]
    assert any(n == "cudaMemcpyAsync" for n, _, _ in calls)
    for _, start, end in calls:
        assert s.start_ns <= start <= end <= s.end_ns
