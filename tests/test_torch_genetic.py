"""The genetic structure search: the port against the JAX package.

Structure (individuals, generations, whole searches) is decided by the numpy
generator, Python's ``random`` and the losses only, so both packages are
driven with the same seeds and, for whole searches, a deterministic stub
evaluator whose loss is a function of the DSL.  Fits are compared from the
same starting cores: JAX's own draws, handed to the port as numpy.
"""

import json
import random
import subprocess
import sys
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tneq_tpu import genetic as jg
from tneq_tpu.apps import structure_search as j_cli
from tneq_tpu.model.qctn import init_params as j_init_params
from tneq_tpu.ops.contract import make_two_network_fn as j_two_network
from tneq_tpu.ops.pairwise import make_log_abs_two_network_fn as j_log_two
from tneq_tpu_torch.apps import structure_search
from tneq_tpu_torch.genetic import (
    REASONS,
    CandidateEvaluator,
    DeviceFarm,
    EvolutionSearch,
    Generation,
    Individual,
    default_fitness,
)
from tneq_tpu_torch.genetic.codes import reason_name
from tneq_tpu_torch.graph import mps_graph, parse_graph, render_dsl
from tneq_tpu_torch.graph.surgery import with_bond_ranks
from tneq_tpu_torch.model.qctn import init_params
from tneq_tpu_torch.native import build as native_build
from tneq_tpu_torch.ops import chain_overlap, transfer_step

torch.set_num_threads(1)

TEMPLATE = Individual.create_full_connection("t", tn_size=3, tn_rank=2).graph.to_dsl()
# a candidate with one bond of the goal cut
PRUNED = TEMPLATE.replace("-2-A-2-B-2-C-2-", "-2-A-----B-2-C-2-", 1)
EV_KW = dict(n_iter=10, max_iterations=30, method="adam", learning_rate=5e-2)


def _dsls(indvs):
    return [i.graph.to_dsl() for i in indvs]


def _same_individuals(ours, theirs):
    assert [i.scope for i in ours] == [i.scope for i in theirs]
    assert [i.parents for i in ours] == [i.parents for i in theirs]
    assert _dsls(ours) == _dsls(theirs)
    assert [i.sparsity for i in ours] == [i.sparsity for i in theirs]


# -- individuals and generations ---------------------------------------------


def test_codes_match_jax():
    for name in ("REACH_MAX_ITER", "HARD_TIMEOUT", "FAKE_RESULT"):
        assert getattr(REASONS, name) == getattr(jg.REASONS, name)
        assert reason_name(getattr(REASONS, name)) == name
    assert reason_name(9) == "UNKNOWN(9)"
    assert default_fitness(0.25, 0.1) == jg.default_fitness(0.25, 0.1)


@pytest.mark.parametrize("size", [3, 4])
def test_individual_factories_match_jax(size):
    full = Individual.create_full_connection("f", tn_size=size, tn_rank=3, presented_shape=2)
    jfull = jg.Individual.create_full_connection("f", tn_size=size, tn_rank=3,
                                                 presented_shape=2)
    _same_individuals([full], [jfull])
    for sparsity in (0.3, -0.5):
        ours = [Individual.create_random(f"r{i}", tn_size=size, init_sparsity=sparsity,
                                         rng=np.random.default_rng(i)) for i in range(4)]
        theirs = [jg.Individual.create_random(f"r{i}", tn_size=size, init_sparsity=sparsity,
                                              rng=np.random.default_rng(i)) for i in range(4)]
        _same_individuals(ours, theirs)
        for i in ours:
            parse_graph(i.graph.to_dsl())


@pytest.mark.parametrize("weights", [None, (0.6, 0.3, 0.1), (0.0, 0.0, 1.0)])
def test_mutations_match_jax(weights):
    for src in (TEMPLATE, mps_graph(8, 2)):
        ours = Individual("m", src, rng=np.random.default_rng(7))
        theirs = jg.Individual("m", src, rng=np.random.default_rng(7))
        for _ in range(30):
            ours.mutate(weights=weights)
            theirs.mutate(weights=weights)
            _same_individuals([ours], [theirs])
    for bad in ((1.0, 1.0), (-1.0, 1.0, 1.0), (0.0, 0.0, 0.0)):
        with pytest.raises(ValueError, match="weights"):
            Individual("m", TEMPLATE).mutate(weights=bad)


def test_crossover_matches_jax():
    pairs = []
    for pkg in (None, jg):
        cls = Individual if pkg is None else pkg.Individual
        rng = np.random.default_rng(3)
        a = cls.create_random("a", tn_size=4, init_sparsity=0.4, rng=rng)
        b = cls.create_random("b", tn_size=4, init_sparsity=0.4, rng=rng)
        kids = [c for _ in range(4) for c in a.crossover(b)]
        pairs.append(kids)
    _same_individuals(*pairs)
    with pytest.raises(ValueError, match="equal qubit counts"):
        Individual("a", TEMPLATE).crossover(Individual("b", mps_graph(4, 2)))


def test_fitness_and_training_results_match_jax():
    for cls in (Individual, jg.Individual):
        ind = cls.create_full_connection("f", tn_size=3)
        assert ind.calculate_fitness() == float("inf")
        assert ind.set_training_result(0.1, 100)
        assert ind.fitness_score == pytest.approx(default_fitness(ind.sparsity, 0.1))
        d = cls.create_full_connection("d", tn_size=3, discard_hard_timeout_result=True)
        assert not d.set_training_result(0.5, 10, REASONS.HARD_TIMEOUT)
        assert not d.report_loss
    pruned = Individual("p", TEMPLATE)
    pruned.graph.modify_bond(0, "A", 0)
    assert pruned._calculate_sparsity() < Individual("f", TEMPLATE).sparsity
    assert Individual("x", "-2-A-2-").get_training_info() == jg.Individual(
        "x", "-2-A-2-").get_training_info()


def _stub_loss(dsl: str) -> float:
    """A deterministic loss of the structure alone."""
    return (zlib.crc32(dsl.encode()) % 997) / 997.0


_GP = {
    "evaluate_repeat": 2,
    "sparsity_threshold": 0.1,
    "society_property": {"society": [dict(n_individuals_span=6), dict(n_individuals_span=5)]},
    "n_societies": 2,
}
_EP = {"top_k": 3, "n_copy": 3, "crossover_prob": 0.5, "elitism": 1,
       "mutations_per_child": 2, "mutation_weights": [0.5, 0.3, 0.2]}


def _drive_generations(pkg, n_gen=3):
    """Generations of both packages from the same seeds: the work queue,
    results from the stub loss, ranking, evolution; returns every state."""
    gen_cls = Generation if pkg is None else pkg.Generation
    random.seed(12)
    rng = np.random.default_rng(4)
    gen = gen_cls(name="G000", generation_property=_GP, evolution_property=_EP,
                  rng=rng, tn_size=4)
    states, queue = [], []
    for g in range(n_gen):
        while not gen.is_finished():
            indv = gen.next_to_evaluate()
            if indv is None:
                break
            queue.append(indv.scope)
            gen.collect_result(indv, _stub_loss(indv.graph.to_dsl()), 10,
                               REASONS.REACH_MAX_ITER)
        gen.evaluate()
        states.append((gen.state_dict(), gen.stats(), gen.best().scope,
                       [s.indv_ranking for s in gen.societies.values()]))
        gen.evolve()
        states.append(gen.state_dict())
        gen = gen_cls(parent=gen, name=f"G{g + 1:03d}", generation_property=_GP,
                      evolution_property=_EP, rng=rng, tn_size=4)
    states.append(gen.state_dict())
    return states, queue


def test_generations_match_jax():
    """Society names (Python's random), random and carried populations,
    the queue with repeats and the sparsity kill rule, ranking, elitism,
    crossover, weighted multi-mutation: identical, generation by
    generation."""
    ours, theirs = _drive_generations(None), _drive_generations(jg)
    assert ours[1] == theirs[1]
    for a, b in zip(ours[0], theirs[0]):
        if isinstance(a, tuple):
            assert a[:3] == b[:3]
            assert [list(map(int, r)) for r in a[3]] == [list(map(int, r)) for r in b[3]]
        else:
            assert a == b
    # both paths of the queue were taken: fake results and real ones
    reasons = {r for m in ours[0][0][0]["societies"].values() for i in m for r in i["reasons"]}
    assert reasons == {REASONS.REACH_MAX_ITER, REASONS.FAKE_RESULT}


def test_state_dict_restore_round_trip():
    states, _ = _drive_generations(None, n_gen=1)
    for state in states[:1] + states[1:]:
        st = state[0] if isinstance(state, tuple) else state
        ours = Generation.restore(st, generation_property=_GP, evolution_property=_EP,
                                  rng=np.random.default_rng(0), tn_size=4)
        theirs = jg.Generation.restore(st, generation_property=_GP, evolution_property=_EP,
                                       rng=np.random.default_rng(0), tn_size=4)
        assert ours.state_dict() == st == theirs.state_dict()
        assert [i.scope for i in ours.indv_to_distribute] == [
            i.scope for i in theirs.indv_to_distribute]
        assert [i.fitness_score for s in ours.societies.values() for i in s.individuals] == [
            i.fitness_score for s in theirs.societies.values() for i in s.individuals]


# -- the evaluator --------------------------------------------------------------


@pytest.fixture(scope="module")
def goal():
    """The 3-qubit full-connection goal, JAX's PRNGKey(0) cores as numpy."""
    graph = parse_graph(TEMPLATE)
    cores = {k: np.asarray(v) for k, v in
             j_init_params(graph, jax.random.PRNGKey(0), jnp.float32).items()}
    return graph, cores


def _ours(graph, cores, dtype=torch.float32, **kw):
    params = {k: torch.tensor(v, dtype=dtype) for k, v in cores.items()}
    return CandidateEvaluator(graph, params, dtype=dtype, **kw)


def _theirs(graph, cores, dtype=jnp.float32, **kw):
    params = {k: jnp.asarray(v, dtype) for k, v in cores.items()}
    return jg.CandidateEvaluator(graph, params, dtype=dtype, **kw)


def _jax_starts(src, key, repeats, dtype):
    keys = jax.random.split(jax.random.PRNGKey(key), repeats)
    starts = jax.vmap(lambda k: j_init_params(parse_graph(src), k, dtype))(keys)
    return {k: np.array(v) for k, v in starts.items()}


_CASES = [("overlap_mse", torch.float32, jnp.float32),
          ("log_fidelity", torch.float32, jnp.float32),
          ("overlap_mse", torch.complex64, jnp.complex64)]


@pytest.mark.parametrize("loss,dtype,jdtype", _CASES, ids=["mse", "log", "mse-c64"])
@pytest.mark.parametrize("src", [TEMPLATE, PRUNED], ids=["same", "pruned"])
def test_evaluator_chunks_match_jax(goal, loss, dtype, jdtype, src):
    """Per-chunk losses of two lanes from JAX's own starting cores: JAX's
    evaluation at budgets of 1, 2 and 3 chunks against the port's."""
    graph, cores = goal
    if jdtype == jnp.complex64:
        cores = {k: (v + 0.5j * v[::-1]).astype(np.complex64) for k, v in cores.items()}
    starts = _jax_starts(src, 1, 2, jdtype)
    ours, theirs = [], []
    for chunks in (1, 2, 3):
        kw = dict(EV_KW, max_iterations=10 * chunks, loss=loss)
        o = _ours(graph, cores, dtype, **kw)._evaluate_from(src, starts)
        t = _theirs(graph, cores, jdtype, **kw).evaluate(src, jax.random.PRNGKey(1), 2)
        assert o[1:] == t[1:] == (10 * chunks, REASONS.REACH_MAX_ITER)
        ours.append(o[0])
        theirs.append(np.asarray(t[0]))
    ours, theirs = np.array(ours), np.array(theirs)
    assert ours.shape == (3, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
    if not dtype.is_complex:  # adam steps complex cores uphill, in JAX too (ROADMAP C)
        assert ours[-1].min() < ours[0].min()


@pytest.mark.parametrize("loss,dtype,jdtype", _CASES, ids=["mse", "log", "mse-c64"])
def test_loss_gradient_matches_jax(goal, loss, dtype, jdtype):
    """The evaluator's loss and its gradient at one point against
    ``jax.grad`` of the JAX evaluator's formula (torch's gradient of a real
    loss of complex cores is the conjugate of JAX's)."""
    graph, cores = goal
    cand = parse_graph(PRUNED)
    point = {k: v[0] for k, v in _jax_starts(PRUNED, 2, 1, jdtype).items()}
    gp = {k: v.astype(point["A"].dtype) for k, v in cores.items()}
    ev = _ours(graph, gp, dtype, loss=loss)
    loss_fn, g = ev._loss_fn(cand), ev._goal()
    params = {k: torch.as_tensor(v) for k, v in point.items()}
    grads, (value, _) = torch.func.grad_and_value(lambda p: loss_fn(p, g), has_aux=True)(params)

    jgoal = {k: jnp.asarray(v) for k, v in gp.items()}
    if loss == "log_fidelity":
        cg, cc, gg = j_log_two(cand, graph), j_log_two(cand, cand), j_log_two(graph, graph)

        def jloss(p):
            return -(2.0 * cg(p, jgoal) - cc(p, p) - gg(jgoal, jgoal))
    else:
        ov = j_two_network(cand, graph)

        def jloss(p):
            d = ov(p, jgoal) - 1.0
            return jnp.real(d) ** 2 + jnp.imag(d) ** 2

    jvalue, jgrads = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in point.items()})
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-5, atol=1e-6)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jgrads.values())
    for k, v in jgrads.items():
        want = np.conj(np.asarray(v))
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0, atol=1e-4 * scale)


def test_chunk_cache_is_shared_per_signature(goal):
    graph, cores = goal
    ev = _ours(graph, cores, n_iter=5, max_iterations=10)
    ev.evaluate(TEMPLATE, 0)
    assert len(ev._cache) == 1
    ev.evaluate(TEMPLATE, 1, repeats=3)  # another lane count, the same chunk
    assert len(ev._cache) == 1
    twin = ev.clone(torch.device("cpu"))
    assert twin._cache is ev._cache and twin.device == torch.device("cpu")
    twin.evaluate(PRUNED, 0)
    assert len(ev._cache) == 2
    # log<goal|goal> is computed once per evaluator, not per step
    lf = _ours(graph, cores, n_iter=5, max_iterations=5, loss="log_fidelity")
    lf.evaluate(TEMPLATE, 0)
    first = lf._log_gg
    lf.evaluate(PRUNED, 0)
    assert first is not None and lf._goal()[1] is first and not first.requires_grad
    # the same seed gives the same restarts, other seeds others
    a, b, c = (ev.evaluate(TEMPLATE, s, repeats=2)[0] for s in (4, 4, 5))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and a[0] != a[1]


def test_mismatched_boundary_and_bad_loss_raise(goal):
    graph, cores = goal
    ev = _ours(graph, cores)
    with pytest.raises(ValueError, match="boundary ranks"):
        ev.evaluate("-3-A-3-\n-3-A-3-\n-3-A-3-", 0)
    with pytest.raises(ValueError, match="boundary ranks"):
        ev._evaluate_from("-3-A-3-\n-3-A-3-\n-3-A-3-", {})
    with pytest.raises(ValueError, match="unknown loss"):
        _ours(graph, cores, loss="mse")


def test_timeout_and_tol_stop_between_chunks_like_jax(goal):
    graph, cores = goal
    starts = _jax_starts(TEMPLATE, 1, 1, jnp.float32)
    for kw, want in ((dict(timeout=0.0), (10, REASONS.HARD_TIMEOUT)),
                     (dict(tol=10.0), (10, REASONS.REACH_MAX_ITER))):
        o = _ours(graph, cores, **dict(EV_KW, **kw))._evaluate_from(TEMPLATE, starts)
        t = _theirs(graph, cores, **dict(EV_KW, **kw)).evaluate(TEMPLATE,
                                                               jax.random.PRNGKey(1), 1)
        assert o[1:] == t[1:] == want


def test_30_qubits_log_loss_is_finite_and_discriminative():
    """At 30 qubits (cores x8) the raw overlap loss overflows float32 while
    −log F stays finite and ranks the full-rank candidate above the one
    with every internal bond cut to rank 1."""
    goal_graph = parse_graph(mps_graph(30, dim=2))
    gp = {k: 8.0 * v for k, v in init_params(goal_graph, 0, torch.float32, "cpu").items()}
    same = mps_graph(30, dim=2)
    internal = {(min(c.index, e.neighbor), max(c.index, e.neighbor), e.qubit): 1
                for c in goal_graph.cores for e in c.in_edges + c.out_edges
                if e.neighbor >= 0}
    weak = render_dsl(with_bond_ranks(goal_graph, internal))
    raw = CandidateEvaluator(goal_graph, gp, n_iter=2, max_iterations=2,
                             learning_rate=1e-2, loss="overlap_mse")
    assert not np.isfinite(raw.evaluate(same, 1)[0]).all()
    log_ev = CandidateEvaluator(goal_graph, gp, n_iter=5, max_iterations=10,
                                learning_rate=5e-2, loss="log_fidelity")
    l_same, l_weak = (log_ev.evaluate(s, 1, repeats=2)[0] for s in (same, weak))
    assert np.isfinite(l_same).all() and np.isfinite(l_weak).all()
    assert l_same.min() < l_weak.min()


# -- searches -----------------------------------------------------------------


class _Stub(CandidateEvaluator):
    """The port's evaluator with the fit replaced by :func:`_stub_loss`."""

    def __init__(self):
        self._cache = {}
        self.calls = 0

    def clone(self, device=None):
        return self

    def evaluate(self, graph_string, seed, repeats=1):
        self.calls += 1
        return np.full(repeats, _stub_loss(graph_string)), 10, REASONS.REACH_MAX_ITER


class _JStub(jg.CandidateEvaluator):
    def __init__(self):
        pass

    def clone(self, device=None):
        return self

    def evaluate(self, graph_string, key, repeats=1):
        return np.full(repeats, _stub_loss(graph_string)), 10, REASONS.REACH_MAX_ITER


def _search_kw(**kw):
    gp = {"evaluate_repeat": 2,
          "society_property": {"society": [dict(n_individuals_span=6,
                                                graph_string_template=mps_graph(6, 2))]}}
    return dict(dict(generation_property=gp, evolution_property=_EP, max_generation=4,
                     tn_size=6, verbose=False, seed=5, clear_caches_every=1), **kw)


def _summary(search, best):
    hist = [{k: v for k, v in h.items() if k != "wall_time"} for h in search.history]
    return hist, best.scope, best.graph.to_dsl(), best.fitness_score, best.report_loss


@pytest.mark.parametrize("farmed", [False, True], ids=["serial", "farm"])
def test_stub_search_matches_jax(farmed):
    """A whole search with crossover, elitism 1, two weighted mutations per
    child and a cache clear every generation: the same history and best
    graph as JAX's."""
    random.seed(0)
    devices = [torch.device("cpu")] * 2 if farmed else None
    ours = EvolutionSearch(_Stub(), devices=devices, **_search_kw())
    got = _summary(ours, ours.run())
    if ours.farm is not None:
        ours.farm.shutdown()
    random.seed(0)
    theirs = jg.EvolutionSearch(_JStub(), **_search_kw())
    assert got == _summary(theirs, theirs.run())
    best = [h["best_fitness"] for h in ours.history]
    assert best == sorted(best, reverse=True)  # elitism: never worse


def _real_kw(**kw):
    gp = {"evaluate_repeat": 2,
          "society_property": {"society": [dict(n_individuals_span=4,
                                                graph_string_template=TEMPLATE)]}}
    return dict(dict(generation_property=gp, evolution_property={"top_k": 2, "n_copy": 2},
                     max_generation=2, tn_size=3, verbose=False, seed=3), **kw)


def test_farm_of_two_host_workers_equals_serial(goal):
    graph, cores = goal
    random.seed(1)
    serial = EvolutionSearch(_ours(graph, cores, **EV_KW), **_real_kw())
    want = _summary(serial, serial.run())
    random.seed(1)
    farmed = EvolutionSearch(_ours(graph, cores, **EV_KW),
                             devices=[torch.device("cpu")] * 2, **_real_kw())
    assert farmed.farm.n_workers == 2
    got = _summary(farmed, farmed.run())
    farmed.farm.shutdown()
    assert got == want


def test_farm_queues_and_reports_failures(goal):
    graph, cores = goal
    with DeviceFarm(_ours(graph, cores, n_iter=5, max_iterations=5),
                    devices=["cpu", "cpu"]) as farm:
        futs = [farm.submit(TEMPLATE, i) for i in range(4)]
        bad = farm.submit("-3-A-3-\n-3-A-3-\n-3-A-3-", 0)
        results = [f.result(timeout=120) for f in futs]
        with pytest.raises(ValueError, match="boundary ranks"):
            bad.result(timeout=60)
    assert all(np.isfinite(r[0]).all() for r in results)
    assert farm._outstanding == [0, 0]
    with pytest.raises(ValueError, match="at least one device"):
        DeviceFarm(_ours(graph, cores), devices=[])


class _Flaky(_Stub):
    def __init__(self, die_at):
        super().__init__()
        self.die_at = die_at

    def evaluate(self, graph_string, seed, repeats=1):
        if self.calls + 1 == self.die_at:
            self.calls += 1
            raise RuntimeError("simulated crash")
        return super().evaluate(graph_string, seed, repeats)


def test_abnormal_evaluations_become_fake_results():
    random.seed(2)
    s = EvolutionSearch(_Flaky(die_at=3), max_abnormal=5, **_search_kw(max_generation=1))
    s.run()
    assert s.status.abnormal_counter == 1
    random.seed(2)
    with pytest.raises(RuntimeError, match="too many abnormal"):
        EvolutionSearch(_Flaky(die_at=3), max_abnormal=0, **_search_kw()).run()


def test_crash_and_resume_equals_an_uninterrupted_run(goal, tmp_path):
    """Killed in generation 1, resumed from the checkpoint of its boundary
    (population, numpy and torch generator states, history): the same
    history and best as an uninterrupted run, with the real evaluator."""
    graph, cores = goal
    random.seed(3)
    clean = EvolutionSearch(_ours(graph, cores, **EV_KW), **_real_kw())
    want = _summary(clean, clean.run())

    class Flaky(CandidateEvaluator):
        calls = 0

        def evaluate(self, g, seed, repeats=1):
            Flaky.calls += 1
            if Flaky.calls == 6:  # generation 1
                raise RuntimeError("simulated crash")
            return super().evaluate(g, seed, repeats)

    ckpt = str(tmp_path / "search.json")
    random.seed(3)
    params = {k: torch.tensor(v) for k, v in cores.items()}
    crashing = EvolutionSearch(Flaky(graph, params, **EV_KW), checkpoint_path=ckpt,
                               max_abnormal=0, **_real_kw())
    with pytest.raises(RuntimeError):
        crashing.run()
    state = json.load(open(ckpt))
    assert state["generation_index"] == 1 and "generator" in state and "key" not in state
    resumed = EvolutionSearch.resume(ckpt, _ours(graph, cores, **EV_KW), **_real_kw())
    got = _summary(resumed, resumed.run())
    assert got[1:] == want[1:]
    assert got[0] == want[0]
    done = json.load(open(ckpt))
    assert done["generation_index"] == 2 and done["best"]["scope"] == want[1]
    # resuming a finished search returns the saved best at once
    again = EvolutionSearch.resume(ckpt, _Stub(), **_real_kw())
    assert again.run().scope == want[1]


def test_cli_runs_on_the_host(tmp_path, capsys):
    out = str(tmp_path / "best.json")
    ckpt = str(tmp_path / "ck.json")
    args = ["--device", "cpu", "--tn-size", "3", "--population", "3", "--generations", "2",
            "--evaluate-repeat", "1", "--train-steps", "10", "--top-k", "2", "--n-copy", "2",
            "--elitism", "1", "--crossover-prob", "0.5", "--mutation-weights", "1,1,0",
            "--mutations-per-child", "2", "--loss", "log_fidelity", "--save", out,
            "--checkpoint", ckpt]
    random.seed(0)
    res = structure_search.main(args)
    saved = json.load(open(out))
    assert saved["graph"] == res["graph"] and len(saved["history"]) == 2
    assert all(np.isfinite(saved["losses"]))
    random.seed(0)
    resumed = structure_search.main(args + ["--resume"])  # a finished search
    assert resumed["graph"] == res["graph"] and resumed["scope"] == res["scope"]
    assert "best individual" in capsys.readouterr().out


@pytest.mark.parametrize("extra,msg", [
    (["--template-graph=-2-A-2-\n-2-A-2-"], "qubits"),
    (["--resume"], "--resume requires --checkpoint"),
    (["--resume", "--checkpoint", "/nonexistent/ck.json"], "checkpoint file not found"),
])
def test_cli_errors_like_jax(extra, msg, capsys):
    for cli in (structure_search, j_cli):
        dev = ["--device", "cpu"] if cli is structure_search else []
        with pytest.raises(SystemExit) as e:
            cli.main(["--tn-size", "3", "--generations", "1"] + dev + extra)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


# -- threads --------------------------------------------------------------------


def test_two_threads_build_the_path_finder_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    out, errors = [], []

    def work():
        try:
            out.append(native_build.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(out) == 2 and out[0] == out[1] and out[0].exists()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [out[0].name]
    # the library loads and finds a path
    code = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
            "print(bool(lib.tneq_find_path))")
    res = subprocess.run([sys.executable, "-c", code, str(out[0])], capture_output=True,
                         text=True, timeout=60)
    assert res.stdout.strip() == "True", res.stderr


def test_launch_counters_lose_no_update_under_threads():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for mod, name in ((chain_overlap, "chain_sweep_fwd"),
                          (transfer_step, "transfer_step")):
            mod.reset_launch_counts()
            threads = [threading.Thread(target=lambda: [mod._count_launch(name)
                                                        for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert mod.launch_counts()[name] == 16 * 2000
            mod.reset_launch_counts()
    finally:
        sys.setswitchinterval(interval)
