"""The rank form of the bond-sliced contractions: two ``torch.distributed``
ranks (gloo, on the host), one per position of a ``model`` axis of 2,
held against the same functions in one process.

One process group serves the whole file: a module-scoped fixture spawns
the two ranks once, each runs every case below and sends its results
back.  The ranks unpickle their function from this module, so it imports
no JAX.  Tolerances: values within float32 rounding (rtol 1e-6), each
rank's gradient within 1e-5 of the one-process gradient (max-abs
normalised), fits at rtol 1e-5; the two ranks' params after a fit are
bit-equal.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from tneq_tpu_torch.graph import (
    build_brick_wall_incidence,
    incidence_to_graph,
    mps_graph,
    parse_graph,
    wall_graph,
)
from tneq_tpu_torch.model.qctn import init_params, params_to_numpy
from tneq_tpu_torch.ops import measurement_matrices
from tneq_tpu_torch.ops.complex_pair import to_pair
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.parallel import make_mesh, make_sliced_siamese_fn, sliced_nll_loss
from tneq_tpu_torch.parallel import mp as tmp
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit
from tneq_tpu_torch.train.trainer import basis_states

torch.set_num_threads(1)

WORLD = 2
FIT_STEPS = 3
TIMEOUT_S = 240


def _graph(kind):
    if kind.startswith("brick"):
        nq, nc = int(kind[5]), int(kind[7])
        return parse_graph(incidence_to_graph(build_brick_wall_incidence(nq, nc)))
    return parse_graph({"wall_d2": wall_graph(4, layers=2, dim=2),
                        "wall_d3": wall_graph(4, layers=2, dim=3),
                        "mps_d3": mps_graph(3, dim=3)}[kind])


# (topology, form): the log overlap on brick walls, and over a rank-3 bond
# (slice space padded 3 -> 4: rank 1 runs one slice)
LOG_CASES = [("brick5x3", "float32"), ("brick4x2", "complex64"), ("brick4x2", "pair"),
             ("wall_d3", "complex64")]
SIAMESE_CASES = [("wall_d2", 2), ("mps_d3", 3)]  # (topology, Hermite order = rank)


def _log_inputs(kind, form):
    g = _graph(kind)
    dt = torch.float32 if form == "float32" else torch.complex64
    pa, pb = init_params(g, 0, dt, device="cpu"), init_params(g, 1, dt, device="cpu")
    if form == "pair":
        pa, pb = ({k: to_pair(v) for k, v in p.items()} for p in (pa, pb))
    return g, pa, pb


def _siamese_inputs(kind, K):
    g = _graph(kind)
    p = init_params(g, 7, torch.complex64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(4, g.nqubits)), dtype=torch.float32)
    mx = measurement_matrices(x, K).to(torch.complex64)
    return g, p, basis_states(g, dtype=torch.complex64, device="cpu"), \
        [mx[:, q] for q in range(g.nqubits)]


def _value_and_grad(fn, params):
    x = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = fn(x)
    return out.detach(), dict(zip(x, torch.autograd.grad(out, list(x.values()))))


def _fit_inputs():
    g = _graph("brick4x2")
    p = init_params(g, 0, torch.float32, device="cpu")
    t = init_params(g, 3, torch.float32, device="cpu")
    mask = torch.ones(g.ncores)
    tmask = mask.clone()
    tmask[2] = 0.0
    return g, p, mask, t, tmask


def _make_fit(g, mesh):
    return make_masked_network_fidelity_fit(g, sgdg(1e-2, momentum=0.9), max_steps=FIT_STEPS,
                                            tol=1e-6, dtype=torch.float32, mesh=mesh,
                                            device="cpu")


def _numpy(d):
    return {k: v.detach().numpy() for k, v in d.items()}


def _rank_main(rank, port, queue):
    """Every case of this file on one rank; results go back on ``queue``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_mesh({"model": WORLD}, devices=["cpu"] * WORLD)
        out = {"rank": rank, "log": {}, "siamese": {}}
        for kind, form in LOG_CASES:
            g, pa, pb = _log_inputs(kind, form)
            f = tmp.make_sliced_log_overlap_fn(g, mesh, pair=form == "pair")
            val, grad = _value_and_grad(lambda p: f(p, pb), pa)
            out["log"][kind, form] = (float(val), _numpy(f.reduce_gradients(grad)), f.ranks)
        for kind, K in SIAMESE_CASES:
            g, p, st, ms = _siamese_inputs(kind, K)
            raw = make_sliced_siamese_fn(g, mesh)(p, st, ms)
            fn = tmp.make_sliced_siamese_fn(g, mesh)
            loss, grad = _value_and_grad(lambda q: sliced_nll_loss(g, mesh, q, st, ms), p)
            out["siamese"][kind] = (raw.numpy(), float(loss), _numpy(fn.reduce_gradients(grad)))
        g, p1, p2 = _log_inputs("wall_d2", "complex64")
        f2 = tmp.make_sliced_two_network_fn(g, g, mesh)
        val, grad = _value_and_grad(lambda q: f2(q, p2).abs() ** 2, p1)
        out["two_network"] = (complex(f2(p1, p2)), float(val), _numpy(f2.reduce_gradients(grad)))
        g, p, mask, t, tmask = _fit_inputs()
        fit = _make_fit(g, mesh)
        res = fit(p, mask, t, tmask)
        out["fit"] = (_numpy(res.params), float(res.infidelity), res.steps)
        errors = {}
        for name, call in (
            ("batched", lambda: fit.batched(p, mask[None], t, tmask)),
            ("data_axis", lambda: tmp.make_sliced_log_overlap_fn(
                g, make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4))),
            ("world_size", lambda: tmp.make_sliced_log_overlap_fn(
                g, make_mesh({"model": 4}, devices=["cpu"] * 4))),
        ):
            try:
                call()
                errors[name] = None
            except (NotImplementedError, ValueError) as e:
                errors[name] = (type(e).__name__, str(e))
        out["errors"] = errors
        queue.put(out)
    except Exception as e:  # report, so the parent fails at once
        queue.put({"rank": rank, "failed": repr(e)})
        raise
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, queue)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        outs = [queue.get(timeout=TIMEOUT_S) for _ in range(WORLD)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    failed = [o["failed"] for o in outs if "failed" in o]
    assert not failed, failed
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return sorted(outs, key=lambda o: o["rank"])


@pytest.fixture(scope="module")
def one_mesh():
    return make_mesh({"model": WORLD}, devices=["cpu"] * WORLD)


def _max_rel(got, ref):
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


@pytest.mark.parametrize("kind,form", LOG_CASES)
def test_rank_log_overlap_equals_one_process(ranks, one_mesh, kind, form):
    """Each rank's value, and its gradient after the sum over ranks, equal
    the one-process form's: the gradient of the unsliced overlap, not twice
    it."""
    g, pa, pb = _log_inputs(kind, form)
    f = tmp.make_sliced_log_overlap_fn(g, one_mesh, pair=form == "pair")
    val, grad = _value_and_grad(lambda p: f(p, pb), pa)
    grad = _numpy(grad)
    for out in ranks:
        r_val, r_grad, is_ranks = out["log"][kind, form]
        assert is_ranks
        np.testing.assert_allclose(r_val, float(val), rtol=1e-6, atol=1e-6)
        assert _max_rel(r_grad, grad) < 1e-5


@pytest.mark.parametrize("kind,K", SIAMESE_CASES)
def test_rank_siamese_and_nll_equal_one_process(ranks, one_mesh, kind, K):
    g, p, st, ms = _siamese_inputs(kind, K)
    raw = make_sliced_siamese_fn(g, one_mesh)(p, st, ms).numpy()
    loss, grad = _value_and_grad(lambda q: sliced_nll_loss(g, one_mesh, q, st, ms), p)
    for out in ranks:
        r_raw, r_loss, r_grad = out["siamese"][kind]
        np.testing.assert_allclose(r_raw, raw, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-6)
        assert _max_rel(r_grad, _numpy(grad)) < 1e-5


def test_rank_two_network_equals_one_process(ranks, one_mesh):
    g, p1, p2 = _log_inputs("wall_d2", "complex64")
    f2 = tmp.make_sliced_two_network_fn(g, g, one_mesh)
    val, grad = _value_and_grad(lambda q: f2(q, p2).abs() ** 2, p1)
    ov = complex(f2(p1, p2))
    for out in ranks:
        r_ov, r_val, r_grad = out["two_network"]
        assert abs(r_ov - ov) < 1e-6 * max(1.0, abs(ov))
        np.testing.assert_allclose(r_val, float(val), rtol=1e-6)
        assert _max_rel(r_grad, _numpy(grad)) < 1e-5


def test_rank_fit_replicas_stay_equal(ranks, one_mesh):
    """A 3-step masked fit (SGD-G, the retraction's generator seeded alike
    on each rank): the ranks' params are bit-equal, and equal to the
    one-process fit's to float32 rounding."""
    r0, r1 = (out["fit"] for out in ranks)
    assert r0[2] == r1[2] == FIT_STEPS and r0[1] == r1[1]
    assert all(np.array_equal(r0[0][k], r1[0][k]) for k in r0[0])
    g, p, mask, t, tmask = _fit_inputs()
    res = _make_fit(g, one_mesh)(p, mask, t, tmask)
    assert res.steps == r0[2]
    np.testing.assert_allclose(r0[1], float(res.infidelity), rtol=1e-5)
    assert _max_rel(r0[0], params_to_numpy(res.params)) < 1e-5


def test_rank_form_refusals(ranks):
    """Lanes and a data axis across ranks wait for the data-parallel layer
    (item 11b); the rank form takes one rank per model position."""
    for out in ranks:
        err = out["errors"]
        assert err["batched"][0] == "NotImplementedError" and "11b" in err["batched"][1]
        assert err["data_axis"][0] == "NotImplementedError" and "11b" in err["data_axis"][1]
        assert err["world_size"][0] == "ValueError" and "one rank per" in err["world_size"][1]
