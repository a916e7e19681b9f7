"""The rank form of the parallel layer on two ``torch.distributed`` ranks
(gloo, on the host), held against the same functions in one process: the
bond-sliced contractions, one rank per position of a ``model`` axis of 2;
the data-parallel step and the distributed trainer on a ``data`` axis of
2; the FSDP step on a ``model`` axis of 2.

One process group serves the whole file: a module-scoped fixture spawns
the two ranks once, each runs every case below and sends its results
back.  The ranks unpickle their function from this module, so it imports
no JAX.  Tolerances: values within float32 rounding (rtol 1e-6), each
rank's gradient within 1e-5 of the one-process gradient (max-abs
normalised), fits and trainer losses at rtol 1e-5, params after 3 steps
within 1e-5 (max-abs normalised); the two ranks' replicas are bit-equal.
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
from tneq_tpu_torch.parallel import (
    DistributedConfig,
    DistributedTrainer,
    data_sharding,
    make_dp_train_step,
    make_mesh,
    make_sliced_siamese_fn,
    sliced_nll_loss,
)
from tneq_tpu_torch.parallel import dp as tdp
from tneq_tpu_torch.parallel import mp as tmp
from tneq_tpu_torch.parallel.fsdp import make_fsdp_network_fit_step
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit
from tneq_tpu_torch.train.trainer import Trainer, basis_states

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


# the data-parallel step: SGD-G with the retraction off and forced
RETRACTIONS = (0.0, 1.0)
DP_STEPS = 3


def _dp_inputs(retraction_prob):
    g = _graph("wall_d2")
    trainer = Trainer(g, optimizer=sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob),
                      dtype=torch.complex64, device="cpu")
    p = init_params(g, 1, torch.complex64, device="cpu")
    xs = torch.as_tensor(np.random.default_rng(0).normal(size=(DP_STEPS, 16, g.nqubits)),
                         dtype=torch.float32)
    return trainer, p, basis_states(g, dtype=torch.complex64, device="cpu"), xs


def _dp_run(step, trainer, p, st, xs):
    o = trainer.optimizer.init(p)
    losses = []
    for x in xs:
        p, o, loss = step(p, o, st, x)
        losses.append(float(loss))
    return losses, _numpy(p)


def _trainer_config(tmp, **kw):
    return DistributedConfig(graph=wall_graph(4, layers=2, dim=2), batch_size=8, log_every=0,
                             checkpoint_dir=tmp, checkpoint_every=3, **kw)


# FSDP: 5 cores of one shape padded to 6, 3 rows per rank
FSDP_STEPS = 3


def _fsdp_inputs(mesh):
    g = parse_graph(mps_graph(6, dim=4))
    step, prepare, opt = make_fsdp_network_fit_step(g, mesh)
    return step, prepare(init_params(g, 3, torch.float32, device="cpu")), \
        prepare(init_params(g, 4, torch.float32, device="cpu")), opt


def _fsdp_run(mesh):
    step, arrays, t_arrays, opt = _fsdp_inputs(mesh)
    loss, grads = step.value_and_grad(arrays, t_arrays)
    o = opt.init(arrays)
    for _ in range(FSDP_STEPS):
        arrays, o, _ = step(arrays, o, t_arrays)
    nbytes = sum(t.numel() * t.element_size() for t in tuple(arrays) + tuple(o.momentum))
    return {"loss": float(loss), "grads": [g.numpy() for g in grads],
            "arrays": [a.numpy() for a in arrays], "state_bytes": nbytes}


def _rank_main(rank, port, queue, ckpt):
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
        out["dp"] = _rank_dp(ckpt)
        out["fsdp"] = _fsdp_run(mesh)
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


def _rank_dp(ckpt):
    """The data-parallel cases on a ``data`` axis of 2: the reduced loss and
    gradient of this rank's rows, DP_STEPS steps per retraction setting, and
    the distributed trainer run to 6 steps and resumed to 9."""
    mesh = make_mesh({"data": WORLD}, devices=["cpu"] * WORLD)
    out = {}
    for rp in RETRACTIONS:
        trainer, p, st, xs = _dp_inputs(rp)
        x = {k: v.clone().requires_grad_() for k, v in p.items()}
        loss = trainer.loss(x, st, data_sharding(mesh).local(xs[0]))
        grads = dict(zip(x, torch.autograd.grad(loss, list(x.values()))))
        loss, grads = tdp._mean_over_rows(mesh, "data")(loss.detach(), grads)
        out[rp] = (float(loss), _numpy(grads),
                   _dp_run(make_dp_train_step(trainer, mesh), trainer, p, st, xs))
    _, s1 = DistributedTrainer(_trainer_config(ckpt, max_steps=6), devices=["cpu"] * WORLD).train()
    _, s2 = DistributedTrainer(_trainer_config(ckpt, max_steps=9, resume=True),
                               devices=["cpu"] * WORLD).train()
    out["trainer"] = (s1.losses, s2.losses, s2.steps)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    ckpt = str(tmp_path_factory.mktemp("rank_ckpt"))
    procs = [ctx.Process(target=_rank_main, args=(r, port, queue, ckpt)) for r in range(WORLD)]
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
    """The rank form takes one rank per mesh position: a mesh of 4
    positions, with a data axis or not, is refused on 2 ranks; lanes of a
    fit sliced across ranks run."""
    for out in ranks:
        err = out["errors"]
        assert err["batched"] is None
        assert err["data_axis"][0] == "ValueError" and "one rank per" in err["data_axis"][1]
        assert err["world_size"][0] == "ValueError" and "one rank per" in err["world_size"][1]


@pytest.mark.parametrize("retraction_prob", RETRACTIONS)
def test_rank_dp_step_equals_one_process(ranks, retraction_prob):
    """Two data ranks, 8 rows each: the mean loss and gradient of the global
    batch as one process computes them on all 16 rows; after 3 steps the
    replicas are bit-equal and equal to the one-process params."""
    trainer, p, st, xs = _dp_inputs(retraction_prob)
    loss, grads = _value_and_grad(lambda q: trainer.loss(q, st, xs[0]), p)
    one = _dp_run(trainer.train_step, trainer, p, st, xs)
    runs = []
    for out in ranks:
        r_loss, r_grads, r_run = out["dp"][retraction_prob]
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-6)
        assert _max_rel(r_grads, _numpy(grads)) < 1e-5
        np.testing.assert_allclose(r_run[0], one[0], rtol=1e-5)
        assert _max_rel(r_run[1], one[1]) < 1e-5
        runs.append(r_run[1])
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])


def test_rank_distributed_trainer_resumes(ranks, tmp_path):
    """The distributed trainer on two data ranks: rank 0 writes the
    checkpoints, every rank resumes from step 6 and runs the 3 steps left,
    with the losses of one process."""
    _, s1 = DistributedTrainer(_trainer_config(str(tmp_path), max_steps=6),
                               devices=["cpu"]).train()
    _, s2 = DistributedTrainer(_trainer_config(str(tmp_path), max_steps=9, resume=True),
                               devices=["cpu"]).train()
    for out in ranks:
        first, resumed, steps = out["dp"]["trainer"]
        assert steps == 9 and len(resumed) == 3
        np.testing.assert_allclose(first + resumed, s1.losses + s2.losses, rtol=1e-5)


def test_rank_fsdp_equals_one_process(ranks, one_mesh):
    """FSDP on two ranks: each rank's rows of the gradient are the one
    process's rows, each keeps half the stacked params and momentum, and
    after 3 steps its rows equal the one process's, the identity pad
    (row 5, on rank 1) bit-exact."""
    one = _fsdp_run(one_mesh)
    rows = one["arrays"][0].shape[0] // WORLD
    for r, out in enumerate(ranks):
        f = out["fsdp"]
        np.testing.assert_allclose(f["loss"], one["loss"], rtol=1e-6)
        own = slice(r * rows, (r + 1) * rows)
        assert _max_rel({"g": f["grads"][0]}, {"g": one["grads"][0][own]}) < 1e-5
        assert _max_rel({"p": f["arrays"][0]}, {"p": one["arrays"][0][own]}) < 1e-5
        assert f["state_bytes"] <= 0.55 * one["state_bytes"]
    pad = ranks[1]["fsdp"]["arrays"][0][-1]
    assert np.array_equal(pad, np.eye(16, dtype=np.float32).reshape(pad.shape))
