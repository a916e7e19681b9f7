"""The rank form on a ``{"data": 2, "model": 2}`` mesh: four
``torch.distributed`` ranks (gloo, on the host), one per position, held
against the same functions in one process.

- the sliced siamese step: each rank contracts its rows of the batch and
  its share of the slices, the rows gathered over its ``data`` line, the
  gradient summed over both axes by ``fn.reduce_gradients``;
- ``check_mesh_health`` over both axes;
- ``fit.batched``: lanes of a masked fit sliced over ``model`` across the
  ranks (the combine and the gradient sum run on lane-batched tensors);
- the distributed trainer with a ``model`` axis of 2 (ROADMAP C: a data ×
  model trainer contracts through ``make_sliced_siamese_fn``);
- ``bench/multiproc_dryrun`` through its ``main``, which spawns four
  processes of its own.

One process group serves the file (module-scoped fixture); the ranks
import no JAX.  Tolerances: raw values and losses within float32 rounding
(rtol 1e-6), gradients within 1e-5 of the one-process gradient (max-abs
normalised), fits and trainer losses at rtol 1e-5, lane params within 1e-5
(max-abs normalised); the replicas of the four ranks are bit-equal.
"""

import json
import multiprocessing
import socket
import subprocess
import sys

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
from tneq_tpu_torch.model.qctn import init_params
from tneq_tpu_torch.ops import measurement_matrices
from tneq_tpu_torch.ops.contract import abs_square
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.parallel import (
    DistributedConfig,
    DistributedTrainer,
    check_mesh_health,
    make_mesh,
    make_sliced_siamese_fn,
)
from tneq_tpu_torch.train.losses import nll_loss
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit
from tneq_tpu_torch.train.trainer import basis_states

torch.set_num_threads(1)

WORLD = 4
AXES = {"data": 2, "model": 2}
TIMEOUT_S = 240
SIAMESE_CASES = [("wall", 2), ("mps", 3)]  # (topology, Hermite order); mps pads 3 -> 4 slices
LANES = 3
FIT_STEPS = 4
TRAINER_STEPS = 3


def _mesh():
    return make_mesh(AXES, devices=["cpu"] * WORLD)


def _siamese_inputs(kind, K):
    g = parse_graph(wall_graph(4, layers=2, dim=2) if kind == "wall" else mps_graph(3, dim=3))
    p = init_params(g, 7, torch.complex64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(8, g.nqubits)), dtype=torch.float32)
    mx = measurement_matrices(x, K).to(torch.complex64)
    return g, p, basis_states(g, dtype=torch.complex64, device="cpu"), \
        [mx[:, q] for q in range(g.nqubits)]


def _siamese_step(kind, K, mesh):
    """Raw values, the NLL and its gradient summed over the ranks."""
    g, p, st, ms = _siamese_inputs(kind, K)
    fn = make_sliced_siamese_fn(g, mesh)
    x = {k: v.clone().requires_grad_() for k, v in p.items()}
    raw = fn(x, st, ms)
    loss = nll_loss(abs_square(raw))
    grads = fn.reduce_gradients(dict(zip(x, torch.autograd.grad(loss, list(x.values())))))
    return raw.detach().numpy(), float(loss.detach()), \
        {k: v.numpy() for k, v in grads.items()}


def _fit_lanes(mesh):
    g = parse_graph(incidence_to_graph(build_brick_wall_incidence(4, 2)))
    fit = make_masked_network_fidelity_fit(g, sgdg(1e-2, momentum=0.9), max_steps=FIT_STEPS,
                                           tol=1e-6, dtype=torch.float32, mesh=mesh,
                                           device="cpu")
    p = init_params(g, 0, torch.float32, device="cpu")
    t = init_params(g, 3, torch.float32, device="cpu")
    tmask = torch.ones(g.ncores)
    tmask[2] = 0.0
    masks = torch.ones(LANES, g.ncores)
    for lane in range(1, LANES):
        masks[lane, lane] = 0.0
    res = fit.batched(p, masks, t, tmask, chunk_steps=2)
    return {k: v.numpy() for k, v in res.params.items()}, res.infidelity.numpy(), res.steps


def _trainer_losses(devices):
    cfg = DistributedConfig(graph=wall_graph(4, layers=2, dim=2), model_axis=2,
                            max_steps=TRAINER_STEPS, batch_size=8, log_every=0, seed=3)
    params, stats = DistributedTrainer(cfg, devices=devices).train()
    return stats.losses, {k: v.numpy() for k, v in params.items()}


def _rank_main(rank, port, queue):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = _mesh()
        out = {"rank": rank, "siamese": {kind: _siamese_step(kind, K, mesh)
                                         for kind, K in SIAMESE_CASES}}
        out["health"] = check_mesh_health(mesh, verbose=False)
        out["lanes"] = _fit_lanes(mesh)
        out["trainer"] = _trainer_losses(["cpu"] * WORLD)
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


def _max_rel(got, ref):
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


@pytest.mark.parametrize("kind,K", SIAMESE_CASES)
def test_data_model_siamese_step_equals_one_process(ranks, kind, K):
    raw, loss, grads = _siamese_step(kind, K, _mesh())
    for out in ranks:
        r_raw, r_loss, r_grads = out["siamese"][kind]
        np.testing.assert_allclose(r_raw, raw, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_loss, loss, rtol=1e-6)
        assert _max_rel(r_grads, grads) < 1e-5


def test_mesh_health_across_ranks(ranks):
    """Every axis of the 4-rank mesh passes all three checks, on gloo's
    native primitives for host tensors; the ranks agree on the report."""
    for out in ranks:
        rep = out["health"]
        assert rep["ok"] and set(rep["axes"]) == set(AXES)
        for axis in rep["axes"].values():
            assert axis["size"] == 2
            assert [axis[p]["route"] for p in ("all_gather", "psum", "ppermute")] == \
                ["all_gather", "all_reduce", "send_recv"]
            assert all(axis[p]["ok"] and axis[p]["ms"] >= 0
                       for p in ("all_gather", "psum", "ppermute"))


def test_fit_lanes_across_ranks_equal_one_process(ranks):
    params, infid, steps = _fit_lanes(_mesh())
    for out in ranks:
        r_params, r_infid, r_steps = out["lanes"]
        assert r_steps == steps
        np.testing.assert_allclose(r_infid, infid, rtol=1e-5)
        assert _max_rel(r_params, params) < 1e-5
        assert all(np.array_equal(r_params[k], ranks[0]["lanes"][0][k]) for k in r_params)


def test_data_model_trainer_equals_one_process(ranks):
    losses, params = _trainer_losses(["cpu"] * WORLD)
    for out in ranks:
        r_losses, r_params = out["trainer"]
        np.testing.assert_allclose(r_losses, losses, rtol=1e-5)
        assert _max_rel(r_params, params) < 1e-5
        assert all(np.array_equal(r_params[k], ranks[0]["trainer"][1][k]) for k in r_params)


def test_multiproc_dryrun_main():
    """``python -m tneq_tpu_torch.bench.multiproc_dryrun --device cpu``:
    four launcher-started ranks, JAX's JSON keys, the loss of the sliced
    step in one process."""
    r = subprocess.run([sys.executable, "-m", "tneq_tpu_torch.bench.multiproc_dryrun",
                        "--device", "cpu"], capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["n_processes"] == 4 and rec["n_devices"] == 4
    assert rec["mesh"] == AXES and rec["backend"] == "gloo"
    g, p, st, ms = _siamese_inputs("wall", 2)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, g.nqubits)), dtype=torch.float32)
    mx = measurement_matrices(x, 2).to(torch.complex64)
    p0 = init_params(g, 0, torch.complex64, device="cpu")
    raw = make_sliced_siamese_fn(g, _mesh())(p0, st, [mx[:, q] for q in range(g.nqubits)])
    np.testing.assert_allclose(rec["loss"], float(nll_loss(abs_square(raw))), rtol=1e-6)
