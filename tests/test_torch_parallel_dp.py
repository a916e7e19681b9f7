"""Port parity: placements, the data-parallel step, multi-process start-up
and the mesh health check (tneq_tpu_torch.parallel vs tneq_tpu.parallel),
in one process.

Mirrors ``tests/test_parallel.py::TestMesh``, ``::TestDataParallel`` and
``::TestMultihost`` and ``tests/test_aux.py::TestHealth``.  Inputs are
drawn in numpy (JAX's initial cores, a numpy batch) and handed to both
packages; JAX runs on its virtual CPU devices, the port on host positions.
Tolerances: the DP step's loss at rtol 1e-5 and its params within 5e-5
(JAX's own bound for its DP step against one device); SGD-G with the
retraction off and forced, as the packages' random streams differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.graph import wall_graph as j_wall
from tneq_tpu.model.qctn import init_params as j_init
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.parallel import make_dp_train_step as j_dp_step
from tneq_tpu.parallel import make_mesh as j_make_mesh
from tneq_tpu.parallel import shard_batch as j_shard_batch
from tneq_tpu.train.trainer import Trainer as JTrainer
from tneq_tpu.train.trainer import basis_states as j_basis_states
from tneq_tpu_torch.graph import parse_graph, wall_graph
from tneq_tpu_torch.model.qctn import params_from_numpy, params_to_numpy
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.parallel import (
    check_mesh_health,
    data_sharding,
    detect_multihost,
    initialize_multihost,
    is_main_process,
    make_dp_train_step,
    make_mesh,
    replicated,
    shard_batch,
)
from tneq_tpu_torch.parallel.mesh import Placement
from tneq_tpu_torch.train.trainer import Trainer, basis_states

torch.set_num_threads(1)

DP_STEPS = 2
_LAUNCHER_VARS = ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE")


# ---------------------------------------------------------------------------
# the mesh and placements
# ---------------------------------------------------------------------------

def test_mesh_defaults_to_the_card():
    """``make_mesh()`` takes every visible card and raises without one: the
    host runs only when asked for, as in every entry point."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == j_make_mesh().shape == {"data": 8}


def test_bad_mesh_sizes_raise_like_jax():
    with pytest.raises(ValueError, match="need 3 devices"):
        make_mesh({"data": 3}, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        j_make_mesh({"data": 3})


def test_placements_and_shard_batch():
    """``data_sharding`` splits the leading axis over ``data`` and
    ``replicated`` keeps it whole (JAX's ``P('data')`` / ``P()``); in one
    process every position is here, so a share is the whole batch."""
    mesh = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert data_sharding(mesh) == Placement(mesh, ("data",))
    assert data_sharding(mesh, "model").spec == ("model",) and replicated(mesh).spec == ()
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    xs = shard_batch(x, mesh)
    assert xs.device == torch.device("cpu") and torch.equal(xs, torch.as_tensor(x))
    assert data_sharding(mesh).local(xs) is xs and replicated(mesh).local(xs) is xs
    j_xs = j_shard_batch(jnp.asarray(x), j_make_mesh({"data": 4, "model": 2}))
    np.testing.assert_array_equal(np.asarray(j_xs), xs.numpy())
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(x[:6], mesh)
    with pytest.raises(ValueError, match="does not divide"):
        data_sharding(mesh).local(xs[:6])


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_inputs():
    jg = j_parse(j_wall(4, layers=2, dim=2))
    params = {k: np.asarray(v) for k, v in j_init(jg, jax.random.PRNGKey(1), jnp.complex64).items()}
    xs = np.random.default_rng(0).normal(size=(DP_STEPS, 16, jg.nqubits)).astype(np.float32)
    return jg, params, xs


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_dp_step_matches_jax_single_device(dp_inputs, retraction_prob):
    """``TestDataParallel.test_dp_step_matches_single_device``: the port's
    DP step on an 8-position data mesh against JAX's one-device
    ``Trainer.train_step`` (and JAX's own DP step), step by step."""
    jg, params, xs = dp_inputs
    jt = JTrainer(jg, optimizer=j_sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob))
    j_states = j_basis_states(jg)
    jp, jo = {k: jnp.asarray(v) for k, v in params.items()}, None
    jo = jt.optimizer.init(jp)
    jdp = j_dp_step(jt, j_make_mesh({"data": 8}))
    jp2, jo2 = dict(jp), jt.optimizer.init(jp)

    g = parse_graph(wall_graph(4, layers=2, dim=2))
    t = Trainer(g, optimizer=sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob),
                dtype=torch.complex64, device="cpu")
    step = make_dp_train_step(t, make_mesh({"data": 8}, devices=["cpu"] * 8))
    p = params_from_numpy(params, "cpu")
    o = t.optimizer.init(p)
    states = basis_states(g, dtype=torch.complex64, device="cpu")
    for x in xs:
        jp, jo, jloss = jt.train_step(jp, jo, j_states, jnp.asarray(x))
        jp2, jo2, jloss2 = jdp(jp2, jo2, j_states, jnp.asarray(x))
        p, o, loss = step(p, o, states, torch.as_tensor(x))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert float(loss) == pytest.approx(float(jloss2), rel=1e-5)
        got = params_to_numpy(p)
        for n in params:
            np.testing.assert_allclose(got[n], np.asarray(jp[n]), atol=5e-5)


def test_dp_step_refuses_a_sliced_trainer():
    g = parse_graph(wall_graph(4, layers=2, dim=2))
    mesh = make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)
    t = Trainer(g, device="cpu", mesh=mesh)
    assert t.strategy == "sliced_shard_map"
    with pytest.raises(ValueError, match="sliced"):
        make_dp_train_step(t, mesh)


# ---------------------------------------------------------------------------
# multi-process start-up
# ---------------------------------------------------------------------------

def test_detect_none_by_default(monkeypatch):
    from tneq_tpu.parallel.multihost import detect_multihost as j_detect

    for var in _LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert detect_multihost() is None and j_detect() is None


def test_detect_jax_vars(monkeypatch):
    from tneq_tpu.parallel.multihost import detect_multihost as j_detect

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    want = {"coordinator_address": "10.0.0.1:1234", "num_processes": 4, "process_id": 2}
    assert detect_multihost() == j_detect() == want


def test_detect_torchstyle_vars(monkeypatch):
    from tneq_tpu.parallel.multihost import detect_multihost as j_detect

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    d = detect_multihost()
    assert d == j_detect()
    assert d["coordinator_address"] == "node0:29500"
    assert d["num_processes"] == 2 and d["process_id"] == 1


def test_initialize_noop_single_process(monkeypatch):
    for var in _LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert is_main_process()


# ---------------------------------------------------------------------------
# the health check
# ---------------------------------------------------------------------------

def test_mesh_health_ok(capsys):
    """``TestHealth.test_mesh_health_ok`` on a one-process {"x": 4, "y": 2}
    mesh: JAX's report keys, every check ok, a time and the route."""
    from tneq_tpu.parallel import check_mesh_health as j_health

    report = check_mesh_health(make_mesh({"x": 4, "y": 2}, devices=["cpu"] * 8))
    j_report = j_health(j_make_mesh({"x": 4, "y": 2}), verbose=False)
    assert report["ok"] and j_report["ok"]
    assert set(report["axes"]) == set(j_report["axes"]) == {"x", "y"}
    for axis, rep in report["axes"].items():
        assert rep["size"] == j_report["axes"][axis]["size"]
        for prim in ("all_gather", "psum", "ppermute"):
            assert set(rep[prim]) == set(j_report["axes"][axis][prim]) | {"route"}
            assert rep[prim]["ok"] and rep[prim]["ms"] >= 0
            assert rep[prim]["route"] == "one process"
    assert "mesh axis 'x'" in capsys.readouterr().out
