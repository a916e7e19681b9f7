"""Checkpoints: the port's safetensors reader and writer, ``QCTN.save_cores``
/ ``load_cores`` / ``from_pretrained``, ``CheckpointManager`` and
``train_single_node --save`` (tneq_tpu_torch vs tneq_tpu and the
``safetensors`` package).

Files cross both ways: the port reads what JAX and the ``safetensors``
package write, and they read what the port writes, in float32 and
complex64, with metadata.  Cores that cross are compared bit for bit.
"""

import io
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors import safe_open
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from tneq_tpu.model.qctn import QCTN as JQCTN
from tneq_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from tneq_tpu_torch.graph import mps_graph, parse_graph
from tneq_tpu_torch.model.qctn import QCTN, init_params, params_to_numpy
from tneq_tpu_torch.ops.contract import contract_cores
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig, basis_states
from tneq_tpu_torch.utils import CheckpointManager
from tneq_tpu_torch.utils._safetensors import load_file, save_file

torch.set_num_threads(1)

DTYPES = [(torch.float32, jnp.float32), (torch.complex64, jnp.complex64)]


def _model(src, dtype, seed=0):
    return QCTN(src, seed=seed, dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# the file format against the safetensors package
# ---------------------------------------------------------------------------

def test_format_crosses_the_safetensors_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.normal(size=(2, 3, 4)).astype(np.float32),
        "f64": rng.normal(size=(5,)),
        "f16": rng.normal(size=(3, 2)).astype(np.float16),
        "i64": np.arange(7, dtype=np.int64),
        "i32": np.arange(-3, 3, dtype=np.int32).reshape(2, 3),
        "u8": np.arange(9, dtype=np.uint8),
        "b": np.array([True, False, True]),
        "scalar": np.array(2.5, dtype=np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    meta = {"graph": "mps", "note": "x"}
    save_file(tensors, tmp_path / "ours.safetensors", metadata=meta)
    theirs = st_load(str(tmp_path / "ours.safetensors"))
    with safe_open(str(tmp_path / "ours.safetensors"), framework="numpy") as f:
        assert f.metadata() == meta
    st_save(tensors, str(tmp_path / "theirs.safetensors"), metadata=meta)
    ours, ours_meta = load_file(tmp_path / "theirs.safetensors")
    assert ours_meta == meta
    for got in (theirs, ours):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert np.array_equal(got[k], v)


def test_format_refuses_what_it_cannot_hold(tmp_path):
    with pytest.raises(TypeError, match="no safetensors code"):
        save_file({"c": np.ones(2, np.complex64)}, tmp_path / "c.safetensors")
    (tmp_path / "short").write_bytes(b"\x01\x00")
    with pytest.raises(ValueError, match="too short"):
        load_file(tmp_path / "short")
    save_file({"a": np.ones(4, np.float32)}, tmp_path / "a.safetensors")
    raw = bytearray((tmp_path / "a.safetensors").read_bytes())
    (tmp_path / "cut.safetensors").write_bytes(bytes(raw[:-4]))
    with pytest.raises(ValueError, match="data_offsets"):
        load_file(tmp_path / "cut.safetensors")


# ---------------------------------------------------------------------------
# QCTN core files (ports of tests/test_model.py) and their crossing
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_complex(tmp_path):
    q = _model(mps_graph(3, dim=2), torch.complex64)
    path = tmp_path / "cores.safetensors"
    q.save_cores(path, metadata={"graph_type": "mps"})
    q2 = _model(mps_graph(3, dim=2), torch.complex64, seed=99)
    meta = q2.load_cores(path)
    assert meta == {"graph_type": "mps"}
    for n in q.cores:
        assert torch.equal(q.params[n], q2.params[n])
        assert q2.params[n].dtype == torch.complex64 and q2.params[n].device == q2.device


def test_safetensors_reference_naming(tmp_path):
    """Complex cores as core_<name>_real / _imag, real cores as core_<name>."""
    q = _model("-2-A-2-\n-2-B-2-", torch.complex64)
    path = tmp_path / "c.safetensors"
    q.save_cores(path)
    with safe_open(str(path), framework="numpy") as f:
        assert set(f.keys()) == {"core_A_real", "core_A_imag", "core_B_real", "core_B_imag"}
    _model("-2-A-2-", torch.float32).save_cores(tmp_path / "r.safetensors")
    with safe_open(str(tmp_path / "r.safetensors"), framework="numpy") as f:
        assert set(f.keys()) == {"core_A"}


def test_from_pretrained(tmp_path):
    src = mps_graph(3, dim=2)
    q = _model(src, torch.complex64)
    path = tmp_path / "c.safetensors"
    q.save_cores(path)
    q2 = QCTN.from_pretrained(src, path, device="cpu")
    torch.testing.assert_close(contract_cores(q2.graph, q2.params),
                               contract_cores(q.graph, q.params), rtol=0, atol=1e-6)


def test_load_strict_missing_raises(tmp_path):
    path = tmp_path / "c.safetensors"
    _model("-2-A-2-", torch.complex64).save_cores(path)
    q2 = _model("-2-A-2-B-2-", torch.complex64)
    kept = q2.params["B"].clone()
    with pytest.raises(KeyError, match="'B'"):
        q2.load_cores(path, strict=True)
    q2.load_cores(path, strict=False)  # lenient keeps B's random init
    assert torch.equal(q2.params["B"], kept)


@pytest.mark.parametrize("t_dt,j_dt", DTYPES)
def test_core_files_cross_both_ways(tmp_path, t_dt, j_dt):
    """JAX's files load in the port and the port's load in JAX, with their
    metadata, bit for bit."""
    src = mps_graph(4, dim=3)
    ours = _model(src, t_dt, seed=1)
    ours.save_cores(tmp_path / "ours.safetensors", metadata={"graph": "mps", "k": 3})
    j = JQCTN(src, dtype=j_dt)
    assert j.load_cores(tmp_path / "ours.safetensors") == {"graph": "mps", "k": "3"}
    theirs = JQCTN(src, key=jax.random.PRNGKey(5), dtype=j_dt)
    theirs.save_cores(tmp_path / "theirs.safetensors", metadata={"graph": "jax"})
    q = _model(src, t_dt)
    assert q.load_cores(tmp_path / "theirs.safetensors") == {"graph": "jax"}
    for n in ours.cores:
        assert np.array_equal(np.asarray(j.params[n]), ours.params[n].numpy())
        assert np.array_equal(q.params[n].numpy(), np.asarray(theirs.params[n]))


# ---------------------------------------------------------------------------
# CheckpointManager (port of tests/test_utils_distributed.py::TestCheckpoint)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_with_opt_state(tmp_path):
    g = parse_graph(mps_graph(3, dim=2))
    params = init_params(g, 0, torch.complex64, device="cpu")
    opt = sgdg(0.1, momentum=0.9)
    state = opt.init(params)
    _, state = opt.update({k: torch.ones_like(v) for k, v in params.items()}, state, params)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr.save(7, params, state, extra={"note": "x"})
    assert mgr.latest_step() == 7
    step, loaded, loaded_state, extra = mgr.load(opt_state_template=opt.init(params))
    assert step == 7 and extra["note"] == "x"
    for n in params:
        assert np.array_equal(params[n].numpy(), loaded[n])
    assert loaded_state.count == state.count
    for k in state.momentum:
        assert torch.equal(loaded_state.momentum[k], state.momentum[k])
    # the retraction's generator resumes where it stood
    assert torch.equal(loaded_state.generator.get_state(), state.generator.get_state())
    assert float(torch.rand((), generator=loaded_state.generator)) \
        == float(torch.rand((), generator=state.generator))


def test_retention(tmp_path):
    mgr = CheckpointManager(tmp_path / "c", keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"a": torch.ones((2, 2))})
    assert mgr.all_steps() == [3, 4]


def test_load_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").load()


def test_opt_state_leaf_count_mismatch_raises(tmp_path):
    g = parse_graph(mps_graph(3, dim=2))
    params = init_params(g, 0, torch.float32, device="cpu")
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(1, params, sgdg(0.1, momentum=0.9).init(params))
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        mgr.load(opt_state_template={"a": torch.zeros(1)})


def test_manager_params_cross_both_ways(tmp_path):
    g = parse_graph(mps_graph(3, dim=2))
    params = params_to_numpy(init_params(g, 2, torch.complex64, device="cpu"))
    CheckpointManager(tmp_path / "ours").save(3, params)
    _, theirs, _, _ = JCheckpointManager(tmp_path / "ours").load()
    JCheckpointManager(tmp_path / "jax").save(4, {k: jnp.asarray(v) for k, v in params.items()})
    _, ours, _, _ = CheckpointManager(tmp_path / "jax").load()
    for k, v in params.items():
        assert np.array_equal(theirs[k], v) and np.array_equal(ours[k], v)


def test_trainer_resumes_where_it_stopped(tmp_path):
    """Save the Trainer's params and optimizer state after 3 of 6 steps,
    resume from the files: the losses continue as the uninterrupted run's
    (bit for bit on the host)."""
    g = parse_graph(mps_graph(4, dim=2))
    cfg = TrainingConfig(learning_rate=0.05, max_steps=6, log_every=0)
    trainer = Trainer(g, config=cfg, K=2, dtype=torch.complex64, device="cpu")
    states = basis_states(g, dtype=torch.complex64, device="cpu")
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32) for _ in range(6)]
    p = init_params(g, 0, torch.complex64, device="cpu")

    def run(p, o, batches):
        losses = []
        for x in batches:
            p, o, loss = trainer.train_step(p, o, states, x)
            losses.append(float(loss))
        return p, o, losses

    _, _, full = run(p, trainer.optimizer.init(p), xs)
    p3, o3, first = run(p, trainer.optimizer.init(p), xs[:3])
    mgr = CheckpointManager(tmp_path / "run")
    mgr.save(3, p3, o3)
    step, p_np, o_res, _ = mgr.load(opt_state_template=trainer.optimizer.init(p))
    p_res = {k: torch.as_tensor(v) for k, v in p_np.items()}
    _, _, rest = run(p_res, o_res, xs[3:])
    assert step == 3 and first + rest == full


# ---------------------------------------------------------------------------
# train_single_node --save (port of tests/test_apps.py's case)
# ---------------------------------------------------------------------------

def test_train_single_node_saves_the_trained_cores(tmp_path):
    from tneq_tpu_torch.apps.train_single_node import main

    path = tmp_path / "m.safetensors"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        stats = main(["--device", "cpu", "--num-qubits", "4", "--dim", "2", "--steps", "12",
                      "--batch-size", "8", "--graph-type", "mps", "--save", str(path)])
    assert stats.steps == 12 and path.exists()
    assert f"saved cores to {path}" in out.getvalue()
    # the trained cores, not the initial ones, with the graph in the metadata
    src = mps_graph(4, dim=2)
    init = _model(src, torch.complex64)
    loaded = _model(src, torch.complex64, seed=3)
    assert loaded.load_cores(path) == {"graph": "mps"}
    assert any(not torch.equal(loaded.params[n], init.params[n]) for n in init.cores)
    j = JQCTN.from_pretrained(src, path)
    for n in init.cores:
        assert np.array_equal(np.asarray(j.params[n]), loaded.params[n].numpy())
