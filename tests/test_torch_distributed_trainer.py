"""Port parity: the distributed trainer (tneq_tpu_torch.parallel.trainer vs
tneq_tpu.parallel.trainer), in one process.

Mirrors ``tests/test_utils_distributed.py::TestDistributedTrainer`` and the
``DistributedConfig`` cases of ``::TestConfig``.  The parity cases hand
both trainers the same numpy cores and batches (JAX's ``init_params`` and
``prepare_data``); JAX runs on its virtual CPU devices, the port on host
positions.  Tolerances: losses at rtol 1e-5 against JAX, the sliced loss
at rtol 1e-4 of the unsliced (JAX's own bound).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.model.qctn import init_params as j_init
from tneq_tpu.parallel.trainer import DistributedConfig as JConfig
from tneq_tpu.parallel.trainer import DistributedTrainer as JTrainer
from tneq_tpu_torch.graph import mps_graph, wall_graph
from tneq_tpu_torch.model.qctn import params_from_numpy
from tneq_tpu_torch.parallel.trainer import DistributedConfig, DistributedTrainer, main

torch.set_num_threads(1)

PARITY_STEPS = 4


def test_config_from_dict_ignores_unknown():
    cfg = DistributedConfig.from_dict({"graph": "-2-A-2-", "max_steps": 5, "bogus_key": 1})
    assert cfg.max_steps == 5
    assert cfg.to_dict() == JConfig.from_dict(cfg.to_dict()).to_dict()


def test_config_from_json_file(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"graph": "-2-A-2-", "batch_size": 8}))
    assert DistributedConfig.from_file(str(p)).batch_size == 8


def test_trainer_defaults_to_the_card():
    """Without ``devices`` the trainer takes every visible card, and
    raises without one: the host runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedTrainer(DistributedConfig(graph=wall_graph(4, layers=2, dim=2)))


def test_train_dp_only():
    cfg = DistributedConfig(graph=wall_graph(4, layers=2, dim=2), model_axis=1, max_steps=10,
                            batch_size=16, log_every=0)
    trainer = DistributedTrainer(cfg, devices=["cpu"] * 2)
    assert dict(trainer.mesh.shape) == {"data": 2, "model": 1}
    _, stats = trainer.train()
    assert stats.steps == 10 and np.isfinite(stats.final_loss)


def test_train_with_model_axis_and_resume(tmp_path):
    cfg = DistributedConfig(graph=wall_graph(4, layers=2, dim=2), model_axis=2, max_steps=6,
                            batch_size=8, log_every=0, checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=3)
    trainer = DistributedTrainer(cfg, devices=["cpu"] * 2)
    assert trainer.strategy == "sliced_shard_map"
    _, stats = trainer.train()
    assert stats.steps == 6
    _, stats2 = DistributedTrainer(
        DistributedConfig(**{**cfg.to_dict(), "max_steps": 9, "resume": True}),
        devices=["cpu"] * 2).train()
    assert stats2.steps == 9
    assert len(stats2.losses) == 3  # only the resumed steps ran


def test_sliced_equals_unsliced_loss():
    base = dict(graph=wall_graph(4, layers=2, dim=2), max_steps=1, batch_size=8, log_every=0,
                seed=3)
    _, s1 = DistributedTrainer(DistributedConfig(model_axis=1, **base), devices=["cpu"]).train()
    _, s2 = DistributedTrainer(DistributedConfig(model_axis=2, **base),
                               devices=["cpu"] * 2).train()
    assert s1.final_loss == pytest.approx(s2.final_loss, rel=1e-4)


@pytest.mark.parametrize("model_axis", [1, 2])
def test_losses_match_jax(model_axis):
    """The same numpy cores and batches through both trainers: the port on
    ``model_axis`` host positions, JAX on as many virtual devices."""
    kw = dict(graph=wall_graph(4, layers=2, dim=2), model_axis=model_axis,
              max_steps=PARITY_STEPS, batch_size=8, log_every=0, seed=2)
    jt = JTrainer(JConfig(**kw), devices=jax.devices()[:model_axis])
    params = {k: np.asarray(v) for k, v in
              j_init(j_parse(kw["graph"]), jax.random.PRNGKey(2), jnp.complex64).items()}
    batches = [np.asarray(b) for b in jt.prepare_data()]
    _, j_stats = jt.train({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(b) for b in batches])
    t = DistributedTrainer(DistributedConfig(**kw), devices=["cpu"] * model_axis)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(t.prepare_data(), batches))
    _, stats = t.train(params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(stats.losses, j_stats.losses, rtol=1e-5)


def test_chain_config_takes_the_transfer_sweep():
    """An MPS config contracts through ``compile_siamese``'s sweep (the
    kernels' route, B3/B4; their plain versions on host tensors), where
    JAX's trainer runs ``make_siamese_fn``: the same function on chains
    (ROADMAP C).  The losses agree with JAX's at the same cores."""
    kw = dict(graph=mps_graph(5, dim=3), max_steps=3, batch_size=8, log_every=0)
    t = DistributedTrainer(DistributedConfig(**kw), devices=["cpu"])
    assert t.strategy == "mps_sweep_cuda"
    jt = JTrainer(JConfig(**kw), devices=jax.devices()[:1])
    params = {k: np.asarray(v) for k, v in
              j_init(j_parse(kw["graph"]), jax.random.PRNGKey(0), jnp.complex64).items()}
    _, j_stats = jt.train({k: jnp.asarray(v) for k, v in params.items()})
    _, stats = t.train(params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(stats.losses, j_stats.losses, rtol=1e-5)


def test_cli_on_the_host_with_resume(tmp_path, capsys):
    """``python -m tneq_tpu_torch.parallel.trainer`` at its defaults (6-qubit
    MPS, dim 2, complex64) on ``--device cpu``, then a model axis of 2 that
    checkpoints and resumes."""
    stats = main(["--device", "cpu", "--steps", "5"])
    assert stats.steps == 5 and np.isfinite(stats.final_loss)
    assert "done: 5 steps" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    main(["--device", "cpu", "--steps", "4", "--model-axis", "2", "--checkpoint-dir", ck])
    resumed = main(["--device", "cpu", "--steps", "6", "--model-axis", "2",
                    "--checkpoint-dir", ck, "--resume"])
    assert resumed.steps == 6 and len(resumed.losses) == 2
    assert "resumed from step 4" in capsys.readouterr().out
