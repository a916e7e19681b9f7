"""Port parity: the symmetry-breaking experiment
(tneq_tpu_torch.apps.symmetry_breaking vs tneq_tpu.apps.symmetry_breaking),
MPS topology in network fidelity mode and the brick wall in dense mode.

Both packages get the same numpy target, the same warm-start weights and
the same shuffle seed (JAX derives its seed from ``key_data(key)[-1]``, so
``PRNGKey(s)`` hands it ``s``), and must prune the same cores after the
same number of attempts.  MPS: at this seed the accepted fit ends 4.5 %
under the tolerance and the rejected ones far above it.  Brick wall (4
qubits x 2 cells, SGD-G, its retraction a random draw in each package):
the warm cores sit on the manifold, so a retraction barely moves them; the
planted core refits in 44 of 80 steps and every rejected fit ends above
1 - F = 0.6, so f32 rounding cannot flip a decision.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.apps import symmetry_breaking as js
from tneq_tpu.train.fit import transparent_cores as j_transparent
from tneq_tpu_torch.apps import symmetry_breaking as ts
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy

torch.set_num_threads(1)

KW = dict(n_qubits=6, rank=2, topology="mps", bond_dim=4, fidelity_mode="network",
          optimizer="adam", validate_lr=3e-2, validate_steps=30, prune_lr=1e-2,
          prune_steps=150, max_outer_iterations=2, tol=1e-3)


def _experiments():
    je = js.make_experiment(js.SymmetryBreakingConfig(dtype=jnp.float32, **KW))
    te = ts.make_experiment(ts.SymmetryBreakingConfig(dtype=torch.float32, device="cpu", **KW))
    return je, te


def _target(te, planted):
    t_np = params_to_numpy(init_params(te.graph, 3, torch.float32, device="cpu"))
    mask = np.ones(te.graph.ncores, np.float32)
    mask[planted] = 0.0
    return t_np, mask


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_experiment_structure_parity():
    je, te = _experiments()
    assert te.graph == je.graph or te.graph.signature == je.graph.signature
    assert te.candidate_indices() == je.candidate_indices() == [1, 2, 3]
    assert te.unmaskable == je.unmaskable
    assert te.row_would_empty([0]) and not te.row_would_empty([2])
    np.testing.assert_array_equal(te.mask_vector([1, 3]).numpy(),
                                  np.asarray(je.mask_vector([1, 3])))
    j_idents, _ = j_transparent(je.graph, jnp.float32, pairing="kind")
    from tneq_tpu_torch.train.fit import transparent_cores

    t_idents, _ = transparent_cores(te.graph, torch.float32, pairing="kind")
    for k in j_idents:
        np.testing.assert_array_equal(t_idents[k], np.asarray(j_idents[k]))


def test_validate_fit_parity():
    """The validation fit from the same numpy start: steps and 1 - F."""
    je, te = _experiments()
    t_np, mask = _target(te, [2])
    p_np = params_to_numpy(init_params(te.graph, 4, torch.float32, device="cpu"))
    rj = je.run_fit(je.validate_fit, _jx(p_np), je.mask_vector([]),
                    (_jx(t_np), jnp.asarray(mask)))
    rt = te.run_fit(te.validate_fit, params_from_numpy(p_np, "cpu"), te.mask_vector([]),
                    (params_from_numpy(t_np, "cpu"), torch.as_tensor(mask)))
    assert int(rt.steps) == int(rj.steps) == 30
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=1e-4, atol=1e-6)


def test_prune_loop_parity():
    je, te = _experiments()
    t_np, mask = _target(te, [2])
    rng = np.random.default_rng(0)
    warm = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in t_np.items()}
    seed = 5
    pj, aj = js.symmetry_breaking(je, (_jx(t_np), jnp.asarray(mask)), jax.random.PRNGKey(seed),
                                  verbose=False, warm_params=_jx(warm))
    pt, at = ts.symmetry_breaking(te, (params_from_numpy(t_np, "cpu"), torch.as_tensor(mask)),
                                  seed, verbose=False, warm_params=params_from_numpy(warm, "cpu"))
    assert pt == pj == [2]
    assert at == aj == 5


def test_target_tensor_init_network_mode():
    _, te = _experiments()
    t_params, t_mask = ts.target_tensor_init(te, [2], 0)
    assert set(t_params) == set(te.graph.core_names)
    assert t_mask.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("kw,exc", [
    ({"topology": "brick", "fidelity_mode": "network"}, NotImplementedError),
    ({"topology": "mps", "fidelity_mode": "dense"}, ValueError),
    ({"topology": "mps", "fidelity_mode": "network", "complex_as_real": True}, ValueError),
    ({"topology": "ring", "fidelity_mode": "network"}, ValueError),
    ({"topology": "brick", "fidelity_mode": "dense", "complex_as_real": True},
     NotImplementedError),
    ({"topology": "brick", "fidelity_mode": "bogus"}, ValueError),
])
def test_unported_and_invalid_configs_raise(kw, exc):
    with pytest.raises(exc):
        ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **kw))


def test_cli_waits_for_the_brick_wall_slice():
    """The brick wall runs now; what still waits names its ROADMAP item."""
    cpu = ["--device", "cpu", "--n-qubits", "4", "--n-cells", "2"]
    for extra, item in ((["--batched"], "items 5/6"), (["--dtype", "complex64-pair"], "item 7c"),
                        (["--fidelity-mode", "network"], "item 7b"),
                        (["--fidelity-mode", "network", "--slice-devices", "2"], "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            ts.main(cpu + extra)
    with pytest.raises(SystemExit):  # as in JAX: slicing needs network mode
        ts.main(cpu + ["--slice-devices", "2"])


# ---------------------------------------------------------------------------
# the brick wall, dense fidelity
# ---------------------------------------------------------------------------

BRICK = dict(n_qubits=4, n_cells=2, rank=2, validate_steps=300, prune_steps=80,
             max_outer_iterations=2)


def _brick(cores_np):
    """Both experiments, each drawing ``cores_np`` as its fresh cores."""
    je = js.make_experiment(js.SymmetryBreakingConfig(**BRICK))
    te = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **BRICK))
    je.init_params = lambda key: _jx(cores_np)
    te.init_params = lambda gen: params_from_numpy(cores_np, "cpu")
    return je, te


def _on_manifold(v):
    """The unitary nearest-by-QR to a 4 x 4 core (phase-fixed)."""
    q, r = np.linalg.qr(v.reshape(4, 4))
    d = np.diag(r)
    return (q * (d / np.abs(d))[None, :]).reshape(v.shape).astype(np.complex64)


def test_brick_experiment_structure_parity():
    je = js.make_experiment(js.SymmetryBreakingConfig())
    te = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu"))
    assert te.cfg.n_cores == je.cfg.n_cores == 35 == te.graph.ncores
    assert te.graph.signature == je.graph.signature
    np.testing.assert_array_equal(te.incidence, je.incidence)
    assert te.candidate_indices() == je.candidate_indices() == list(range(35))
    rng = np.random.default_rng(0)
    for _ in range(20):
        masked = sorted(rng.choice(35, size=int(rng.integers(1, 30)), replace=False).tolist())
        assert te.row_would_empty(masked) == je.row_would_empty(masked)
    assert te.row_would_empty([0, 7, 14, 21, 28])  # every core on qubit 0
    assert te.validate_fit.scope == te.prune_fit.scope == "fit"


def test_brick_target_tensor_init_matches_jax():
    g = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **BRICK)).graph
    cores = params_to_numpy(init_params(g, 3, torch.complex64, device="cpu"))
    je, te = _brick(cores)
    tt = ts.target_tensor_init(te, [5], 0)
    jt = np.asarray(js.target_tensor_init(je, [5], jax.random.PRNGKey(0)))
    assert tt.shape == jt.shape == (2,) * 8 and not tt.requires_grad
    assert np.abs(tt.numpy() - jt).max() <= 1e-5 * np.abs(jt).max()


def test_brick_prune_loop_parity():
    g = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **BRICK)).graph
    cores = params_to_numpy(init_params(g, 3, torch.complex64, device="cpu"))
    je, te = _brick(cores)
    target = np.array(js.target_tensor_init(je, [5], jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    warm = {k: _on_manifold(v + 0.05 * (rng.standard_normal(v.shape)
                                        + 1j * rng.standard_normal(v.shape)))
            for k, v in cores.items()}
    seed = 5
    pj, aj = js.symmetry_breaking(je, jnp.asarray(target), jax.random.PRNGKey(seed),
                                  verbose=False, warm_params=_jx(warm))
    pt, at = ts.symmetry_breaking(te, torch.as_tensor(target), seed, verbose=False,
                                  warm_params=params_from_numpy(warm, "cpu"))
    assert pt == pj == [5]
    assert at == aj == 11


def test_brick_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "best.json"
    res = ts.main(["--device", "cpu", "--n-qubits", "4", "--n-cells", "2", "--restarts", "1",
                   "--prune-steps", "20", "--save", str(out)])
    text = capsys.readouterr().out
    assert "brick wall: 4 qubits x 2 cells (6 cores); target mask: [5]" in text
    assert "(ok)" in text and "=== restart 0 ===" in text
    assert res["n_cores"] == 6 and res["target_mask"] == [5]
    assert json.loads(out.read_text()) == res
    # the default target mask of other sizes is JAX's numpy draw
    rng = np.random.default_rng(0)
    assert res["target_mask"] == sorted(rng.choice(6, size=1, replace=False).tolist())
