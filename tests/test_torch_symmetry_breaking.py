"""Port parity: the symmetry-breaking experiment
(tneq_tpu_torch.apps.symmetry_breaking vs tneq_tpu.apps.symmetry_breaking),
MPS topology in network fidelity mode and the brick wall in both modes.

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


@pytest.fixture(scope="module")
def mps_pair():
    """The MPS experiments in both packages and the planted target ([2]),
    shared by the file's MPS cases."""
    je, te = _experiments()
    return je, te, _target(te, [2])


def _target(te, planted):
    t_np = params_to_numpy(init_params(te.graph, 3, torch.float32, device="cpu"))
    mask = np.ones(te.graph.ncores, np.float32)
    mask[planted] = 0.0
    return t_np, mask


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_experiment_structure_parity(mps_pair):
    je, te, _ = mps_pair
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


def test_validate_fit_parity(mps_pair):
    """The validation fit from the same numpy start: steps and 1 - F."""
    je, te, (t_np, mask) = mps_pair
    p_np = params_to_numpy(init_params(te.graph, 4, torch.float32, device="cpu"))
    rj = je.run_fit(je.validate_fit, _jx(p_np), je.mask_vector([]),
                    (_jx(t_np), jnp.asarray(mask)))
    rt = te.run_fit(te.validate_fit, params_from_numpy(p_np, "cpu"), te.mask_vector([]),
                    (params_from_numpy(t_np, "cpu"), torch.as_tensor(mask)))
    assert int(rt.steps) == int(rj.steps) == 30
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=1e-4, atol=1e-6)


def test_prune_loop_parity(mps_pair):
    je, te, (t_np, mask) = mps_pair
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


def test_target_tensor_init_network_mode(mps_pair):
    _, te, _ = mps_pair
    t_params, t_mask = ts.target_tensor_init(te, [2], 0)
    assert set(t_params) == set(te.graph.core_names)
    assert t_mask.tolist() == [1.0, 1.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("kw,exc", [
    ({"topology": "brick", "fidelity_mode": "network"}, None),  # ported: it builds
    ({"topology": "mps", "fidelity_mode": "dense"}, ValueError),
    ({"topology": "mps", "fidelity_mode": "network", "complex_as_real": True}, ValueError),
    ({"topology": "ring", "fidelity_mode": "network"}, ValueError),
    ({"topology": "brick", "fidelity_mode": "dense", "complex_as_real": True}, None),
    ({"topology": "brick", "fidelity_mode": "bogus"}, ValueError),
])
def test_unported_and_invalid_configs_raise(kw, exc):
    cfg = ts.SymmetryBreakingConfig(device="cpu", **kw)
    if exc is None:
        assert ts.make_experiment(cfg).validate_fit.scope == "fit"
        return
    with pytest.raises(exc):
        ts.make_experiment(cfg)


def test_cli_waits_for_the_brick_wall_slice():
    """The brick wall runs now, in both fidelity modes, batched, in pair
    form and bond-sliced over 2 positions of a model axis on --device
    (--slice-devices, with the unsliced CLI's result)."""
    cpu = ["--device", "cpu", "--n-qubits", "4", "--n-cells", "2"]
    net = cpu + ["--fidelity-mode", "network", "--restarts", "1", "--prune-steps", "5",
                 "--validate-steps", "100"]
    sliced = ts.main(net + ["--slice-devices", "2"])
    assert sliced["n_cores"] == 6 and sliced["pruned"] == []
    # --batched in pair form: a 20-step prune scores all 6 candidates in one
    # round of lanes (pieces of 4, the second padded) and prunes none
    res = ts.main(cpu + ["--restarts", "1", "--prune-steps", "20", "--dtype", "complex64-pair",
                         "--batched", "--lane-chunk", "4"])
    assert res["n_cores"] == 6 and res["pruned"] == [] and res["attempts"] == 6
    # network mode: its first target stalls near F = 0.45 and is drawn anew
    res = ts.main(net)
    assert res["n_cores"] == 6 and res["pruned"] == []
    assert (sliced["pruned"], sliced["attempts"]) == (res["pruned"], res["attempts"])
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


@pytest.fixture(scope="module")
def brick_pair():
    """The dense brick experiments from the seed-3 cores and JAX's planted
    target ([5]), shared by the target and the prune-loop cases."""
    cores = _brick_cores(3)
    je, te = _brick(cores)
    return je, te, cores, np.array(js.target_tensor_init(je, [5], jax.random.PRNGKey(0)))


def test_brick_target_tensor_init_matches_jax(brick_pair):
    je, te, _, jt = brick_pair
    tt = ts.target_tensor_init(te, [5], 0)
    assert tt.shape == jt.shape == (2,) * 8 and not tt.requires_grad
    assert np.abs(tt.numpy() - jt).max() <= 1e-5 * np.abs(jt).max()


def test_brick_prune_loop_parity(brick_pair):
    je, te, cores, target = brick_pair
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


# ---------------------------------------------------------------------------
# the brick wall, network fidelity (row sweep)
# ---------------------------------------------------------------------------

NET = dict(BRICK, fidelity_mode="network")


def _brick_net(cores_np, **kw):
    je = js.make_experiment(js.SymmetryBreakingConfig(**dict(NET, **kw)))
    te = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **dict(NET, **kw)))
    je.init_params = lambda key: _jx(cores_np)
    te.init_params = lambda gen: params_from_numpy(cores_np, "cpu")
    return je, te


def _brick_cores(seed):
    g = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **BRICK)).graph
    return params_to_numpy(init_params(g, seed, torch.complex64, device="cpu"))


def test_brick_network_validate_parity():
    """A cold validation fit at lr 1 against the planted target (core 5
    masked): both packages exit after 81 steps, 34 % under the tolerance."""
    t_np, p_np = _brick_cores(3), _brick_cores(4)
    je, te = _brick_net(p_np)
    mask = np.ones(6, np.float32)
    mask[5] = 0.0
    rj = je.run_fit(je.validate_fit, _jx(p_np), je.mask_vector([]), (_jx(t_np), jnp.asarray(mask)))
    # the validation entry point draws its fresh cores (p_np), runs the
    # validate fit once and returns the fitted cores
    ok, fid, steps, fitted = ts.validate_target_tensor(
        te, (params_from_numpy(t_np, "cpu"), torch.as_tensor(mask)), 0, return_params=True)
    assert steps == int(rj.steps) == 81
    np.testing.assert_allclose(1.0 - fid, float(rj.infidelity), rtol=1e-4, atol=1e-6)
    assert ok and set(fitted) == set(te.graph.core_names)


def test_brick_network_prune_loop_parity():
    """Warm-started on the manifold near the target, 30 steps per
    candidate: the same cores pruned after the same attempts as JAX."""
    cores = _brick_cores(3)
    je, te = _brick_net(cores, prune_steps=30)
    mask = np.ones(6, np.float32)
    mask[5] = 0.0
    rng = np.random.default_rng(0)
    warm = {k: _on_manifold(v + 0.02 * (rng.standard_normal(v.shape)
                                        + 1j * rng.standard_normal(v.shape)))
            for k, v in cores.items()}
    seed = 5
    pj, aj = js.symmetry_breaking(je, (_jx(cores), jnp.asarray(mask)), jax.random.PRNGKey(seed),
                                  verbose=False, warm_params=_jx(warm))
    pt, at = ts.symmetry_breaking(te, (params_from_numpy(cores, "cpu"), torch.as_tensor(mask)),
                                  seed, verbose=False, warm_params=params_from_numpy(warm, "cpu"))
    assert pt == pj == [5]
    assert at == aj == 11


@pytest.mark.slow
def test_reference_default_network_validation_stalls_as_in_jax():
    """The reference default (8 x 5, complex64, SGD-G lr 1, momentum 0.9)
    in network mode, from one numpy target (the planted mask of the
    reference CLI) and one numpy start, the retraction off in both
    packages.  The first 5 steps agree within 1e-4 relative; after that
    rounding differences grow about tenfold a step (each lr-1 update is a
    rotation of unit norm), and over 200 steps neither package moves
    -log F off the level of an unrelated pair (log 2^16 = 11.1): the
    validation fit does not converge in JAX either.  Run with ``-s`` to
    see both trajectories."""
    from tneq_tpu.optim.stiefel import sgdg as j_sgdg
    from tneq_tpu.train.network_fit import make_masked_network_fidelity_fit as j_make_fit
    from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
    from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit as t_make_fit

    planted = [2, 3, 5, 8, 9, 12, 13, 14, 15, 17, 18, 20, 21, 23, 25, 26, 29, 31, 32, 33]
    te = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", fidelity_mode="network"))
    je = js.make_experiment(js.SymmetryBreakingConfig(fidelity_mode="network"))
    cfg, g = te.cfg, te.graph
    t_np = params_to_numpy(init_params(g, 0, torch.complex64, device="cpu"))
    p_np = params_to_numpy(init_params(g, 2, torch.complex64, device="cpu"))
    tmask = np.ones(g.ncores, np.float32)
    tmask[planted] = 0.0
    steps, first = 200, 5

    ft = t_make_fit(g, t_sgdg(cfg.validate_lr, momentum=cfg.momentum, retraction_prob=0.0),
                    cfg.validate_steps, dtype=torch.complex64, device="cpu")
    t_eff, log_tt = ft.prepare(params_from_numpy(t_np, "cpu"), torch.as_tensor(tmask))
    p = params_from_numpy(p_np, "cpu")
    o, mask = ft.drivers.optimizer.init(p), te.mask_vector([])
    port = []
    for _ in range(steps):
        p, o, nlf = ft.drivers.step(p, o, mask, t_eff, log_tt)
        port.append(float(nlf))

    fj = j_make_fit(je.graph, j_sgdg(cfg.validate_lr, momentum=cfg.momentum, retraction_prob=0.0),
                    cfg.validate_steps, dtype=jnp.complex64, jit_scope="chunk", sync_every=1)
    jt_eff, jlog_tt = fj.prepare(_jx(t_np), jnp.asarray(tmask))
    jp = _jx(p_np)
    jo, jmask = fj.make_opt_state(jp), je.mask_vector([])
    ref = []
    for k in [1] * first + [5] * ((steps - first) // 5):
        jp, jo, nlf = fj.chunk(k)(jp, jo, jmask, jt_eff, jlog_tt)
        ref += [float("nan")] * (k - 1) + [float(nlf)]

    print("step  -log F port  -log F JAX")
    for i in list(range(first)) + list(range(19, steps, 20)):
        print(f"{i + 1:4d}  {port[i]:11.6f}  {ref[i]:10.6f}")
    np.testing.assert_allclose(port[:first], ref[:first], rtol=1e-4)
    late_port, late_ref = port[steps // 2:], [x for x in ref[steps // 2:] if x == x]
    assert min(late_port) > 5.0 and min(late_ref) > 5.0
