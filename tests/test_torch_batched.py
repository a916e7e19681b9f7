"""Port parity: the batched prune (``fit.batched`` of the dense and network
fits, ``FitDrivers.batched``, ``symmetry_breaking_batched``) against
tneq_tpu, and the chain sweep's vmap rule.

Lanes are mask rows that all start from one set of numpy cores; both
packages run k-step chunks while any lane runs.  Per-lane metrics are held
at rtol 1e-4 with atol 1e-5 (ROADMAP §C: −log F near the exit is a
difference of O(1) log-overlaps), the step counts exactly.  The SGD-G
retraction is a random draw from streams that differ, so each fit is run
with it off and forced; the port's lanes share one draw per shape group
per step (``randomness="same"``), as JAX's lanes share one key.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

from tneq_tpu.apps import symmetry_breaking as js
from tneq_tpu.graph import build_brick_wall_incidence as j_brick
from tneq_tpu.graph import incidence_to_graph as j_inc
from tneq_tpu.graph import mps_graph as j_mps
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops.contract import contract_cores as j_contract
from tneq_tpu.optim.pair_stiefel import pair_sgdg as j_pair_sgdg
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.train.fit import identity_cores as j_identity
from tneq_tpu.train.fit import make_masked_fidelity_fit as j_dense_fit
from tneq_tpu.train.fit import transparent_cores as j_transparent
from tneq_tpu.train.network_fit import make_masked_network_fidelity_fit as j_net_fit
from tneq_tpu_torch.apps import symmetry_breaking as ts
from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, mps_graph
from tneq_tpu_torch.graph import parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import chain_overlap as tco
from tneq_tpu_torch.ops.pairwise import _vmap_dims
from tneq_tpu_torch.optim.pair_stiefel import pair_sgdg as t_pair_sgdg
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.train.fit import make_masked_fidelity_fit, transparent_cores
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit

torch.set_num_threads(1)

STEPS, K = 16, 8  # two chunks per batched fit
MASKS = [[], [2], [5]]  # lanes: full, core 2 pruned, core 5 pruned


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _brick(nq=4, cells=2):
    return (parse_graph(incidence_to_graph(build_brick_wall_incidence(nq, cells))),
            j_parse(j_inc(j_brick(nq, cells))))


def _cores(g, seed, dtype=torch.complex64):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _masks(n, rows=MASKS):
    m = np.ones((len(rows), n), np.float32)
    for i, r in enumerate(rows):
        m[i, r] = 0.0
    return m


def _dense_target(gj, cores, planted):
    idents = j_identity(gj, jnp.complex64)
    eff = {n: idents[n] if i in planted else jnp.asarray(cores[n])
           for i, n in enumerate(gj.core_names)}
    with jax.default_matmul_precision("highest"):
        return np.array(j_contract(gj, eff))


@pytest.fixture(scope="module")
def brick():
    """The 4 x 2 wall in both packages, its numpy cores by seed and its
    dense targets by (seed, planted cores), each built once for the file."""
    gt, gj = _brick()
    cores = {seed: _cores(gt, seed) for seed in (0, 1, 2)}
    targets = {(1, planted): _dense_target(gj, cores[1], list(planted))
               for planted in ((5,), ())}
    return gt, gj, cores, targets


@pytest.fixture(scope="module")
def mps_chain():
    """The 6-qubit float32 chain of the chain test in both packages, with
    its identities and numpy cores."""
    gt, gj = parse_graph(mps_graph(6, 4, phys=2)), j_parse(j_mps(6, 4, phys=2))
    idents_t, _ = transparent_cores(gt, torch.float32, pairing="kind")
    idents_j, _ = j_transparent(gj, jnp.float32, pairing="kind")
    return (gt, gj, idents_t, idents_j, _cores(gt, 2, torch.float32),
            _cores(gt, 1, torch.float32))


def _assert_lanes(rt, rj):
    assert rt.steps == int(rj.steps)
    got, want = rt.infidelity.numpy(), np.asarray(rj.infidelity)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for k in rt.params:
        assert rt.params[k].shape == rj.params[k].shape


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_dense_batched_matches_jax(brick, retraction_prob):
    gt, gj, cores, targets = brick
    start, target = cores[2], targets[1, (5,)]
    kw = dict(momentum=0.9, retraction_prob=retraction_prob)
    ft = make_masked_fidelity_fit(gt, t_sgdg(0.1, **kw), STEPS, device="cpu")
    fj = j_dense_fit(gj, j_sgdg(0.1, **kw), STEPS)
    masks = _masks(gt.ncores)
    rt = ft.batched(params_from_numpy(start, "cpu"), torch.as_tensor(masks),
                    torch.as_tensor(target), chunk_steps=K)
    rj = fj.batched(_jx(start), jnp.asarray(masks), jnp.asarray(target), chunk_steps=K)
    _assert_lanes(rt, rj)


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_network_batched_matches_jax(brick, retraction_prob):
    """The brick wall's network fit (row sweep) in lanes; the target is
    prepared once and shared."""
    gt, gj, cores, _ = brick
    start, t_np = cores[2], cores[1]
    tmask = np.ones(gt.ncores, np.float32)
    tmask[5] = 0.0
    kw = dict(momentum=0.9, retraction_prob=retraction_prob)
    ft = make_masked_network_fidelity_fit(gt, t_sgdg(0.1, **kw), STEPS, jit_scope="chunk",
                                          sync_every=K, device="cpu")
    fj = j_net_fit(gj, j_sgdg(0.1, **kw), STEPS, jit_scope="chunk", sync_every=K)
    masks = _masks(gt.ncores)
    rt = ft.batched(params_from_numpy(start, "cpu"), torch.as_tensor(masks),
                    params_from_numpy(t_np, "cpu"), torch.as_tensor(tmask))
    rj = fj.batched(_jx(start), jnp.asarray(masks), _jx(t_np), jnp.asarray(tmask))
    _assert_lanes(rt, rj)


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_mps_chain_batched_matches_jax(mps_chain, retraction_prob):
    """A 6-qubit float32 MPS chain: the port's lanes run the chain sweep
    (its plain version with a lane axis, through the vmap rule), JAX's
    the einsum scan."""
    gt, gj, idents_t, idents_j, start, t_np = mps_chain
    tmask = np.ones(gt.ncores, np.float32)
    tmask[3] = 0.0
    kw = dict(momentum=0.9, retraction_prob=retraction_prob)
    ft = make_masked_network_fidelity_fit(gt, t_sgdg(0.05, **kw), 16, dtype=torch.float32,
                                          identities=idents_t, device="cpu")
    fj = j_net_fit(gj, j_sgdg(0.05, **kw), 16, dtype=jnp.float32, identities=idents_j)
    masks = _masks(gt.ncores, [[], [2], [3]])
    rt = ft.batched(params_from_numpy(start, "cpu"), torch.as_tensor(masks),
                    params_from_numpy(t_np, "cpu"), torch.as_tensor(tmask), chunk_steps=K)
    rj = fj.batched(_jx(start), jnp.asarray(masks), _jx(t_np), jnp.asarray(tmask),
                    chunk_steps=K)
    _assert_lanes(rt, rj)


def test_batched_matches_sequential_host_fit(brick):
    """Identical mask rows reproduce the sequential fit lane for lane, the
    retraction on: the lanes take the sequential fit's draws (chunk_steps=1
    is per-step lockstep)."""
    gt, _, cores, targets = brick
    start, target = cores[0], targets[1, ()]
    fit = make_masked_fidelity_fit(gt, t_sgdg(0.1, momentum=0.9, retraction_prob=0.3), 40,
                                   tol=1e-8, jit_scope="step", device="cpu")
    mask = torch.ones(gt.ncores)
    ref = fit(params_from_numpy(start, "cpu"), mask, torch.as_tensor(target))
    res = fit.batched(params_from_numpy(start, "cpu"), torch.stack([mask, mask]),
                      torch.as_tensor(target), chunk_steps=1)
    assert res.steps == ref.steps == 40
    got = res.infidelity.numpy()
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6)
    np.testing.assert_allclose(got[0], float(ref.infidelity), rtol=1e-4, atol=1e-7)
    for k in ref.params:
        torch.testing.assert_close(res.params[k][1], ref.params[k], rtol=1e-4, atol=1e-5)
    # the generator is shared, not broadcast: the lanes drew what one fit draws
    assert res.opt_state.count == ref.opt_state.count == 40
    assert torch.equal(res.opt_state.generator.get_state(), ref.opt_state.generator.get_state())


def test_batched_max_steps_rounds_up_and_any_lane_keeps_running(brick):
    gt, _, cores, targets = brick
    start, target = cores[0], targets[1, ()]
    fit = make_masked_fidelity_fit(gt, t_sgdg(0.1, momentum=0.9, retraction_prob=0.0), 10,
                                   device="cpu")
    masks = torch.as_tensor(_masks(gt.ncores, [[], [1]]))
    res = fit.batched(params_from_numpy(start, "cpu"), masks, torch.as_tensor(target),
                      chunk_steps=4)
    assert res.steps == 12  # 10 rounds up to whole chunks of 4
    # a lane already at the target (its own params) does not stop the others
    tgt_cores = cores[1]
    t2 = torch.as_tensor(targets[1, ()])
    res = fit.batched(params_from_numpy(tgt_cores, "cpu"), masks, t2, chunk_steps=2)
    infid = res.infidelity.numpy()
    assert infid[0] < 1e-3 <= infid[1] and res.steps == 10


def test_pair_batched_matches_jax(brick):
    """One pair x batched case: the dense 4 x 2 fit in stacked-real form."""
    gt, gj, all_cores, targets = brick
    cores = all_cores[2]
    pair = lambda c: {k: np.stack([v.real, v.imag]).astype(np.float32) for k, v in c.items()}
    target = targets[1, (5,)]
    t_pair = np.stack([target.real, target.imag]).astype(np.float32)
    kw = dict(momentum=0.9, retraction_prob=0.0)
    ft = make_masked_fidelity_fit(gt, t_pair_sgdg(0.1, **kw), 16, complex_as_real=True,
                                  device="cpu")
    fj = j_dense_fit(gj, j_pair_sgdg(0.1, **kw), 16, complex_as_real=True)
    masks = _masks(gt.ncores, [[], [5]])
    rt = ft.batched(params_from_numpy(pair(cores), "cpu"), torch.as_tensor(masks),
                    torch.as_tensor(t_pair), chunk_steps=K)
    rj = fj.batched(_jx(pair(cores)), jnp.asarray(masks), jnp.asarray(t_pair), chunk_steps=K)
    _assert_lanes(rt, rj)


def _on_manifold(v):
    q, r = np.linalg.qr(v.reshape(4, 4))
    d = np.diag(r)
    return (q * (d / np.abs(d))[None, :]).reshape(v.shape).astype(np.complex64)


@pytest.mark.parametrize("mode", ["dense", "network"])
def test_symmetry_breaking_batched_matches_jax(mode):
    """The batched prune of the 4 x 2 wall, warm near the planted network
    (core 5 masked): the same pruned set and prune count as JAX's.  Six
    candidates in pieces of four, the second padded by repeating its last
    mask."""
    kw = dict(n_qubits=4, n_cells=2, rank=2, prune_steps=48, fit_sync_every=16,
              lane_chunk=4, fidelity_mode=mode)
    te = ts.make_experiment(ts.SymmetryBreakingConfig(device="cpu", **kw))
    je = js.make_experiment(js.SymmetryBreakingConfig(**kw))
    cores = _cores(te.graph, 3)
    rng = np.random.default_rng(0)
    warm = {k: _on_manifold(v + 0.02 * (rng.standard_normal(v.shape)
                                        + 1j * rng.standard_normal(v.shape)))
            for k, v in cores.items()}
    if mode == "dense":
        target = _dense_target(je.graph, cores, [5])
        tt, tj = torch.as_tensor(target), jnp.asarray(target)
    else:
        tmask = np.ones(6, np.float32)
        tmask[5] = 0.0
        tt = (params_from_numpy(cores, "cpu"), torch.as_tensor(tmask))
        tj = (_jx(cores), jnp.asarray(tmask))
    pj, cj = js.symmetry_breaking_batched(je, tj, jax.random.PRNGKey(0),
                                          warm_params=_jx(warm), verbose=False)
    pt, ct = ts.symmetry_breaking_batched(te, tt, warm_params=params_from_numpy(warm, "cpu"),
                                          verbose=False)
    assert pt == pj == [5]
    assert ct == cj


def test_sweep_vmap_rule_runs_the_lanes_as_one_sweep(monkeypatch):
    """Under vmap(grad) the chain sweep's Functions see the lanes as one
    lane axis (one plain call for all lanes on the CPU), and their values
    and gradients are those of each lane alone."""
    rng = np.random.default_rng(0)
    L, n, S = 3, 4, 9
    u0 = torch.as_tensor(rng.standard_normal((L, S)).astype(np.float32))
    M = torch.as_tensor((rng.standard_normal((L, n, S, S)) / 3).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal(S).astype(np.float32))  # shared: expanded
    calls = []
    fwd, bwd = tco._sweep_fwd_plain, tco._sweep_bwd_plain
    monkeypatch.setattr(tco, "_sweep_fwd_plain",
                        lambda *a: calls.append(("fwd", a[1].shape)) or fwd(*a))
    monkeypatch.setattr(tco, "_sweep_bwd_plain",
                        lambda *a: calls.append(("bwd", a[1].shape)) or bwd(*a))

    def loss(u, m):
        return tco.mv_chain_log_overlap_cuda(u, m, w)

    vals = vmap(loss)(u0, M)
    gu, gm = vmap(grad(loss, argnums=(0, 1)))(u0, M)
    assert calls == [("fwd", (L, n, S, S)), ("fwd", (L, n, S, S)), ("bwd", (L, n, S, S))]
    for i in range(L):
        ui, mi = u0[i].clone().requires_grad_(True), M[i].clone().requires_grad_(True)
        v = loss(ui, mi)
        v.backward()
        torch.testing.assert_close(vals[i], v.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gu[i], ui.grad, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gm[i], mi.grad, rtol=1e-5, atol=1e-6)


def test_vmap_dims_count_the_lane_axes():
    seen = []

    def f(x):
        seen.append(_vmap_dims(x))
        return (x * x).sum()

    x = torch.ones(2, 3, 4)
    f(x)
    vmap(grad(f))(x[0])
    vmap(vmap(f))(x)
    assert seen == [0, 1, 2]
