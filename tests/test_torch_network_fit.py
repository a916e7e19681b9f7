"""Port parity: network log-fidelity and the masked network fit
(tneq_tpu_torch.train.network_fit vs tneq_tpu.train.network_fit).

Inputs are drawn in numpy and handed to both packages.  On MPS chains, in
float32 the port runs the M-form sweep (the kernels' plain versions on the
CPU) where JAX runs its default einsum scan; in complex64 both run the
direct scan.  Walls, trees, chains of uneven bond and the one-core chain
take the row sweep or the rescaled pairwise executor in both packages.
Tolerances: rtol 1e-5 on values (atol 1e-5 where a log-fidelity is a
difference of O(1) log-overlaps), 2e-4 (atol 1e-6) on chain gradients and
1e-4 of their max-abs on the others; complex gradients are compared with
the conjugate of JAX's (torch's convention).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import mps_graph, parse_graph as j_parse
from tneq_tpu.optim.factory import make_optimizer as j_make_optimizer
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.train.fit import transparent_cores as j_transparent
from tneq_tpu.train.network_fit import (
    make_masked_network_fidelity_fit as j_make_fit,
    network_log_fidelity as j_nlf,
)
from tneq_tpu_torch.graph import parse_graph as t_parse
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.optim.factory import make_optimizer as t_make_optimizer
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.ops import chain_overlap as tco
from tneq_tpu_torch.train.fit import transparent_cores as t_transparent
from tneq_tpu_torch.train.network_fit import (
    _chain_cores,
    _chain_log_overlap,
    _normalize,
    make_masked_network_fidelity_fit as t_make_fit,
    network_fidelity,
    network_log_fidelity as t_nlf,
)

torch.set_num_threads(1)

RTOL_V, RTOL_G, ATOL_G = 1e-5, 2e-4, 1e-6
J_DT = {torch.float32: jnp.float32, torch.complex64: jnp.complex64}


def _np_params(n, bond, phys, dtype, seed):
    g = t_parse(mps_graph(n, bond, phys=phys))
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("n,bond,phys,dtype", [
    (8, 4, 2, torch.float32),
    (6, 2, 2, torch.float32),
    (5, 3, 2, torch.float32),  # S = 9: the ragged sweep
    (3, 4, 2, torch.float32),  # two cores, no middles: the direct scan
    (8, 4, 2, torch.complex64),
    (6, 3, 2, torch.complex64),
])
def test_network_log_fidelity_value_and_grads(n, bond, phys, dtype):
    p_np = _np_params(n, bond, phys, dtype, 0)
    t_np = _np_params(n, bond, phys, dtype, 1)
    # a candidate near the target keeps the gradient informative
    p_np = {k: (t_np[k] + 0.3 * p_np[k]).astype(p_np[k].dtype) for k in p_np}
    gj = j_parse(mps_graph(n, bond, phys=phys))
    gt = t_parse(mps_graph(n, bond, phys=phys))
    ref, ref_g = jax.value_and_grad(lambda p: j_nlf(gj, p, _jx(t_np)))(_jx(p_np))
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    got = t_nlf(gt, leaves, params_from_numpy(t_np, "cpu"))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL_V, atol=1e-6)
    for k in leaves:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.conj(np.asarray(ref_g[k])),
                                   rtol=RTOL_G, atol=ATOL_G)
    fid = network_fidelity(gt, params_from_numpy(p_np, "cpu"), params_from_numpy(t_np, "cpu"))
    np.testing.assert_allclose(float(fid), float(np.exp(ref)), rtol=RTOL_V * 10)


def test_float32_chain_takes_the_sweep_path():
    gt = t_parse(mps_graph(6, 4, phys=2))
    p = params_from_numpy(_np_params(6, 4, 2, torch.float32, 0), "cpu")
    pc = _chain_cores(gt, _normalize(p))
    assert tco.fused_chain_supported(pc)
    pcx = _chain_cores(gt, _normalize({k: v.to(torch.complex64) for k, v in p.items()}))
    assert not tco.fused_chain_supported(pcx)


def test_direct_scan_gradcheck_complex128():
    rng = np.random.default_rng(3)

    def core(*shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.tensor(x / np.abs(x).max(), dtype=torch.complex128, requires_grad=True)

    a = (core(2, 2, 2, 2), core(3, 2, 2, 2, 2), core(2, 2, 2, 2))
    b = (core(2, 2, 2, 2), core(3, 2, 2, 2, 2), core(2, 2, 2, 2))
    fn = lambda *xs: _chain_log_overlap(xs[:3], xs[3:])
    assert torch.autograd.gradcheck(fn, a + b, eps=1e-6, atol=1e-6)


def test_non_chain_graphs_raise():
    """Non-chain graphs run now (held against JAX below), and so do the
    stacked-real pairs (7c, test_torch_complex_pair.py) and the mesh
    (11a, test_torch_parallel_mp.py); what raises is a mesh whose positions
    lie on two devices in one process (the rank form's)."""
    from tneq_tpu_torch.graph import wall_graph
    from tneq_tpu_torch.parallel import make_mesh

    g = t_parse(wall_graph(4, 2, 2))
    assert t_make_fit(g, t_sgdg(0.1), 5, device="cpu").scope == "fit"
    p = params_from_numpy(_graph_cores(g, torch.complex64, 0), "cpu")
    assert torch.isfinite(t_nlf(g, p, p)) and abs(float(t_nlf(g, p, p))) < 1e-5
    assert float(network_fidelity(g, p, p, target_norm=3.0)) == pytest.approx(1.0, abs=1e-5)
    for gr in (g, t_parse(mps_graph(4, 2))):
        with pytest.raises(ValueError, match="rank form"):
            t_make_fit(gr, t_sgdg(0.1), 5, mesh=make_mesh({"model": 2}, devices=["cpu", "meta"]),
                       device="cpu")
        mesh = make_mesh({"model": 2}, devices=["cpu"] * 2)
        assert t_make_fit(gr, t_sgdg(0.1), 5, mesh=mesh, device="cpu").scope == "fit"
        assert t_make_fit(gr, t_sgdg(0.1), 5, complex_as_real=True, device="cpu").scope == "fit"


# ---------------------------------------------------------------------------
# other graphs: the row sweep (walls) and the rescaled pairwise executor
# ---------------------------------------------------------------------------

def _graph_cores(g, dtype, seed):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


OTHER_GRAPHS = {
    # name: (DSL builder from a generator module, takes the row sweep)
    "brick5x3": (lambda m: m.incidence_to_graph(m.build_brick_wall_incidence(5, 3, 2)), True),
    "wall_col5": (lambda m: m.wall_graph_col(5, 3, 2), True),
    "tree5": (lambda m: m.tree_graph(5, 2), False),
    "chain_uneven": (lambda m: "-2-a-2-\n-2-a-3-b-2-\n-2-b-4-c-2-\n-2-c-2-", True),
    "mps2": (lambda m: m.mps_graph(2, 3, 2), False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("name", sorted(OTHER_GRAPHS))
def test_network_log_fidelity_on_other_graphs_matches_jax(name, dtype):
    import tneq_tpu.graph as jgen
    import tneq_tpu_torch.graph as tgen
    from tneq_tpu_torch.ops.contract import contract_cores
    from tneq_tpu_torch.ops.row_scan import supports_row_scan
    from tneq_tpu_torch.train.losses import fidelity

    build, rows = OTHER_GRAPHS[name]
    gt, gj = t_parse(build(tgen)), j_parse(build(jgen))
    assert supports_row_scan(gt) == rows
    t_np = _graph_cores(gt, dtype, 1)
    p_np = {k: (v + 0.3 * _graph_cores(gt, dtype, 0)[k]).astype(v.dtype) for k, v in t_np.items()}
    with jax.default_matmul_precision("highest"):
        ref, ref_g = jax.jit(jax.value_and_grad(lambda p: j_nlf(gj, p, _jx(t_np))))(_jx(p_np))
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    got = t_nlf(gt, leaves, params_from_numpy(t_np, "cpu"))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL_V, atol=1e-5)
    for k in leaves:
        want = np.conj(np.asarray(ref_g[k]))
        np.testing.assert_allclose(leaves[k].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # the fidelity of the dense tensors of the same cores
    with torch.no_grad():
        dense = fidelity(contract_cores(gt, params_from_numpy(p_np, "cpu")),
                         contract_cores(gt, params_from_numpy(t_np, "cpu")))
    np.testing.assert_allclose(float(np.exp(float(got.detach()))), float(dense), rtol=1e-5)


# ---------------------------------------------------------------------------
# masked chain fit: step count and final -log F against JAX
# ---------------------------------------------------------------------------

N, BOND, PHYS = 8, 4, 2


def _fit_problem(dtype, noise, planted, seed=0):
    t_np = _np_params(N, BOND, PHYS, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    p_np = {}
    for k, v in t_np.items():
        x = rng.standard_normal(v.shape)
        if dtype.is_complex:
            x = x + 1j * rng.standard_normal(v.shape)
        p_np[k] = (v + noise * x).astype(v.dtype)
    mask = np.ones(N - 1, np.float32)
    mask[planted] = 0.0
    return p_np, t_np, mask


def _run_both(dtype, make_j_opt, make_t_opt, scope, sync, max_steps, noise, cand_planted):
    p_np, t_np, t_mask = _fit_problem(dtype, noise, [3])
    c_mask = np.ones(N - 1, np.float32)
    c_mask[cand_planted] = 0.0
    gj = j_parse(mps_graph(N, BOND, phys=PHYS))
    gt = t_parse(mps_graph(N, BOND, phys=PHYS))
    idents_j, _ = j_transparent(gj, J_DT[dtype], pairing="kind")
    idents_t, _ = t_transparent(gt, dtype, pairing="kind")
    for k in idents_j:
        np.testing.assert_array_equal(idents_t[k], np.asarray(idents_j[k]))
    fj = j_make_fit(gj, make_j_opt(), max_steps, tol=1e-3, dtype=J_DT[dtype],
                    jit_scope=scope, sync_every=sync, identities=idents_j)
    ft = t_make_fit(gt, make_t_opt(), max_steps, tol=1e-3, dtype=dtype,
                    jit_scope=scope, sync_every=sync, identities=idents_t, device="cpu")
    rj = fj(_jx(p_np), jnp.asarray(c_mask), _jx(t_np), jnp.asarray(t_mask))
    rt = ft(params_from_numpy(p_np, "cpu"), torch.as_tensor(c_mask),
            params_from_numpy(t_np, "cpu"), torch.as_tensor(t_mask))
    return rj, rt


def _assert_neg_log_f(rt, rj):
    """Final -log F within 1e-4 relative.  It is a difference of O(1)
    log-overlaps, so f32 rounding leaves ~1e-6 absolute: atol 1e-5."""
    got, ref = (-np.log1p(-float(r.infidelity)) for r in (rt, rj))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scope,sync", [("fit", 1), ("step", 3), ("chunk", 4)])
def test_masked_fit_early_exit_parity(scope, sync):
    """The planted-core candidate converges inside the budget; the exit
    metric (7 % under the threshold at this seed) and the step count agree."""
    rj, rt = _run_both(
        torch.float32,
        lambda: j_make_optimizer("adam", lr=1e-2),
        lambda: t_make_optimizer("adam", lr=1e-2),
        scope, sync, max_steps=200, noise=0.05, cand_planted=[3],
    )
    assert int(rt.steps) == int(rj.steps) < 200
    _assert_neg_log_f(rt, rj)
    if scope == "chunk":
        assert int(rt.steps) % sync == 0  # max_steps and exits round to chunks


@pytest.mark.parametrize("scope,sync", [("fit", 1), ("step", 5), ("chunk", 4)])
def test_masked_fit_budget_parity(scope, sync):
    """A full candidate cannot reach the planted target: the budget ends the
    fit (a chunk rounds 10 up to 12); -log F after the same steps agrees."""
    rj, rt = _run_both(
        torch.float32,
        lambda: j_make_optimizer("adam", lr=1e-2),
        lambda: t_make_optimizer("adam", lr=1e-2),
        scope, sync, max_steps=10, noise=0.3, cand_planted=[],
    )
    assert int(rt.steps) == int(rj.steps) == (12 if scope == "chunk" else 10)
    _assert_neg_log_f(rt, rj)
    for k in rt.params:
        np.testing.assert_allclose(rt.params[k].numpy(), np.asarray(rj.params[k]),
                                   rtol=1e-4, atol=1e-5)


def test_masked_fit_complex_sgdg_parity():
    """complex64 + Stiefel SGD-G (no retraction draws): same trajectory."""
    rj, rt = _run_both(
        torch.complex64,
        lambda: j_sgdg(0.05, momentum=0.9, retraction_prob=0.0),
        lambda: t_sgdg(0.05, momentum=0.9, retraction_prob=0.0),
        "fit", 1, max_steps=8, noise=0.2, cand_planted=[3],
    )
    assert int(rt.steps) == int(rj.steps) == 8
    _assert_neg_log_f(rt, rj)
    for k in rt.params:
        np.testing.assert_allclose(rt.params[k].numpy(), np.asarray(rj.params[k]),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# masked brick-wall fit (row sweep): step count and final 1 - F against JAX
# ---------------------------------------------------------------------------


def _on_manifold(v):
    """The unitary nearest-by-QR to a 4 x 4 core (phase-fixed)."""
    q, r = np.linalg.qr(v.reshape(4, 4))
    d = np.diag(r)
    return (q * (d / np.abs(d))[None, :]).reshape(v.shape).astype(np.complex64)


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
@pytest.mark.parametrize("scope,sync", [("fit", 1), ("step", 3), ("chunk", 4)])
def test_masked_brick_fit_parity(scope, sync, retraction_prob):
    """4 x 2 brick wall, complex64, SGD-G lr 0.05, the planted core [5] in
    both masks, from an on-manifold start near the target: the fit exits
    5 % under the tolerance at step 50 (52 in chunks of 4) in both packages.
    ``retraction_prob=1`` forces the retraction every step."""
    import tneq_tpu.graph as jgen
    import tneq_tpu_torch.graph as tgen

    dsl = tgen.incidence_to_graph(tgen.build_brick_wall_incidence(4, 2, 2))
    assert dsl == jgen.incidence_to_graph(jgen.build_brick_wall_incidence(4, 2, 2))
    gt, gj = t_parse(dsl), j_parse(dsl)
    t_np = _graph_cores(gt, torch.complex64, 0)
    rng = np.random.default_rng(1)
    p_np = {k: _on_manifold(v + 0.1 * (rng.standard_normal(v.shape)
                                       + 1j * rng.standard_normal(v.shape)))
            for k, v in t_np.items()}
    mask = np.ones(6, np.float32)
    mask[5] = 0.0
    ft = t_make_fit(gt, t_sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob), 200,
                    tol=1e-3, dtype=torch.complex64, jit_scope=scope, sync_every=sync,
                    device="cpu")
    fj = j_make_fit(gj, j_sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob), 200,
                    tol=1e-3, dtype=jnp.complex64, jit_scope=scope, sync_every=sync)
    rt = ft(params_from_numpy(p_np, "cpu"), torch.as_tensor(mask),
            params_from_numpy(t_np, "cpu"), torch.as_tensor(mask))
    rj = fj(_jx(p_np), jnp.asarray(mask), _jx(t_np), jnp.asarray(mask))
    assert int(rt.steps) == int(rj.steps) == {"fit": 50, "step": 51, "chunk": 52}[scope]
    _assert_neg_log_f(rt, rj)
