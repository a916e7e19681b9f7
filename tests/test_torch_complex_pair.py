"""Port parity: stacked-real complex pairs (tneq_tpu_torch.ops.complex_pair,
optim.pair_stiefel and the pair fits vs their tneq_tpu counterparts).

Inputs are drawn in numpy and handed to both packages.  A pair tensor is
``[2, *shape]`` float32 in both, and its gradient is the real pair
``(∂L/∂xr, ∂L/∂xi)`` in both, so pair values and pair gradients are
compared as they are (no conjugation).  Tolerances: rtol 1e-5 on
primitives; 1e-4 of the max-abs on contractions of a few complex products
(Karatsuba reorders the sums); log overlaps at rtol 1e-5 with atol 1e-5 (a
sum of O(1) log-scales); optimizer steps and fits at 1e-4 (float32
trajectories of a few Stiefel steps).  The retraction is a random draw from
streams that differ, so ``pair_sgdg`` is compared with it off and forced.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import build_brick_wall_incidence as j_brick
from tneq_tpu.graph import incidence_to_graph as j_inc
from tneq_tpu.graph import mps_graph as j_mps
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops import complex_pair as jcp
from tneq_tpu.optim import pair_stiefel as jps
from tneq_tpu.train.fit import make_masked_fidelity_fit as j_dense_fit
from tneq_tpu.train.network_fit import make_masked_network_fidelity_fit as j_net_fit
from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, mps_graph
from tneq_tpu_torch.graph import parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import complex_pair as tcp
from tneq_tpu_torch.ops.contract import contract_cores, make_core_only_fn, make_two_network_fn
from tneq_tpu_torch.optim import pair_stiefel as tps
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.train.fit import make_masked_fidelity_fit, pair_identity_cores
from tneq_tpu_torch.train.losses import fidelity
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit

torch.set_num_threads(1)


def _cx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair_np(z):
    return np.stack([z.real, z.imag]).astype(np.float32)


def _brick(nq, cells):
    return (parse_graph(incidence_to_graph(build_brick_wall_incidence(nq, cells))),
            j_parse(j_inc(j_brick(nq, cells))))


def _cores(g, seed):
    return params_to_numpy(init_params(g, seed, torch.complex64, device="cpu"))


def _tp(cores):
    return {k: torch.as_tensor(_pair_np(v)) for k, v in cores.items()}


def _jp(cores):
    return {k: jnp.asarray(_pair_np(v)) for k, v in cores.items()}


@pytest.fixture(scope="module")
def brick42():
    """The 4 x 2 wall in both packages, shared by the file's cases."""
    return _brick(4, 2)


@pytest.fixture(scope="module")
def sgdg_problem(brick42):
    """The pair_sgdg cases' cores, target and JAX loss program (one compile
    for both retraction settings)."""
    gt, gj = brick42
    cores, target = _cores(gt, 5), _cores(gt, 6)
    t_tgt = tcp.make_pair_core_only_fn(gt)(_tp(target))
    j_tgt, j_fn = jnp.asarray(t_tgt.numpy()), jcp.make_pair_core_only_fn(gj)
    j_loss = jax.jit(jax.value_and_grad(lambda p: 1.0 - jcp.pair_fidelity(j_fn(p), j_tgt)))
    return cores, target, t_tgt, j_loss


@pytest.fixture(scope="module")
def dense_fit_problem(brick42):
    """The dense pair fits' start cores (seed 3), target cores (seed 4) and
    the planted pair target (core 2 set to its identity)."""
    gt, _ = brick42
    cores, target = _cores(gt, 3), _cores(gt, 4)
    ids = pair_identity_cores(gt)
    eff = {n: ids[n] if i == 2 else _pair_np(target[n]) for i, n in enumerate(gt.core_names)}
    t_tgt = tcp.make_pair_core_only_fn(gt)({k: torch.as_tensor(v) for k, v in eff.items()})
    return cores, target, t_tgt


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_roundtrip():
    z = _cx(np.random.default_rng(0), (3, 4))
    p = tcp.to_pair(torch.as_tensor(z))
    assert p.dtype == torch.float32 and p.shape == (2, 3, 4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jcp.to_pair(jnp.asarray(z))))
    np.testing.assert_array_equal(tcp.from_pair(p).numpy(), z)
    assert tcp.to_pair(torch.as_tensor(z.astype(np.complex128))).dtype == torch.float64
    np.testing.assert_array_equal(tcp.pair_conj(p).numpy(), _pair_np(z.conj()))


@pytest.mark.parametrize("eq,sa,sb", [("ab,bc->ac", (3, 4), (4, 5)),
                                      ("abc,cbd->ad", (2, 3, 4), (4, 3, 2))])
def test_pair_einsum_matches_jax_and_complex(eq, sa, sb):
    rng = np.random.default_rng(1)
    a, b = _cx(rng, sa), _cx(rng, sb)
    got = tcp.pair_einsum(eq, torch.as_tensor(_pair_np(a)), torch.as_tensor(_pair_np(b)))
    want = jcp.pair_einsum(eq, jnp.asarray(_pair_np(a)), jnp.asarray(_pair_np(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcp.from_pair(got).numpy(), np.einsum(eq, a, b),
                               rtol=1e-5, atol=1e-5)


def test_pair_abs2():
    z = _cx(np.random.default_rng(2), (5,))
    got = tcp.pair_abs2(torch.as_tensor(_pair_np(z))).numpy()
    np.testing.assert_allclose(got, np.asarray(jcp.pair_abs2(jnp.asarray(_pair_np(z)))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, np.abs(z) ** 2, rtol=1e-5)


def test_pair_einsum_gradcheck_float64():
    """torch's gradient through the three real products is the exact
    derivative (float64 gradcheck on pair operands)."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((2, 3, 4)), dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rng.standard_normal((2, 4, 2)), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, y: tcp.pair_einsum("ab,bc->ac", x, y), (a, b))


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------

def test_core_only_matches_jax_and_complex(brick42):
    gt, gj = brick42
    cores = _cores(gt, 0)
    got = tcp.make_pair_core_only_fn(gt)(_tp(cores))
    _close(got.numpy(), np.asarray(jcp.make_pair_core_only_fn(gj)(_jp(cores))))
    want = contract_cores(gt, params_from_numpy(cores, "cpu"))
    _close(tcp.from_pair(got).numpy(), want.numpy())


def test_siamese_matches_jax():
    from tneq_tpu.ops.features import measurement_matrices

    gt, gj = parse_graph(mps_graph(4, dim=2)), j_parse(j_mps(4, dim=2))
    cores = _cores(gt, 1)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)
    mx = np.asarray(measurement_matrices(x, 2)).astype(np.complex64)
    measures = [_pair_np(mx[:, q]) for q in range(4)]
    states = [_pair_np(np.array([1.0, 0.0], np.complex64)) for _ in range(4)]
    got = tcp.make_pair_siamese_fn(gt)(_tp(cores), [torch.as_tensor(s) for s in states],
                                       [torch.as_tensor(m) for m in measures])
    want = jcp.make_pair_siamese_fn(gj)(_jp(cores), [jnp.asarray(s) for s in states],
                                        [jnp.asarray(m) for m in measures])
    _close(tcp.pair_abs2(got).numpy(), np.asarray(jcp.pair_abs2(want)))


def test_pair_fidelity_matches():
    rng = np.random.default_rng(4)
    o, t = _cx(rng, (2, 2, 2)), _cx(rng, (2, 2, 2))
    got = float(tcp.pair_fidelity(torch.as_tensor(_pair_np(o)), torch.as_tensor(_pair_np(t))))
    np.testing.assert_allclose(
        got, float(jcp.pair_fidelity(jnp.asarray(_pair_np(o)), jnp.asarray(_pair_np(t)))),
        rtol=1e-5)
    np.testing.assert_allclose(got, float(fidelity(torch.as_tensor(o), torch.as_tensor(t))),
                               rtol=1e-5)


def test_pair_log_overlap_matches_jax():
    """log|<A,B>| of a 4 x 3 wall in pair form (the pair executor with a
    rescale per step) against JAX's and the dense complex overlap; the
    signed form against JAX's mantissa and log-scale."""
    gt, gj = _brick(4, 3)
    p, t = _cores(gt, 2), _cores(gt, 3)
    got = float(tcp.make_pair_log_abs_overlap_fn(gt)(_tp(p), _tp(t)))
    want = float(jcp.make_pair_log_abs_overlap_fn(gj)(_jp(p), _jp(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dense = make_two_network_fn(gt, gt, conj_target=True)(params_from_numpy(p, "cpu"),
                                                          params_from_numpy(t, "cpu"))
    np.testing.assert_allclose(got, float(torch.log(torch.abs(dense))), rtol=1e-4, atol=1e-4)
    mt, lt = tcp.make_pair_log_abs_two_network_fn(gt, signed=True)(_tp(p), _tp(t))
    mj, lj = jcp.make_pair_log_abs_two_network_fn(gj, signed=True)(_jp(p), _jp(t))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-5)


def test_pair_trees_and_identities(brick42):
    gt, gj = brick42
    cores = _cores(gt, 5)
    pt = tcp.pair_tree(params_from_numpy(cores, "cpu"))
    for k, v in tcp.unpair_tree(pt).items():
        np.testing.assert_array_equal(v.numpy(), cores[k])
    from tneq_tpu.train.fit import pair_identity_cores as j_pair_ids

    want = j_pair_ids(gj)
    for k, v in pair_identity_cores(gt).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(want[k]))


# ---------------------------------------------------------------------------
# pair Stiefel SGD-G
# ---------------------------------------------------------------------------

def test_pair_qr_retraction_matches_jax():
    rng = np.random.default_rng(8)
    x = _pair_np(_cx(rng, (3, 7)))
    q = tps.pair_qr_retraction(torch.as_tensor(x))
    np.testing.assert_allclose(q.numpy(), np.asarray(jps.pair_qr_retraction(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    qqh = tps.pair_matmul(q, tps.pair_h(q))
    np.testing.assert_allclose(qqh[0].numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(qqh[1].numpy(), np.zeros((3, 3)), atol=1e-5)
    # a batch of two is the two retractions
    xb = torch.as_tensor(np.stack([x, 2.0 * x]))
    torch.testing.assert_close(tps.pair_qr_retraction(xb)[1], q, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_pair_sgdg_matches_jax(brick42, sgdg_problem, retraction_prob):
    """Five pair_sgdg steps on a 4 x 2 wall's dense fit loss, the same
    pair gradients fed to both optimizers each step."""
    gt, _ = brick42
    cores, _, t_tgt, j_loss = sgdg_problem
    t_fn = tcp.make_pair_core_only_fn(gt)
    kw = dict(momentum=0.9, stiefel=True, retraction_prob=retraction_prob, seed=7)
    opt_t, opt_j = tps.pair_sgdg(0.05, **kw), jps.pair_sgdg(0.05, **kw)
    pt, pj = _tp(cores), _jp(cores)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    j_update = jax.jit(opt_j.update)
    for _ in range(5):
        lj, gj_ = j_loss(pj)
        leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
        lt = 1.0 - tcp.pair_fidelity(t_fn(leaves), t_tgt)
        gt_ = dict(zip(leaves, torch.autograd.grad(lt, list(leaves.values()))))
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4, atol=1e-6)
        for k in gt_:  # the same real pair gradient in both packages
            _close(gt_[k].numpy(), np.asarray(gj_[k]))
        ut, st = opt_t.update(gt_, st, pt)
        uj, sj = j_update(gj_, sj, pj)
        pt = {k: pt[k] + ut[k] for k in pt}
        pj = {k: pj[k] + uj[k] for k in pj}
    for k in pt:
        _close(pt[k].numpy(), np.asarray(pj[k]))


def test_pair_sgdg_matches_complex_sgdg_in_the_port(brick42, sgdg_problem):
    """pair_sgdg on pairs takes the step the port's sgdg takes on complex
    cores (whose torch gradient is conjugated inside sgdg), for 5 steps."""
    gt, _ = brick42
    cores, target, _, _ = sgdg_problem
    c_fn = make_core_only_fn(gt)

    c_tgt = c_fn(params_from_numpy(target, "cpu"))
    p_fn, p_tgt = tcp.make_pair_core_only_fn(gt), tcp.to_pair(c_tgt)
    opt_c = t_sgdg(0.05, momentum=0.9, retraction_prob=0.0)
    opt_p = tps.pair_sgdg(0.05, momentum=0.9, retraction_prob=0.0)
    pc, pp = params_from_numpy(cores, "cpu"), _tp(cores)
    sc, sp = opt_c.init(pc), opt_p.init(pp)
    for _ in range(5):
        lc_leaves = {k: v.clone().requires_grad_(True) for k, v in pc.items()}
        lp_leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
        lc = 1.0 - fidelity(c_fn(lc_leaves), c_tgt)
        lp = 1.0 - tcp.pair_fidelity(p_fn(lp_leaves), p_tgt)
        gc = dict(zip(lc_leaves, torch.autograd.grad(lc, list(lc_leaves.values()))))
        gp = dict(zip(lp_leaves, torch.autograd.grad(lp, list(lp_leaves.values()))))
        np.testing.assert_allclose(float(lc.detach()), float(lp.detach()), rtol=1e-4, atol=1e-6)
        uc, sc = opt_c.update(gc, sc, pc)
        up, sp = opt_p.update(gp, sp, pp)
        pc = {k: pc[k] + uc[k] for k in pc}
        pp = {k: pp[k] + up[k] for k in pp}
    for k in pc:
        _close(pp[k].numpy(), _pair_np(pc[k].numpy()), rel=1e-3)


# ---------------------------------------------------------------------------
# the pair fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_pair_dense_fit_matches_jax(brick42, dense_fit_problem, retraction_prob):
    """The 4 x 2 dense fit in pair form, core 2 planted, 60 steps at lr 0.1:
    the same steps and 1 - F as JAX's pair fit."""
    gt, gj = brick42
    cores, _, t_tgt = dense_fit_problem
    kw = dict(momentum=0.9, retraction_prob=retraction_prob)
    ft = make_masked_fidelity_fit(gt, tps.pair_sgdg(0.1, **kw), 60, complex_as_real=True,
                                  device="cpu")
    fj = j_dense_fit(gj, jps.pair_sgdg(0.1, **kw), 60, complex_as_real=True)
    mask = np.ones(gt.ncores, np.float32)
    rt = ft(_tp(cores), torch.as_tensor(mask), t_tgt)
    rj = fj(_jp(cores), jnp.asarray(mask), jnp.asarray(t_tgt.numpy()))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=1e-4, atol=1e-5)
    for k in rt.params:
        _close(rt.params[k].numpy(), np.asarray(rj.params[k]), rel=1e-3)


def test_pair_network_fit_matches_jax(brick42):
    """The 4 x 2 wall in network mode and pair form (the pair executor's
    overlaps), warm from the target with core 4 masked: the same steps and
    1 - F as JAX's."""
    gt, gj = brick42
    t_np = _cores(gt, 11)
    mask = np.ones(gt.ncores, np.float32)
    tmask = mask.copy()
    tmask[4] = 0.0
    kw = dict(momentum=0.9, retraction_prob=0.0)
    ft = make_masked_network_fidelity_fit(gt, tps.pair_sgdg(1e-2, **kw), 20,
                                          complex_as_real=True, device="cpu")
    fj = j_net_fit(gj, jps.pair_sgdg(1e-2, **kw), 20, complex_as_real=True)
    rt = ft(_tp(t_np), torch.as_tensor(mask), _tp(t_np), torch.as_tensor(tmask))
    rj = fj(_jp(t_np), jnp.asarray(mask), _jp(t_np), jnp.asarray(tmask))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=1e-4, atol=1e-5)
    # identical networks: the first exit test stops the fit
    r0 = ft(_tp(t_np), torch.as_tensor(tmask), _tp(t_np), torch.as_tensor(tmask))
    assert r0.steps == 1 and float(r0.infidelity) < 1e-3


def test_pair_fit_matches_complex_fit_in_the_port(brick42, dense_fit_problem):
    """Within the port, the dense fit in pair form and in complex64 from
    the same cores: the same steps and 1 - F (JAX's
    ``test_pair_fit_matches_complex_fit``, retraction off)."""
    gt, _ = brick42
    cores, target, _ = dense_fit_problem
    c_tgt = contract_cores(gt, params_from_numpy(target, "cpu"))
    mask = torch.ones(gt.ncores)
    fc = make_masked_fidelity_fit(gt, t_sgdg(0.5, momentum=0.9, retraction_prob=0.0), 40,
                                  device="cpu")
    fp = make_masked_fidelity_fit(gt, tps.pair_sgdg(0.5, momentum=0.9, retraction_prob=0.0),
                                  40, complex_as_real=True, device="cpu")
    rc = fc(params_from_numpy(cores, "cpu"), mask, c_tgt)
    rp = fp(_tp(cores), mask, tcp.to_pair(c_tgt))
    assert rc.steps == rp.steps
    np.testing.assert_allclose(float(rc.infidelity), float(rp.infidelity), rtol=1e-3, atol=1e-5)
