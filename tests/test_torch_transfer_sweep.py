"""Port parity: the transfer sweep B3/B4 (tneq_tpu_torch.ops.transfer_step
``transfer_sweep``) against a loop of JAX's ``pallas_kernels.transfer_step``.

On the CPU the sweep runs its plain version.  Its value is held against a
loop of the Pallas kernels in interpret mode (as ``tests/test_pallas.py``
runs them) and against a loop of the port's plain step; the gradients of
env0, the core stack and the operator stack against ``jax.grad`` of the JAX
loop (torch's complex gradient is the conjugate of JAX's).  Inputs are
drawn in numpy with a seed and scaled so every env of the sweep stays of
order one.  Tolerance rtol 1e-5, atol 1e-6 times the reference's largest
element (f32 and c64: at most 5 sites of sums of D^2 K^2 <= 36 terms in
another order; a core's gradient also sums over the batch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops import pallas_kernels as jpk
from tneq_tpu.ops.contract import abs_square as j_abs_square
from tneq_tpu.ops.features import measurement_matrices as j_mx
from tneq_tpu.ops.mps_sweep import mps_sweep_siamese_fn as j_sweep
from tneq_tpu.train.losses import nll_loss as j_nll
from tneq_tpu_torch.graph import mps_graph, parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import transfer_step as ts
from tneq_tpu_torch.ops.contract import abs_square
from tneq_tpu_torch.ops.features import measurement_matrices
from tneq_tpu_torch.ops.mps_sweep import mps_sweep_siamese_fn
from tneq_tpu_torch.train.losses import nll_loss

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
STEP_SHAPES = ((130, 3, 2), (32, 3, 3), (512, 8, 4), (4096, 16, 4))  # chip_smoke.py's (B, D, K)


def _inputs(n, B, D, K, complex_, seed=0, dtype=None):
    """env0 [B,D,D], a [n,D,K,D], mx [n,B,K,K]; a is scaled by 1/(D K) so a
    step keeps env near its size."""
    rng = np.random.default_rng(seed)

    def mk(shape, scale=1.0):
        x = rng.standard_normal(shape)
        if complex_:
            x = x + 1j * rng.standard_normal(shape)
        return (scale * x).astype(dtype or (np.complex64 if complex_ else np.float32))

    return mk((B, D, D)), mk((n, D, K, D), 1.0 / (D * K)), mk((n, B, K, K))


def _j_loop(env, a, mx, complex_):
    fn = jpk.transfer_step_complex if complex_ else jpk.transfer_step
    for ai, mi in zip(a, mx):
        env = fn(env, ai, mi, interpret=True)
    return env


def _t_loss(out, complex_):
    return (out.abs() ** 2).sum() if complex_ else torch.sin(out).sum()


def _j_loss_cotangent(out, complex_):
    """JAX's cotangent of ``_t_loss`` at ``out``: 2 conj(out) for sum |out|^2,
    cos(out) for sum sin(out)."""
    return 2 * jnp.conj(out) if complex_ else jnp.cos(out)


def _close(got, ref):
    """rtol 1e-5 and atol 1e-6 of the reference's largest element (a
    gradient of a core sums over the batch)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("B,D,K", [(4, 2, 2), (130, 3, 2)])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_sweep_value_and_gradients_match_jax(n, B, D, K, complex_):
    env, a, mx = _inputs(n, B, D, K, complex_, seed=n + B)
    sweep = ts.transfer_sweep_complex if complex_ else ts.transfer_sweep
    step = ts.transfer_step_complex_plain if complex_ else ts.transfer_step_plain

    with jax.default_matmul_precision("highest"):
        jv, vjp = jax.vjp(lambda *t: _j_loop(*t, complex_),
                          *[jnp.asarray(x) for x in (env, a, mx)])
        jg = vjp(_j_loss_cotangent(jv, complex_))
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (env, a, mx)]
    out = sweep(*leaves)
    assert out.shape == (B, D, D) and out.dtype == leaves[0].dtype
    _close(out.detach(), jv)
    ref = torch.as_tensor(env)
    for i in range(n):
        ref = step(ref, torch.as_tensor(a[i]), torch.as_tensor(mx[i]))
    _close(out.detach(), ref)
    _t_loss(out, complex_).backward()
    for leaf, g in zip(leaves, jg):
        # torch's gradient of a real loss is the conjugate of jax.grad's
        _close(leaf.grad, np.conj(np.asarray(g)))


@pytest.mark.parametrize("complex_", [False, True])
def test_sweep_gradcheck_double(complex_):
    env, a, mx = _inputs(3, 3, 2, 2, complex_, seed=7,
                         dtype=np.complex128 if complex_ else np.float64)
    leaves = tuple(torch.as_tensor(x).requires_grad_(True) for x in (env, a, mx))
    fn = ts.transfer_sweep_complex if complex_ else ts.transfer_sweep
    assert torch.autograd.gradcheck(fn, leaves)


@pytest.mark.parametrize("complex_", [False, True])
def test_plain_backward_chain_is_the_d_env_of_each_site(complex_):
    """``transfer_sweep_plain(..., backward=True)[i]`` is the cotangent of
    site i's input env, the function the kernel's backward mode computes."""
    n, B, D, K = 3, 5, 3, 2
    env, a, mx = (torch.as_tensor(x) for x in _inputs(n, B, D, K, complex_, seed=3))
    g = torch.as_tensor(_inputs(1, B, D, K, complex_, seed=4)[0])
    plain = ts.transfer_sweep_complex_plain if complex_ else ts.transfer_sweep_plain
    chain = plain(g, a, mx, backward=True)
    assert chain.shape == (n, B, D, D)
    for i in range(n):
        e = env.clone().requires_grad_(True)
        out = plain(e, a[i:], mx[i:])[-1]
        # Re <g, out>: torch's gradient of it is the chain's cotangent
        (out * g.conj()).real.sum().backward()
        _close(chain[i], e.grad)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("B,Da,K,Dc", [(B, D, K, D) for B, D, K in STEP_SHAPES] + [(3, 40, 8, 40)])
def test_kernel_plan_fits(B, Da, K, Dc, n, complex_):
    """The narrow route's plan (forced at (3, 40, 8, 40), whose default is
    now the wide route)."""
    dtype = torch.complex64 if complex_ else torch.float32
    elem = 8 if complex_ else 4
    plan = ts.kernel_plan(B, Da, K, Dc, dtype, n, route="narrow")
    zb, ct, tile, stages, smem = plan[:5]
    assert plan == ts.kernel_plan(B, Da, K, Dc, dtype, n, route="narrow")  # shape and dtype alone
    assert plan.route == "narrow" and plan.cluster == 1
    assert smem <= ts.SMEM_MAX == 232448
    assert 1 <= zb <= ts.MAX_ZB and 1 <= ct <= Dc and tile in (1, 2, 4)
    assert 1 <= stages <= min(n, ts.MAX_STAGES)
    envs = 2 if n > 1 else 1
    entry = (Da * K * (ct | 1)) | 1  # T1/T2 rows and entries at odd pitches
    assert smem == elem * (stages * (Da * K * Dc + zb * K * K)
                           + zb * (envs * Da * Da + 2 * entry))
    if not complex_:
        assert -(-B // zb) <= ts.NUM_SMS  # one block per SM at most: one wave
    if Da == 16:
        assert zb > 1  # many entries share a block's copy of A at wide D
    if (B, Da, complex_) == (3, 40, True):
        assert ct < Dc  # one entry's T1/T2 outgrow shared memory: column strips
    expected = "wide" if Da >= ts.WIDE_D else "narrow"
    assert ts.kernel_plan(B, Da, K, Dc, dtype, n).route == expected


def test_kernel_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="square cores"):
        ts.kernel_plan(8, 3, 2, 4, torch.float32, n=2)
    # past the widest bond and physical rank the routes take
    with pytest.raises(ValueError, match="does not fit"):
        ts.kernel_plan(8, 257, 8, 257, torch.complex64, n=5)
    with pytest.raises(ValueError, match="does not fit"):
        ts.kernel_plan(8, 16, 65, 16, torch.float32, n=5)
    # a two-site sweep whose prefetch stage does not fit runs with one stage
    assert ts.kernel_plan(3, 40, 8, 40, torch.complex64, n=2, route="narrow").stages == 1
    # the born_rule sweep stages all five sites at the start
    assert ts.kernel_plan(512, 8, 4, 8, torch.float32, n=5).stages == 5
    assert ts.kernel_plan(512, 8, 4, 8, torch.float32, n=12).stages == ts.MAX_STAGES


def _wide_checks(plan, B, Da, K, Dc, dtype, n):
    """What ``csrc/transfer_step.cu``'s ``wide_ok`` checks, for both
    directions of the sweep."""
    cx = dtype.is_complex
    D = max(Da, Dc)
    zb, cs, tile, stages, smem = plan[:5]
    assert plan.route == "wide" and tile == 0 and stages == 1
    assert 1 <= zb <= ts.MAX_WIDE_ZB and cs % 8 == 0 and cs <= ts.MAX_STRIP
    assert 1 <= plan.cluster <= 16
    assert plan.cluster * cs >= D > (plan.cluster - 1) * cs
    assert plan.bc % 16 == 0 and 1 <= plan.kg <= K and plan.lc % 8 == 0
    assert plan.ka % 8 == 0 and plan.qt % 8 == 0 and plan.bc % plan.qt == 0
    assert 1 <= plan.lt <= plan.lc and (plan.lt == 1 or plan.qt == plan.bc)
    assert 3 <= plan.ring <= ts.MAX_RING and smem <= ts.SMEM_MAX
    for bwd in (False, True):
        lay = ts._wide_layout(n, Da, K, Dc, cx, bwd, zb, cs, plan.bc, plan.kg, plan.lc,
                              plan.ka, plan.qt, plan.lt, plan.ring)
        assert lay["N3"] <= ts.MAX_TILES3 * ts.WARPS  # the warps hold phase 3's outputs
        assert plan.ring - 2 <= lay["m_last"]  # the site's Mx is not overwritten early
        assert lay["smem"] <= smem
    ctas = plan.cluster * -(-B // zb)
    if B * plan.cluster >= ts.NUM_SMS:
        assert ctas >= ts.NUM_SMS  # the launch covers the card's SMs


# The wide route over a sampled grid: bonds up to 256 (edges, powers of two,
# odd widths) by physical ranks up to 64, three batches, both dtypes, n = 1
# and 5 -- 2 x 2 x 17 x 8 x 3 = 1632 plans in 68 cases.
_GRID_D = [32, 33, 40, 47, 64, 72, 96, 100, 120, 127, 128, 160, 192, 200, 224, 255, 256]
_GRID_K = [1, 2, 3, 4, 12, 16, 33, 64]


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("D", _GRID_D)
def test_wide_plans_fit_over_a_grid(D, n, complex_):
    dtype = torch.complex64 if complex_ else torch.float32
    for K in _GRID_K:
        for B in (1, 31, 512):
            plan = ts.kernel_plan(B, D, K, D, dtype, n)
            _wide_checks(plan, B, D, K, D, dtype, n)


# cores of 256 KiB and more: train_single_node --dim 32 (B = 32, D = K =
# 32, complex64), D = 64 K = 16 in float32, (8, 64, 8) in complex64, the
# widths of fault C3 and a ragged (31, 40, 12): the wide route, whose
# cluster holds the env and streams the core through shared memory; the
# name is that of the stages = 0 plans this route replaced
@pytest.mark.parametrize("B,D,K,complex_", [(32, 32, 32, True), (32, 64, 16, False),
                                            (8, 64, 8, True), (512, 64, 16, False),
                                            (32, 128, 4, True), (512, 192, 4, False),
                                            (31, 40, 12, True), (32, 32, 32, False)])
@pytest.mark.parametrize("n", [1, 5])
def test_kernel_plan_reads_wide_cores_from_global_memory(B, D, K, complex_, n):
    dtype = torch.complex64 if complex_ else torch.float32
    plan = ts.kernel_plan(B, D, K, D, dtype, n)
    _wide_checks(plan, B, D, K, D, dtype, n)
    assert plan == ts.kernel_plan(B, D, K, D, dtype, n, route="wide")
    # the strips of the cluster's CTAs cover the columns, eight at least each
    assert plan.ct * plan.cluster >= D and plan.ct >= 8


@pytest.mark.parametrize("B,D,K,dtype", [(32, 128, 4, torch.complex64),
                                         (512, 192, 4, torch.float32)])
def test_c3_born_rule_chains_beyond_one_block_plan(B, D, K, dtype):
    """Fault C3: one entry's double-buffered env outgrew one block's shared
    memory (complex64 from D = 120), so the card refused these sweeps."""
    plan = ts.kernel_plan(B, D, K, D, dtype, 6)
    assert plan.route == "wide" and plan.smem <= ts.SMEM_MAX
    envs = 2 * D * D * (8 if dtype.is_complex else 4)
    assert envs > ts.SMEM_MAX or dtype == torch.float32  # no block could hold it whole
    with pytest.raises(ValueError):
        ts.kernel_plan(B, D, K, D, dtype, 6, route="narrow")


def test_route_rule():
    """Narrow at the Born-rule widths, wide where the narrow kernel lost to
    one torch.einsum call (PERF.md, phase 5), both at the rule's edge."""
    for B, D, K in ((130, 3, 2), (32, 3, 3), (512, 8, 4)):
        for dtype in (torch.float32, torch.complex64):
            for n in (1, 5):
                assert ts.kernel_plan(B, D, K, D, dtype, n).route == "narrow"
    for B, D, K in ((32, 64, 16), (32, 32, 32)):
        for dtype in (torch.float32, torch.complex64):
            for n in (1, 5):
                assert ts.kernel_plan(B, D, K, D, dtype, n).route == "wide"
    assert ts.kernel_plan(8, 31, 4, 31, torch.float32, 2).route == "narrow"
    assert ts.kernel_plan(8, 32, 4, 32, torch.float32, 2).route == "wide"
    # a narrow-width core too large for one block takes the wide route
    assert ts.kernel_plan(8, 24, 64, 24, torch.complex64, 2).route == "wide"
    with pytest.raises(ValueError, match="route"):
        ts.kernel_plan(8, 8, 4, 8, torch.float32, 2, route="fast")


def test_narrow_step_shapes_keep_their_plans():
    """The three narrow STEP_SHAPES plan field for field as before the wide
    route was added."""
    f32, c64 = torch.float32, torch.complex64
    expected = {
        (130, 3, 2, f32, 1): (1, 3, 1, 1, 276), (130, 3, 2, f32, 5): (1, 3, 1, 5, 664),
        (130, 3, 2, c64, 1): (1, 3, 1, 1, 552), (130, 3, 2, c64, 5): (1, 3, 1, 5, 1328),
        (32, 3, 3, f32, 1): (1, 3, 1, 1, 396), (32, 3, 3, f32, 5): (1, 3, 1, 5, 1008),
        (32, 3, 3, c64, 1): (1, 3, 1, 1, 792), (32, 3, 3, c64, 5): (1, 3, 1, 5, 2016),
        (512, 8, 4, f32, 1): (4, 8, 2, 1, 11552), (512, 8, 4, f32, 5): (4, 8, 2, 5, 17696),
        (512, 8, 4, c64, 1): (4, 8, 2, 1, 23104), (512, 8, 4, c64, 5): (4, 8, 2, 5, 35392),
    }
    for (B, D, K, dtype, n), fields in expected.items():
        plan = ts.kernel_plan(B, D, K, D, dtype, n)
        assert plan.route == "narrow" and tuple(plan[:5]) == fields


def _chain(kind):
    """A 6-qubit chain whose middle cores differ in shape (bond 3 between
    cores b and c), or a uniform one for the remat sweep."""
    s = mps_graph(6, dim=2)
    if kind == "non_uniform":
        s = s.replace("-2-b-2-c-2-", "-2-b-3-c-2-")
    return s


@pytest.mark.parametrize("kind", ["non_uniform", "remat"])
def test_step_by_step_chains_match_jax(kind):
    text = _chain(kind)
    g = parse_graph(text)
    p_np = params_to_numpy(init_params(g, 1, torch.complex64, device="cpu"))
    rng = np.random.default_rng(1)
    states = [rng.standard_normal(2).astype(np.complex64) for _ in range(6)]
    x = rng.standard_normal((7, 6)).astype(np.float32)

    gj = j_parse(text)
    mxj = j_mx(jnp.asarray(x), 2).astype(jnp.complex64)
    jfn = j_sweep(gj)
    js = [jnp.asarray(s) for s in states]

    def jloss(p):
        return j_nll(j_abs_square(jfn(p, js, [mxj[:, q] for q in range(6)])))

    with jax.default_matmul_precision("highest"):
        jp = {k: jnp.asarray(v) for k, v in p_np.items()}
        jv = np.asarray(jfn(jp, js, [mxj[:, q] for q in range(6)]))
        jg = jax.grad(jloss)(jp)

    mx = measurement_matrices(torch.as_tensor(x), 2).to(torch.complex64)
    fn = mps_sweep_siamese_fn(g, remat=kind == "remat")
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    calls = []
    orig = ts._sweep

    def spy(env0, a, m, complex_, backward):
        calls.append(a.shape[0])
        return orig(env0, a, m, complex_, backward)

    ts._sweep = spy
    try:
        val = fn(leaves, [torch.as_tensor(s) for s in states], [mx[:, q] for q in range(6)])
        nll_loss(abs_square(val)).backward()
    finally:
        ts._sweep = orig
    assert calls and set(calls) == {1}  # one site per call
    np.testing.assert_allclose(val.detach().numpy(), jv, rtol=2e-5, atol=2e-5 * np.abs(jv).max())
    for k in jg:
        ref = np.conj(np.asarray(jg[k]))
        np.testing.assert_allclose(leaves[k].grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
