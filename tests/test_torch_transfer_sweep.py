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
    dtype = torch.complex64 if complex_ else torch.float32
    elem = 8 if complex_ else 4
    zb, ct, tile, stages, smem = plan = ts.kernel_plan(B, Da, K, Dc, dtype, n)
    assert plan == ts.kernel_plan(B, Da, K, Dc, dtype, n)  # shape and dtype alone
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


def test_kernel_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="square cores"):
        ts.kernel_plan(8, 3, 2, 4, torch.float32, n=2)
    with pytest.raises(ValueError, match="does not fit"):
        ts.kernel_plan(8, 128, 8, 128, torch.complex64, n=5)
    # a two-site sweep whose prefetch stage does not fit runs with one stage
    assert ts.kernel_plan(3, 40, 8, 40, torch.complex64, n=2).stages == 1
    # the born_rule sweep stages all five sites at the start
    assert ts.kernel_plan(512, 8, 4, 8, torch.float32, n=5).stages == 5
    assert ts.kernel_plan(512, 8, 4, 8, torch.float32, n=12).stages == ts.MAX_STAGES


# cores of 256 KiB and more: train_single_node --dim 32 (B = 32, D = K =
# 32, complex64), D = 64 K = 16 in float32, and (8, 64, 8) in complex64
@pytest.mark.parametrize("B,D,K,complex_", [(32, 32, 32, True), (32, 64, 16, False),
                                            (8, 64, 8, True), (512, 64, 16, False)])
@pytest.mark.parametrize("n", [1, 5])
def test_kernel_plan_reads_wide_cores_from_global_memory(B, D, K, complex_, n):
    dtype = torch.complex64 if complex_ else torch.float32
    elem = 8 if complex_ else 4
    zb, ct, tile, stages, smem = ts.kernel_plan(B, D, K, D, dtype, n)
    assert elem * D * K * D >= 262144 > ts.SMEM_MAX  # one core alone outgrows a block
    assert stages == 0 and smem <= ts.SMEM_MAX
    envs = 2 if n > 1 else 1
    assert smem == elem * zb * (envs * D * D + 2 * ((D * K * (ct | 1)) | 1))
    assert 1 <= zb <= ts.MAX_ZB and 1 <= ct <= D and tile in (1, 2, 4)
    assert ct >= min(D, ts.MIN_STRIP) or zb == 1


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
