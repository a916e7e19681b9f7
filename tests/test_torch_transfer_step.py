"""Port parity: the transfer step B3/B4 (tneq_tpu_torch.ops.transfer_step vs
tneq_tpu.ops.pallas_kernels).

On the CPU the wrappers run the kernels' plain versions.  They are held
against ``jnp.einsum`` and against the Pallas kernels in interpret mode (as
``tests/test_pallas.py`` runs them), and their gradients against
``jax.grad`` of the JAX custom VJP; torch's complex gradient is the
conjugate of JAX's.  The complex backward, derived for torch, passes
``gradcheck`` in complex128.

f32 tolerances: values max|diff| <= 2e-5 * max|ref| (sums of at most
D^2 K^2 = 256 terms in another order); gradients rtol 1e-4, atol
1e-4 * max|ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.ops import pallas_kernels as jpk
from tneq_tpu_torch.ops import transfer_step as ts

torch.set_num_threads(1)

TOL_V = 2e-5
RTOL_G = 1e-4


def _inputs(B, Da, K, Dc, complex_, seed=0, dtype=None):
    rng = np.random.default_rng(seed)

    def mk(shape):
        x = rng.standard_normal(shape)
        if complex_:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype or (np.complex64 if complex_ else np.float32))

    return mk((B, Da, Da)), mk((Da, K, Dc)), mk((B, K, K))


def _close(got, ref, tol=TOL_V):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(float(np.abs(ref).max()), 1e-30)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("B,D,K", [(4, 2, 2), (130, 3, 2), (256, 4, 4)])
def test_real_step_matches_einsum_and_pallas(B, D, K):
    env, a, mx = _inputs(B, D, K, D, False)
    got = ts.transfer_step(*_t(env, a, mx))
    _close(got, jnp.einsum("zab,akc,zkl,bld->zcd", env, a, mx, a))
    _close(got, jpk.fused_transfer_step(jnp.asarray(env), jnp.asarray(a),
                                        jnp.asarray(mx), interpret=True))
    _close(ts.transfer_step_plain(*_t(env, a, mx)), got, tol=0.0)


@pytest.mark.parametrize("B,D,K", [(4, 2, 2), (130, 3, 2)])
def test_complex_step_matches_einsum_and_pallas(B, D, K):
    env, a, mx = _inputs(B, D, K, D, True)
    got = ts.transfer_step_complex(*_t(env, a, mx))
    assert got.dtype == torch.complex64
    _close(got, jnp.einsum("zab,akc,zkl,bld->zcd", env, a, mx, np.conj(a)))
    _close(got, jpk.fused_transfer_step_complex(
        jnp.asarray(env), jnp.asarray(a), jnp.asarray(mx), interpret=True))


def test_non_uniform_bonds():
    env, a, mx = _inputs(5, 3, 2, 4, True)
    got = ts.transfer_step_complex(*_t(env, a, mx))
    assert got.shape == (5, 4, 4)
    _close(got, np.einsum("zab,akc,zkl,bld->zcd", env, a, mx, np.conj(a)))


def _j_loss(fn, complex_):
    if complex_:
        return lambda *t: jnp.sum(jnp.abs(fn(*t)) ** 2)
    return lambda *t: jnp.sum(jnp.sin(fn(*t)))


def _t_loss(out, complex_):
    return (out.abs() ** 2).sum() if complex_ else torch.sin(out).sum()


@pytest.mark.parametrize("complex_", [False, True])
def test_value_and_gradients_match_jax_custom_vjp(complex_):
    env, a, mx = _inputs(16, 4, 3, 4, complex_, seed=1)
    jfn = jpk.transfer_step_complex if complex_ else jpk.transfer_step
    tfn = ts.transfer_step_complex if complex_ else ts.transfer_step
    with jax.default_matmul_precision("highest"):
        jv, jg = jax.value_and_grad(_j_loss(jfn, complex_), argnums=(0, 1, 2))(
            jnp.asarray(env), jnp.asarray(a), jnp.asarray(mx))
    leaves = [x.requires_grad_(True) for x in _t(env, a, mx)]
    tv = _t_loss(tfn(*leaves), complex_)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=TOL_V)
    for leaf, g in zip(leaves, jg):
        g = np.asarray(g)
        # torch's gradient of a real loss is the conjugate of jax.grad's
        np.testing.assert_allclose(leaf.grad.numpy(), np.conj(g), rtol=RTOL_G,
                                   atol=RTOL_G * float(np.abs(g).max()))


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("Dc", [3, 4])
def test_gradcheck_double(complex_, Dc):
    env, a, mx = _inputs(3, 3, 2, Dc, complex_, seed=2,
                         dtype=np.complex128 if complex_ else np.float64)
    leaves = tuple(x.requires_grad_(True) for x in _t(env, a, mx))
    fn = ts.transfer_step_complex if complex_ else ts.transfer_step
    assert torch.autograd.gradcheck(fn, leaves)


def test_cpu_runs_no_kernel():
    ts.reset_launch_counts()
    env, a, mx = _inputs(4, 2, 2, 2, False)
    leaves = [x.requires_grad_(True) for x in _t(env, a, mx)]
    ts.transfer_step(*leaves).sum().backward()
    assert ts.launch_counts() == {"transfer_step": 0, "transfer_step_complex": 0}


def test_other_devices_are_refused():
    x = torch.empty((2, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no transfer-step path"):
        ts.transfer_step(x, x, x)


def test_kernel_gates():
    assert ts.kernel_supported(torch.float32) and ts.kernel_supported(torch.complex64)
    assert not ts.kernel_supported(torch.float64)
    assert not ts.kernel_supported(torch.complex128)
    with pytest.raises(ValueError, match="float32 or complex64"):
        ts.kernel_plan(8, 2, 2, 2, torch.float64)
    # the slice width, one site: four batch entries per block (128 blocks),
    # all columns at once, 2x2 register tiles, no second stage
    assert ts.kernel_plan(512, 8, 4, 8, torch.float32)[:5] == (4, 8, 2, 1, 11552)
    # wide D on the narrow route: many entries share a block's copy of A, in
    # strips of columns
    zb, ct, tile, stages, smem = ts.kernel_plan(4096, 16, 4, 16, torch.complex64,
                                                route="narrow")[:5]
    assert zb == 16 and ct == 8 and tile == 4 and smem <= ts.SMEM_MAX
    # one entry's intermediates outgrow shared memory: strips of columns
    zb, ct, _, _, smem = ts.kernel_plan(8, 64, 8, 64, torch.float32, route="narrow")[:5]
    assert zb == 1 and 1 <= ct < 64 and smem <= ts.SMEM_MAX
    # the core does not fit next to one entry's intermediates: the wide
    # route, its strips of columns on the CTAs of a cluster
    plan = ts.kernel_plan(8, 64, 8, 64, torch.complex64)
    zb, ct, _, stages, smem = plan[:5]
    assert plan.route == "wide" and stages == 1 and 1 <= ct < 64 and smem <= ts.SMEM_MAX
    # one entry's two env buffers alone outgrow a block: the wide route splits
    # them over its cluster (fault C3); past bond 256 the plan refuses
    assert ts.kernel_plan(8, 128, 8, 128, torch.complex64, n=2).route == "wide"
    with pytest.raises(ValueError, match="does not fit"):
        ts.kernel_plan(8, 257, 8, 257, torch.complex64, n=2)
