"""Port parity: the siamese MPS sweep and the strategy compiler
(tneq_tpu_torch.ops.mps_sweep / compiler vs tneq_tpu.ops.mps_sweep /
compiler).

Cores, states and data are drawn in numpy and handed to both packages.  The
port's sweep, with the kernels (their plain versions on the CPU) and
without, is held against JAX's with ``use_pallas=False`` and with
``use_pallas=True, pallas_interpret=True``, on 2-, 3- and 6-qubit chains
(one core; no middle core; three middle steps), in float32 and complex64.
Values: rtol 2e-5; gradients of the NLL of |value|² (the Trainer's loss):
rtol 1e-4, atol 1e-4 * max|ref|; complex gradients against the conjugate
of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import mps_graph, parse_graph as j_parse, wall_graph
from tneq_tpu.ops.contract import abs_square as j_abs_square
from tneq_tpu.ops.features import measurement_matrices as j_mx
from tneq_tpu.ops.mps_sweep import mps_sweep_siamese_fn as j_sweep
from tneq_tpu.train.losses import nll_loss as j_nll
from tneq_tpu_torch.graph import parse_graph as t_parse
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import transfer_step as ts
from tneq_tpu_torch.ops.compiler import compile_siamese
from tneq_tpu_torch.ops.contract import abs_square
from tneq_tpu_torch.ops.features import measurement_matrices
from tneq_tpu_torch.ops.mps_sweep import is_mps_chain, mps_sweep_siamese_fn
from tneq_tpu_torch.train.losses import nll_loss

torch.set_num_threads(1)

RTOL_V, RTOL_G = 2e-5, 1e-4
NP_DT = {torch.float32: np.float32, torch.complex64: np.complex64}


def _problem(n, dtype, dim=2, B=6, seed=0):
    g = t_parse(mps_graph(n, dim=dim))
    p_np = params_to_numpy(init_params(g, seed, dtype, device="cpu"))
    rng = np.random.default_rng(seed)
    states = [rng.standard_normal(dim).astype(NP_DT[dtype]) for _ in range(n)]
    x = rng.standard_normal((B, n)).astype(np.float32)
    return g, p_np, states, x


def _j_value_and_grad(n, p_np, states, x, dtype, use_pallas):
    gj = j_parse(mps_graph(n, dim=states[0].shape[0]))
    jdt = jnp.complex64 if dtype.is_complex else jnp.float32
    mx = j_mx(jnp.asarray(x), states[0].shape[0]).astype(jdt)
    measures = [mx[:, q] for q in range(n)]
    fn = j_sweep(gj, use_pallas=use_pallas, pallas_interpret=True if use_pallas else None)
    js = [jnp.asarray(s) for s in states]

    def loss(p):
        return j_nll(j_abs_square(fn(p, js, measures)))

    with jax.default_matmul_precision("highest"):
        val = fn({k: jnp.asarray(v) for k, v in p_np.items()}, js, measures)
        grads = jax.grad(loss)({k: jnp.asarray(v) for k, v in p_np.items()})
    return np.asarray(val), {k: np.asarray(v) for k, v in grads.items()}


def _t_value_and_grad(g, p_np, states, x, dtype, use_kernel, remat=False):
    mx = measurement_matrices(torch.as_tensor(x), states[0].shape[0]).to(dtype)
    measures = [mx[:, q] for q in range(g.nqubits)]
    fn = mps_sweep_siamese_fn(g, use_kernel=use_kernel, remat=remat)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    ts_ = [torch.as_tensor(s) for s in states]
    val = fn(leaves, ts_, measures)
    nll_loss(abs_square(val)).backward()
    return val.detach().numpy(), {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("n", [2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sweep_matches_jax(n, dtype, use_pallas):
    g, p_np, states, x = _problem(n, dtype)
    jv, jg = _j_value_and_grad(n, p_np, states, x, dtype, use_pallas)
    for use_kernel in (True, False):
        tv, tg = _t_value_and_grad(g, p_np, states, x, dtype, use_kernel)
        np.testing.assert_allclose(tv, jv, rtol=RTOL_V, atol=RTOL_V * np.abs(jv).max())
        for k in jg:
            np.testing.assert_allclose(tg[k], np.conj(jg[k]), rtol=RTOL_G,
                                       atol=RTOL_G * np.abs(jg[k]).max())


def test_remat_gives_the_same_values_and_gradients():
    g, p_np, states, x = _problem(6, torch.complex64, dim=3, seed=3)
    v0, g0 = _t_value_and_grad(g, p_np, states, x, torch.complex64, True)
    v1, g1 = _t_value_and_grad(g, p_np, states, x, torch.complex64, True, remat=True)
    np.testing.assert_array_equal(v0, v1)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-7)


def test_sweep_steps_go_through_the_transfer_step():
    g, p_np, states, x = _problem(6, torch.float32)
    calls = []
    orig = ts._sweep

    def spy(env0, a, mx, complex_, backward):
        calls.append((a.shape[0], complex_, backward))
        return orig(env0, a, mx, complex_, backward)

    ts._sweep = spy
    try:
        _t_value_and_grad(g, p_np, states, x, torch.float32, True)
    finally:
        ts._sweep = orig
    # the three middle steps as one B3 sweep forward and one d_env sweep back
    assert calls == [(3, False, False), (3, False, True)]


def test_chain_checks():
    assert is_mps_chain(t_parse(mps_graph(5, dim=3)))
    assert not is_mps_chain(t_parse(wall_graph(4, layers=2, dim=2)))
    with pytest.raises(ValueError, match="not an MPS chain"):
        mps_sweep_siamese_fn(t_parse(wall_graph(4, layers=2, dim=2)))
    with pytest.raises(ValueError, match="conjugated bra"):
        mps_sweep_siamese_fn(t_parse(mps_graph(4, dim=2)), conj_right=False)
    # without the kernel the bra may be left unconjugated, as in JAX
    mps_sweep_siamese_fn(t_parse(mps_graph(4, dim=2)), conj_right=False, use_kernel=False)


def test_compile_siamese_dispatch():
    chain = t_parse(mps_graph(4, dim=2))
    wall = t_parse(wall_graph(4, layers=2, dim=2))
    assert compile_siamese(chain)[1] == "mps_sweep_cuda"
    assert compile_siamese(chain, use_kernel=False)[1] == "mps_sweep"
    assert compile_siamese(chain, mode="mps_sweep")[1] == "mps_sweep_cuda"
    for kw in ({"mode": "einsum"}, {"states_batched": True}, {"measure_extra_dims": 2}):
        with pytest.raises(NotImplementedError, match="item 7"):
            compile_siamese(chain, **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        compile_siamese(wall)
    with pytest.raises(NotImplementedError, match="item 11"):
        compile_siamese(chain, mode="sliced")
    with pytest.raises(ValueError, match="not an MPS chain"):
        compile_siamese(wall, mode="mps_sweep")
    with pytest.raises(ValueError, match="unknown mode"):
        compile_siamese(chain, mode="bogus")
