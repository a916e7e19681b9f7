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
    # JAX's "einsum_xla": the pairwise einsum path (tests/test_torch_contract.py)
    for kw in ({"mode": "einsum"}, {"states_batched": True}, {"measure_extra_dims": 2}):
        assert compile_siamese(chain, **kw)[1] == "einsum_pairwise"
    assert compile_siamese(wall)[1] == "einsum_pairwise"
    with pytest.raises(NotImplementedError, match="item 11"):
        compile_siamese(chain, mode="sliced")
    with pytest.raises(ValueError, match="not an MPS chain"):
        compile_siamese(wall, mode="mps_sweep")
    with pytest.raises(ValueError, match="unknown mode"):
        compile_siamese(chain, mode="bogus")


# ---------------------------------------------------------------------------
# B3/B4 at every width, and the kernel-free sweep for float64 / complex128
# (ROADMAP C1): nothing is cast, nothing falls back
# ---------------------------------------------------------------------------

from tneq_tpu_torch.ops import mps_sweep as ms  # noqa: E402
from tneq_tpu_torch.train.trainer import Trainer  # noqa: E402


def _spy(monkeypatch):
    """Count the sweeps that take the kernel and the steps that take the
    einsum."""
    calls = {"kernel": 0, "einsum": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(ms, "_kernel_sweep", counted("kernel", ms._kernel_sweep))
    monkeypatch.setattr(ms, "_einsum_step", counted("einsum", ms._einsum_step))
    return calls


def _chain_value(g, p_np, states, x, dtype, remat=False, use_kernel=True, fn=None):
    mx = measurement_matrices(torch.as_tensor(x), g.output_ranks[0]).to(dtype)
    fn = fn or mps_sweep_siamese_fn(g, use_kernel=use_kernel, remat=remat)
    return fn(params_from_numpy(p_np, "cpu", dtype), [torch.as_tensor(s).to(dtype) for s in states],
              [mx[:, q] for q in range(g.nqubits)])


def _j_chain_value(g_src, p_np, states, x, K, jdt):
    mx = j_mx(jnp.asarray(x), K).astype(jdt)
    fn = j_sweep(j_parse(g_src))
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn({k: jnp.asarray(v).astype(jdt) for k, v in p_np.items()},
                             [jnp.asarray(s).astype(jdt) for s in states],
                             [mx[:, q] for q in range(mx.shape[1])]))


# (64, 16) float32 and (32, 32) complex64: one core needs 262144 bytes, more
# shared memory than a block of an H100 has (232448), so the kernel's plan
# reads the cores from global memory (stages = 0) instead of staging them.
# The strategy "mps_sweep" (use_kernel=False) takes the einsum step,
# "mps_sweep_cuda" the kernel's wrapper (its plain version on the CPU).
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("D,K,dtype", [(64, 16, torch.float32), (32, 32, torch.complex64)])
def test_wide_cores_take_the_einsum_step(monkeypatch, D, K, dtype, remat):
    plan = ts.kernel_plan(2, D, K, D, dtype, 2)
    assert plan.stages == 0 and plan.smem <= ts.SMEM_MAX
    assert ts.kernel_plan(2, 8, 4, 8, dtype, 2).stages == 2
    src = mps_graph(5, D, phys=K)
    g = t_parse(src)
    p_np = params_to_numpy(init_params(g, 0, dtype, device="cpu"))
    rng = np.random.default_rng(0)
    states = [rng.standard_normal(K).astype(NP_DT[dtype]) for _ in range(5)]
    x = rng.standard_normal((2, 5)).astype(np.float32)
    ref = _j_chain_value(src, p_np, states, x, K, jnp.complex64 if dtype.is_complex else jnp.float32)
    calls = _spy(monkeypatch)
    for use_kernel, expected in ((False, {"kernel": 0, "einsum": 2}),
                                 # one sweep of both middle sites, or one per site
                                 (True, {"kernel": 2 if remat else 1, "einsum": 0})):
        calls.update(kernel=0, einsum=0)
        val = _chain_value(g, p_np, states, x, dtype, remat=remat, use_kernel=use_kernel)
        assert calls == expected
        np.testing.assert_allclose(val.detach().numpy(), ref, rtol=RTOL_V,
                                   atol=RTOL_V * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_double_precision_chains_take_the_einsum_step(monkeypatch, dtype):
    n, dim = 6, 3
    g = t_parse(mps_graph(n, dim=dim))
    low = torch.complex64 if dtype.is_complex else torch.float32
    p_np = params_to_numpy(init_params(g, 0, low, device="cpu"))
    rng = np.random.default_rng(0)
    states = [rng.standard_normal(dim).astype(NP_DT[low]) for _ in range(n)]
    x = rng.standard_normal((4, n)).astype(np.float32)
    calls = _spy(monkeypatch)
    # the Trainer compiles the kernel-free sweep for a dtype the kernels do not take
    tr = Trainer(g, dtype=dtype, device="cpu")
    assert tr.strategy == "mps_sweep"
    val = _chain_value(g, p_np, states, x, dtype, fn=tr._siamese)
    assert val.dtype == dtype  # complex128 is never cast down
    assert calls == {"kernel": 0, "einsum": 3}
    # the same einsum steps as the plain path, and JAX's value to f32 rounding
    plain = _chain_value(g, p_np, states, x, dtype, use_kernel=False)
    torch.testing.assert_close(val, plain, rtol=0, atol=0)
    ref = _j_chain_value(mps_graph(n, dim=dim), p_np, states, x, dim,
                         jnp.complex64 if dtype.is_complex else jnp.float32)
    np.testing.assert_allclose(val.numpy(), ref, rtol=RTOL_V, atol=RTOL_V * np.abs(ref).max())
    # in float32 / complex64 the Trainer's chain takes the kernel, as one sweep
    tr = Trainer(g, dtype=low, device="cpu")
    assert tr.strategy == "mps_sweep_cuda"
    calls.update(kernel=0, einsum=0)
    _chain_value(g, p_np, states, x, low, fn=tr._siamese)
    assert calls == {"kernel": 1, "einsum": 0}
