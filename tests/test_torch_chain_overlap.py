"""Port parity: the M-form chain overlap and the B1/B2 sweep
(tneq_tpu_torch.ops.chain_overlap vs tneq_tpu.ops.chain_overlap).

On the CPU the sweep's autograd Function runs the kernels' plain versions
(the dispatch picks them because the tensors lie on the CPU); they are held
against ``jax.vjp`` of the Pallas whole-sweep kernel ``_chain_sweep`` in
interpret mode, as ``tests/test_chain_overlap.py`` runs it.  f32 tolerances:
rtol 1e-5 on values, 2e-4 (atol 1e-6) on gradients — the two sides sum in
different orders.  The CUDA kernels themselves are held against the same
plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.ops import chain_overlap as jco
from tneq_tpu_torch.ops import chain_overlap as tco

torch.set_num_threads(1)

RTOL_V, RTOL_G, ATOL_G = 1e-5, 2e-4, 1e-6


def _cores(rng, bond, phys, n_mid, dtype=np.float32):
    def core(*shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        x = x.astype(dtype)
        return x / np.abs(x).max()

    mids = np.stack([core(bond, phys, phys, bond) for _ in range(n_mid)]) if n_mid else None
    return core(phys, phys, phys, bond), mids, core(bond, phys, phys, phys)


def _t(triple):
    return tuple(None if x is None else torch.as_tensor(x) for x in triple)


def _j(triple):
    return tuple(None if x is None else jnp.asarray(x) for x in triple)


def _sweep_inputs(n, S, seed):
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal(S).astype(np.float32)
    u0 /= np.abs(u0).max()
    M = (rng.standard_normal((n, S, S)) / np.sqrt(S)).astype(np.float32)
    w = rng.standard_normal(S).astype(np.float32)
    return u0, M, w


@pytest.mark.parametrize("bond,phys,n_mid,dtype", [
    (3, 2, 4, np.float32), (4, 2, 3, np.complex64), (2, 3, 0, np.float32),
])
def test_chain_pair_to_mv_parity(bond, phys, n_mid, dtype):
    rng = np.random.default_rng(1)
    a, b = _cores(rng, bond, phys, n_mid, dtype), _cores(rng, bond, phys, n_mid, dtype)
    got = tco.chain_pair_to_mv(_t(a), _t(b))
    ref = jco.chain_pair_to_mv(_j(a), _j(b))
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL_V, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_plain_mv_sweep_value_and_grad(dtype):
    rng = np.random.default_rng(2)
    a, b = _cores(rng, 3, 2, 5, dtype), _cores(rng, 3, 2, 5, dtype)
    v0, M, w = (np.array(x) for x in jco.chain_pair_to_mv(_j(a), _j(b)))
    ref, (g0, gM, gw) = jax.value_and_grad(jco.mv_chain_log_overlap, argnums=(0, 1, 2))(
        jnp.asarray(v0), jnp.asarray(M), jnp.asarray(w))
    tv = [torch.as_tensor(x).requires_grad_(True) for x in (v0, M, w)]
    got = tco.mv_chain_log_overlap(*tv)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL_V)
    # torch's gradient of a real loss is the conjugate of jax.grad's
    for t, r in zip(tv, (g0, gM, gw)):
        np.testing.assert_allclose(t.grad.numpy(), np.conj(np.asarray(r)),
                                   rtol=RTOL_G, atol=ATOL_G)


@pytest.mark.parametrize("n,S,seed", [(3, 256, 0), (2, 128, 1)])
def test_sweep_function_matches_pallas_vjp(n, S, seed):
    """B1/B2 (plain versions behind the autograd Function) against jax.vjp of
    the Pallas sweep in interpret mode: f, logsum, du0, dM, dw."""
    u0, M, w = _sweep_inputs(n, S, seed)
    pad = lambda v: jnp.zeros((8, S), jnp.float32).at[0].set(v)
    sweep = jco._chain_sweep(n, S, True)
    (f_j, ls_j), vjp = jax.vjp(sweep, pad(u0), jnp.asarray(M), pad(w))
    df = 0.75
    du0_j, dM_j, dw_j = vjp((jnp.float32(df), jnp.float32(0.0)))

    tu, tM, tw = (torch.as_tensor(x).requires_grad_(True) for x in (u0, M, w))
    f_t, ls_t = tco._ChainSweep.apply(tu, tM, tw)[:2]
    np.testing.assert_allclose(float(f_t.detach()), float(f_j), rtol=RTOL_V, atol=1e-6)
    np.testing.assert_allclose(float(ls_t), float(ls_j), rtol=RTOL_V)
    assert not ls_t.requires_grad  # the scales are constants
    du0_t, dM_t, dw_t = torch.autograd.grad(f_t, (tu, tM, tw), grad_outputs=torch.tensor(df))
    np.testing.assert_allclose(du0_t.numpy(), np.asarray(du0_j)[0], rtol=RTOL_G, atol=ATOL_G)
    np.testing.assert_allclose(dM_t.numpy(), np.asarray(dM_j), rtol=RTOL_G, atol=ATOL_G)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j)[0], rtol=RTOL_G, atol=ATOL_G)


@pytest.mark.parametrize("n,S", [(4, 256), (5, 16)])
def test_kernel_wrapper_matches_jax_overlap(n, S):
    """mv_chain_log_overlap_cuda (plain versions on the CPU) against the JAX
    Pallas wrapper (interpret) and the JAX scan: value and gradients."""
    u0, M, w = _sweep_inputs(n, S, 3)
    v0 = 3.0 * u0  # exercises the s0 pre-scale

    def j_loss(fn):
        return jax.value_and_grad(fn, argnums=(0, 1, 2))(
            jnp.asarray(v0), jnp.asarray(M), jnp.asarray(w))

    ref_v, ref_g = j_loss(jco.mv_chain_log_overlap)
    if S % 128 == 0:
        pl_v, pl_g = j_loss(lambda a, b, c: jco.mv_chain_log_overlap_pallas(
            a, b, c, interpret=True))
        np.testing.assert_allclose(float(pl_v), float(ref_v), rtol=RTOL_V)
    tv = [torch.as_tensor(x).requires_grad_(True) for x in (v0, M, w)]
    got = tco.mv_chain_log_overlap_cuda(*tv)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref_v), rtol=RTOL_V)
    for t, r in zip(tv, ref_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=RTOL_G, atol=ATOL_G)


def test_fused_overlap_matches_direct_scan_all_slots():
    """The self-overlap path (oo): both triple slots take cotangents."""
    from tneq_tpu_torch.train.network_fit import _chain_log_overlap

    rng = np.random.default_rng(4)
    a = _cores(rng, 4, 2, 4)
    ta = [torch.as_tensor(x).requires_grad_(True) for x in a]
    tb = [torch.as_tensor(x).requires_grad_(True) for x in a]
    got = tco.fused_chain_log_overlap(tuple(ta), tuple(ta))
    ref = _chain_log_overlap(tuple(tb), tuple(tb))
    np.testing.assert_allclose(float(got.detach()), float(ref.detach()), rtol=RTOL_V)
    got.backward()
    ref.backward()
    for x, y in zip(ta, tb):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=RTOL_G, atol=ATOL_G)


def test_sweep_function_gradcheck_float64():
    """The Function's backward (B2's plain version) is the exact VJP of its
    forward with the scales held constant: f64 gradcheck on f."""
    rng = np.random.default_rng(5)
    u0 = torch.tensor(rng.standard_normal(6), dtype=torch.float64, requires_grad=True)
    M = torch.tensor(rng.standard_normal((3, 6, 6)) / 3, dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.standard_normal(6), dtype=torch.float64, requires_grad=True)
    # the log-overlap value is invariant under the rescaling, so the
    # function checked is the full log-overlap
    fn = lambda a, b, c: tco.mv_chain_log_overlap_cuda(a, b, c)
    assert torch.autograd.gradcheck(fn, (u0, M, w), eps=1e-6, atol=1e-6)


def test_plain_versions_are_consistent():
    """_sweep_fwd_plain / _sweep_bwd_plain against the autograd sweep."""
    u0, M, w = (torch.as_tensor(x) for x in _sweep_inputs(4, 9, 6))
    ustack, scales, f, logsum, ulast = tco._sweep_fwd_plain(u0, M, w)
    v = u0
    for i in range(4):
        torch.testing.assert_close(ustack[i], v)
        raw = v @ M[i]
        torch.testing.assert_close(scales[i], raw.abs().max() + 1e-30)
        v = raw / scales[i]
    torch.testing.assert_close(ulast, v)
    torch.testing.assert_close(f, (v * w).sum())
    torch.testing.assert_close(logsum, torch.log(scales).sum())
    dM, du0 = tco._sweep_bwd_plain(w, M, ustack, scales)
    Mg = M.clone().requires_grad_(True)
    ug = u0.clone().requires_grad_(True)
    v = ug
    for i in range(4):
        v = (v @ Mg[i]) / scales[i]
    (v * w).sum().backward()
    torch.testing.assert_close(dM, Mg.grad)
    torch.testing.assert_close(du0, ug.grad)


class TestGate:
    def _triple(self, bond, n_mid=3, dtype=torch.float32, phys=2):
        rng = np.random.default_rng(0)
        return tuple(None if x is None else torch.as_tensor(x).to(dtype)
                     for x in _cores(rng, bond, phys, n_mid))

    def test_supported(self):
        assert tco.fused_chain_supported(self._triple(16))
        # no TPU tiling rule: S = 9 and S = 1024 are inside the gate
        assert tco.fused_chain_supported(self._triple(3))
        assert tco.fused_chain_supported(self._triple(32, n_mid=1, phys=1))

    @pytest.mark.parametrize("case", ["complex", "float64", "no_mids", "S_over_cap", "nonuniform"])
    def test_outside(self, case):
        if case == "complex":
            t = self._triple(4, dtype=torch.complex64)
        elif case == "float64":
            t = self._triple(4, dtype=torch.float64)
        elif case == "no_mids":
            t = self._triple(4, n_mid=0)
        elif case == "S_over_cap":
            t = self._triple(33, n_mid=1, phys=1)  # S = 1089 > 1024
        else:
            f, m, l = self._triple(4)
            t = (f, m, l[:3])
        assert not tco.fused_chain_supported(t)

    def test_cpu_dispatch_uses_plain_versions(self):
        tco.reset_launch_counts()
        u0, M, w = (torch.as_tensor(x) for x in _sweep_inputs(3, 16, 7))
        tco.mv_chain_log_overlap_cuda(u0, M, w)
        assert tco.launch_counts() == {"chain_sweep_fwd": 0, "chain_sweep_bwd": 0}
        with pytest.raises(ValueError, match="no chain-sweep path"):
            tco._ChainSweep.apply(u0.to("meta"), M.to("meta"), w.to("meta"))

    def test_wrapper_validates_before_launch(self):
        u0, M, w = (torch.as_tensor(x) for x in _sweep_inputs(3, 16, 8))
        with pytest.raises(ValueError, match="float32"):
            tco._sweep_fwd_cuda(u0.double(), M.double(), w.double())
        with pytest.raises(ValueError, match="shape"):
            tco._sweep_fwd_cuda(u0[:8], M, w)
        with pytest.raises(ValueError, match="contiguous"):
            tco._sweep_bwd_cuda(w, M.transpose(1, 2), torch.zeros(3, 16), torch.ones(3))
        with pytest.raises(ValueError, match="S <= 1024"):
            tco._sweep_fwd_cuda(torch.zeros(1025), torch.zeros(1, 1025, 1025), torch.zeros(1025))
