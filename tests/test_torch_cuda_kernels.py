"""The sweep kernels B1/B2 and the transfer-sweep kernels B3/B4 on the card
against their plain versions; training with wide cores through B4 and the
pairwise einsum path on the card against the host.

These tests need a CUDA card and skip without one; they import no JAX, so
they run on the machine with the card with the repository's conftest left
out::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

f32 tolerance: max|kernel - plain| / max|plain| <= 5e-5 per output for
B1/B2 and 2e-5 per site for B3/B4 (the two sum in different orders;
measured near 1e-6 on an H100).
"""

import numpy as np
import pytest
import torch

from tneq_tpu_torch.ops import chain_overlap as co

pytestmark = pytest.mark.cuda

TOL = 5e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(n, S, seed, dev):
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal(S).astype(np.float32)
    M = (rng.standard_normal((n, S, S)) / np.sqrt(S)).astype(np.float32)
    w = rng.standard_normal(S).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (u0 / np.abs(u0).max(), M, w))


def _rel(k, p):
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)


def _poison(shape, dev):
    """Leave a NaN-filled float32 block of ``shape`` in the caching allocator,
    so the next ``torch.empty`` of that size shows any cell a kernel leaves
    unwritten."""
    junk = torch.full(shape, float("nan"), device=dev)
    del junk


# n = 1 and 2 leave the ring deeper than the chain; n = 29 wraps it.  S = 1
# and 9 run as one CTA, 130 as a ragged cluster, 256 and 576 as 16 CTAs with
# whole sites per tile, 1024 with row tiles.
@pytest.mark.parametrize("n", [1, 2, 29])
@pytest.mark.parametrize("S", [1, 9, 130, 256, 576, 1024])
def test_kernels_match_plain_versions(dev, n, S):
    u0, M, w = _inputs(n, S, S + n, dev)
    _poison((n, S), dev)
    kf, pf = co._sweep_fwd_cuda(u0, M, w), co._sweep_fwd_plain(u0, M, w)
    for name, k, p in zip(("ustack", "scales", "f", "logsum", "ulast"), kf, pf):
        assert _rel(k, p) <= TOL or float((k - p).abs().max()) <= 1e-6, name
    _poison((n, S, S), dev)
    kb = co._sweep_bwd_cuda(w, M, pf[0], pf[1])
    pb = co._sweep_bwd_plain(w, M, pf[0], pf[1])
    assert bool(torch.isfinite(kb[0]).all()), "B2 left a cell of dM unwritten"
    for name, k, p in zip(("dM", "du0"), kb, pb):
        assert _rel(k, p) <= TOL, name
    torch.cuda.synchronize()


@pytest.mark.parametrize("S", [9, 256, 1024])
def test_nan_in_M_reaches_the_scales(dev, S):
    n, site = 6, 2
    u0, M, w = _inputs(n, S, 3, dev)
    M[site, S // 2, S // 3] = float("nan")
    kf, pf = co._sweep_fwd_cuda(u0, M, w), co._sweep_fwd_plain(u0, M, w)
    torch.cuda.synchronize()
    assert bool(torch.isnan(pf[1][site:]).all())  # the plain version's rule
    assert bool(torch.isnan(kf[1][site:]).all())
    assert _rel(kf[1][:site], pf[1][:site]) <= TOL
    assert bool(torch.isnan(kf[3]))  # logsum


def test_autograd_on_the_card_matches_the_host(dev):
    u0, M, w = _inputs(5, 64, 0, dev)
    tc = [x.clone().requires_grad_(True) for x in (u0, M, w)]
    th = [x.cpu().clone().requires_grad_(True) for x in (u0, M, w)]
    co.reset_launch_counts()
    vc = co.mv_chain_log_overlap_cuda(*tc)
    vc.backward()
    assert co.launch_counts() == {"chain_sweep_fwd": 1, "chain_sweep_bwd": 1}
    vh = co.mv_chain_log_overlap_cuda(*th)
    vh.backward()
    np.testing.assert_allclose(float(vc.detach()), float(vh.detach()), rtol=1e-5)
    for a, b in zip(tc, th):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(), rtol=2e-4, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    u0, M, w = _inputs(3, 16, 1, dev)
    with pytest.raises(ValueError, match="float32"):
        co._sweep_fwd_cuda(u0.double(), M.double(), w.double())
    with pytest.raises(ValueError, match="is on"):
        co._sweep_fwd_cuda(u0.cpu(), M, w)
    with pytest.raises(ValueError, match="contiguous"):
        co._sweep_fwd_cuda(u0, M.transpose(1, 2), w)


# ---------------------------------------------------------------------------
# B3/B4: the transfer sweep (csrc/transfer_step.cu)
# ---------------------------------------------------------------------------

from tneq_tpu_torch.ops import transfer_step as ts  # noqa: E402

TOL_STEP = 2e-5  # max|kernel - plain| / max|plain| per site: the same f32 sums in another order

# (B, Da, K, Dc) of one step; a sweep of n > 1 sites needs square cores
_STEP_SHAPES = [
    (130, 3, 2, 3), (32, 3, 3, 3), (512, 8, 4, 8), (7, 3, 2, 5),
    (3, 40, 8, 40),  # complex64: one entry's T1/T2 outgrow shared memory, column strips
    # cores of 256 KiB and more, read from global memory (stages = 0):
    # complex64 and float32 at (32, 32, 32), float32 at (64, 16, 64), and
    # both at (64, 8, 64)
    (32, 32, 32, 32), (32, 64, 16, 64), (3, 64, 8, 64),
]
_SWEEP_CASES = [(n, *shape) for n in (1, 2, 5) for shape in _STEP_SHAPES
                if n == 1 or shape[1] == shape[3]]


def _sweep_inputs(n, B, Da, K, Dc, complex_, dev, seed=0):
    """env0 [B,Da,Da], a [n,Da,K,Dc] (scaled by 1/(Da K), so the envs of a
    sweep stay of order one), mx [n,B,K,K]."""
    rng = np.random.default_rng(seed)

    def mk(shape, scale=1.0):
        x = rng.standard_normal(shape)
        if complex_:
            x = x + 1j * rng.standard_normal(shape)
        x = (scale * x).astype(np.complex64 if complex_ else np.float32)
        return torch.as_tensor(x, device=dev)

    return mk((B, Da, Da)), mk((n, Da, K, Dc), 1.0 / (Da * K)), mk((n, B, K, K))


def _rel_sites(k, p):
    return max(_rel(ki, pi) for ki, pi in zip(k, p))


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n,B,Da,K,Dc", _SWEEP_CASES)
def test_transfer_kernels_match_plain_versions(dev, complex_, n, B, Da, K, Dc):
    env, a, mx = _sweep_inputs(n, B, Da, K, Dc, complex_, dev)
    plain = ts.transfer_sweep_complex_plain if complex_ else ts.transfer_sweep_plain
    words = 2 if complex_ else 1  # float32 words per element
    _poison((n, B, Dc, Dc, words), dev)
    kf = ts._launch(env, a, mx, complex_)
    assert bool(torch.isfinite(kf).all()), "the sweep left a cell of out unwritten"
    assert _rel_sites(kf, plain(env, a, mx)) <= TOL_STEP
    # the backward's d_env chain: the same kernel, sites reversed, cores transposed
    g = _sweep_inputs(1, B, Dc, K, Dc, complex_, dev, seed=1)[0]
    _poison((n, B, Da, Da, words), dev)
    kb = ts._launch(g, a, mx, complex_, backward=True)
    assert bool(torch.isfinite(kb).all()), "the d_env sweep left a cell unwritten"
    assert _rel_sites(kb, plain(g, a, mx, backward=True)) <= TOL_STEP
    torch.cuda.synchronize()


@pytest.mark.parametrize("complex_", [False, True])
def test_nan_in_mx_reaches_the_envs_after_it(dev, complex_):
    n, B, D, K, site, z = 5, 512, 8, 4, 2, 77
    env, a, mx = _sweep_inputs(n, B, D, K, D, complex_, dev)
    mx[site, z, 1, 2] = float("nan")
    kf = ts._launch(env, a, mx, complex_)
    kb = ts._launch(env, a, mx, complex_, backward=True)
    torch.cuda.synchronize()
    assert bool(torch.isnan(kf[site:, z]).all()) and bool(torch.isfinite(kf[:site]).all())
    assert bool(torch.isnan(kb[:site + 1, z]).all()) and bool(torch.isfinite(kb[site + 1:]).all())
    others = torch.ones(B, dtype=torch.bool, device=dev)
    others[z] = False
    plain = ts.transfer_sweep_complex_plain if complex_ else ts.transfer_sweep_plain
    assert _rel_sites(kf[:, others], plain(env, a, mx)[:, others]) <= TOL_STEP


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n", [1, 5])
def test_transfer_autograd_on_the_card_matches_the_host(dev, complex_, n):
    env, a, mx = _sweep_inputs(n, 64, 8, 4, 8, complex_, dev)
    if n == 1:  # the one-site sweep behind transfer_step
        a, mx = a[0], mx[0]
        fn = ts.transfer_step_complex if complex_ else ts.transfer_step
    else:
        fn = ts.transfer_sweep_complex if complex_ else ts.transfer_sweep
    name = "transfer_step_complex" if complex_ else "transfer_step"
    results = []
    for where in ("cuda", "cpu"):
        leaves = [x.to(where).clone().requires_grad_(True) for x in (env, a, mx)]
        ts.reset_launch_counts()
        out = fn(*leaves)
        (out.abs() ** 2).sum().backward()
        # one sweep forward + one d_env sweep on the card, nothing on the host
        assert ts.launch_counts()[name] == (2 if where == "cuda" else 0)
        results.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for c, h in zip(*results):
        assert _rel(c, h) <= 1e-5


def test_transfer_wrapper_refuses_what_the_kernel_does_not_take(dev):
    env, a, mx = _sweep_inputs(2, 8, 3, 2, 3, False, dev)
    with pytest.raises(ValueError, match="float32"):
        ts._launch(env.double(), a.double(), mx.double(), False)
    with pytest.raises(ValueError, match="is on"):
        ts._launch(env, a.cpu(), mx, False)
    with pytest.raises(ValueError, match="contiguous"):
        ts._launch(env.transpose(1, 2), a, mx, False)
    with pytest.raises(ValueError, match="shape"):
        ts._launch(env[:, :2, :2].contiguous(), a, mx, False)
    with pytest.raises(ValueError, match="square cores"):
        ts._launch(env, _sweep_inputs(2, 8, 3, 2, 4, False, dev)[1], mx, False)
    big = _sweep_inputs(2, 2, 128, 8, 128, True, dev)  # two env buffers of 256 KiB
    with pytest.raises(ValueError, match="does not fit"):
        ts.transfer_sweep_complex(*big)
    with pytest.raises(ValueError, match="float32"):
        ts.transfer_step(env.double(), a[0].double(), mx[0].double())


# ---------------------------------------------------------------------------
# wide cores through B4 (ROADMAP C1) and the brick-wall contraction on the card
# ---------------------------------------------------------------------------


def test_wide_cores_train_on_the_card_through_the_kernel(dev):
    """``train_single_node --dim 32``: complex64 cores of 32 x 32 x 32 x 32
    outgrow B4's shared memory, so its plan reads them from global memory;
    the sweep still runs as one B4 launch each way per step."""
    import contextlib
    import io

    from tneq_tpu_torch.apps.train_single_node import main

    ts.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = main(["--dim", "32", "--steps", "3", "--device", "cuda"])
    assert stats.steps == 3 and np.isfinite(stats.losses).all()
    assert ts.launch_counts() == {"transfer_step": 0, "transfer_step_complex": 6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_brick_wall_contraction_on_the_card_matches_the_host(dev, dtype):
    from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params
    from tneq_tpu_torch.ops.contract import contract_cores

    g = parse_graph(incidence_to_graph(build_brick_wall_incidence(8, 5, 2)))
    host = init_params(g, 0, dtype, device="cpu")
    card = contract_cores(g, {k: v.to(dev) for k, v in host.items()})
    ref = contract_cores(g, host)
    assert card.is_cuda and card.shape == ref.shape == (2,) * 16
    assert _rel(card.cpu(), ref) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_row_sweep_on_the_card_matches_the_host(dev, dtype):
    """The 8 x 5 wall's log overlap and its gradient through the row sweep
    (20-dimensional steps, within CUDA's 25)."""
    from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params
    from tneq_tpu_torch.ops.row_scan import make_row_scan_log_overlap_fn

    g = parse_graph(incidence_to_graph(build_brick_wall_incidence(8, 5, 2)))
    a = init_params(g, 0, dtype, "cpu")
    b = init_params(g, 1, dtype, "cpu")
    fn = make_row_scan_log_overlap_fn(g)
    out = {}
    for where in ("cpu", dev):
        leaves = {k: v.to(where).requires_grad_(True) for k, v in a.items()}
        val = fn(leaves, {k: v.to(where) for k, v in b.items()})
        grads = torch.autograd.grad(val, list(leaves.values()))
        out[str(where)] = (val.detach().cpu(), [x.cpu() for x in grads])
    (vh, gh), (vc, gc) = out["cpu"], out[str(dev)]
    assert bool(torch.isfinite(vc).all())
    assert float((vc - vh).abs().max()) <= 1e-5 * max(1.0, float(vh.abs().max()))
    for x, y in zip(gc, gh):
        assert _rel(x, y) <= 1e-4
