"""The sweep kernels B1/B2 on the card against their plain versions.

These tests need a CUDA card and skip without one; they import no JAX, so
they run on the machine with the card with the repository's conftest left
out::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

f32 tolerance: max|kernel - plain| / max|plain| <= 5e-5 per output (the two
sum in different orders; measured near 1e-6 on an H100).
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


@pytest.mark.parametrize("S", [1, 9, 130, 256, 1024])
def test_kernels_match_plain_versions(dev, S):
    u0, M, w = _inputs(7, S, S, dev)
    kf, pf = co._sweep_fwd_cuda(u0, M, w), co._sweep_fwd_plain(u0, M, w)
    for name, k, p in zip(("ustack", "scales", "f", "logsum", "ulast"), kf, pf):
        assert _rel(k, p) <= TOL or float((k - p).abs().max()) <= 1e-6, name
    kb = co._sweep_bwd_cuda(w, M, pf[0], pf[1])
    pb = co._sweep_bwd_plain(w, M, pf[0], pf[1])
    for name, k, p in zip(("dM", "du0"), kb, pb):
        assert _rel(k, p) <= TOL, name
    torch.cuda.synchronize()


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
