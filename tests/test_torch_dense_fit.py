"""Port parity: the masked dense fidelity fit (tneq_tpu_torch.train.fit vs
tneq_tpu.train.fit.make_masked_fidelity_fit).

A 6-qubit, 2-cell brick wall in complex64 (10 cores, a 4^6 target).  The
target is the dense tensor of numpy cores with two planted cores replaced
by identities; both packages start from the same numpy cores and run
SGD-G with ``retraction_prob=0``, and once with the retraction forced.
Every scope ('fit'; 'step' and 'chunk' with 4 steps per exit test) and
both loss kinds must stop after the same number of steps, with 1 − F
within 3e-5 of JAX's (float32 trajectories of ~100 Stiefel steps at lr 1
part by ~1e-5 near the exit).  The tolerances of the log-loss cases (2e-3)
and the raw ones (1e-3) leave the exit step >= 8 % clear of the
threshold, so rounding cannot move it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import build_brick_wall_incidence as j_brick
from tneq_tpu.graph import incidence_to_graph as j_inc
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops.contract import contract_cores as j_contract
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.train.fit import identity_cores as j_identity
from tneq_tpu.train.fit import make_masked_fidelity_fit as j_fit
from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.train.fit import identity_cores, make_masked_fidelity_fit, masked_cores

torch.set_num_threads(1)

PLANTED = [1, 6]
MAX_STEPS = 400
LOSS = {"raw": (1.0, 1e-3), "log": (1.0, 2e-3)}  # loss kind: (lr, tol)


def _problem():
    gt = parse_graph(incidence_to_graph(build_brick_wall_incidence(6, 2, 2)))
    gj = j_parse(j_inc(j_brick(6, 2, 2)))
    cores = params_to_numpy(init_params(gt, 1, torch.complex64, device="cpu"))
    idents = j_identity(gj, jnp.complex64)
    eff = {n: np.asarray(idents[n]) if i in PLANTED else cores[n]
           for i, n in enumerate(gt.core_names)}
    with jax.default_matmul_precision("highest"):
        target = np.array(j_contract(gj, {k: jnp.asarray(v) for k, v in eff.items()}))
    start = params_to_numpy(init_params(gt, 2, torch.complex64, device="cpu"))
    return gt, gj, target, start


def _run_both(scope, loss_kind, retraction_prob, mask=None):
    gt, gj, target, start = _problem()
    lr, tol = LOSS[loss_kind]
    sync = 1 if scope == "fit" else 4
    mask = np.ones(gt.ncores, np.float32) if mask is None else mask
    fj = j_fit(gj, j_sgdg(lr, momentum=0.9, retraction_prob=retraction_prob), MAX_STEPS,
               tol=tol, loss_kind=loss_kind, jit_scope=scope, sync_every=sync)
    with jax.default_matmul_precision("highest"):
        rj = fj({k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(mask),
                jnp.asarray(target))
    ft = make_masked_fidelity_fit(
        gt, t_sgdg(lr, momentum=0.9, retraction_prob=retraction_prob), MAX_STEPS,
        tol=tol, loss_kind=loss_kind, jit_scope=scope, sync_every=sync, device="cpu")
    rt = ft(params_from_numpy(start, "cpu"), torch.as_tensor(mask), torch.as_tensor(target))
    return rt, rj, tol


@pytest.mark.parametrize("loss_kind", ["raw", "log"])
@pytest.mark.parametrize("scope", ["fit", "step", "chunk"])
def test_masked_dense_fit_matches_jax(scope, loss_kind):
    rt, rj, tol = _run_both(scope, loss_kind, 0.0)
    assert int(rj.steps) < MAX_STEPS and float(rj.infidelity) < tol  # it converged
    assert rt.steps == int(rj.steps)
    if scope == "chunk":
        assert rt.steps % 4 == 0
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=0, atol=3e-5)
    assert rt.infidelity.dtype == torch.float32
    assert set(rt.params) == set(rj.params)


def test_masked_dense_fit_with_the_retraction_forced():
    rt, rj, tol = _run_both("fit", "raw", 1.0)
    assert rt.steps == int(rj.steps) < MAX_STEPS
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=0, atol=3e-5)
    for k in rj.params:  # the retraction keeps the cores on the manifold
        m = rt.params[k].reshape(4, 4)
        torch.testing.assert_close(m.conj().T @ m, torch.eye(4, dtype=m.dtype),
                                   atol=1e-5, rtol=0)


def test_a_masked_fit_substitutes_identities_like_jax():
    """The planted cores masked out: one step of the prune fit's loss, and
    the blend itself."""
    mask = np.ones(10, np.float32)
    mask[PLANTED] = 0.0
    rt, rj, _ = _run_both("fit", "raw", 0.0, mask=mask)
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(float(rt.infidelity), float(rj.infidelity), rtol=0, atol=3e-5)
    gt, gj, _, start = _problem()
    idents = {k: torch.as_tensor(v) for k, v in identity_cores(gt, torch.complex64).items()}
    eff = masked_cores(params_from_numpy(start, "cpu"), torch.as_tensor(mask), idents,
                       gt.core_names, torch.complex64)
    j_id = j_identity(gj, jnp.complex64)
    for i, n in enumerate(gt.core_names):
        np.testing.assert_array_equal(eff[n].numpy(), np.asarray(j_id[n]) if i in PLANTED
                                      else start[n])


def test_unported_options_raise():
    """Every option of the JAX fit is ported now: the stacked-real pairs
    (item 7c) build and ``.batched`` (items 5/6) runs lanes (both held
    against JAX in test_torch_complex_pair.py and test_torch_batched.py);
    what raises is an invalid scope or loss kind."""
    gt = parse_graph(incidence_to_graph(build_brick_wall_incidence(4, 1, 2)))
    opt = t_sgdg(0.1)
    assert make_masked_fidelity_fit(gt, opt, 5, complex_as_real=True, device="cpu").scope == "fit"
    with pytest.raises(ValueError, match="jit_scope"):
        make_masked_fidelity_fit(gt, opt, 5, jit_scope="bogus", device="cpu")
    with pytest.raises(ValueError, match="loss_kind"):
        make_masked_fidelity_fit(gt, opt, 5, loss_kind="bogus", device="cpu")
    fit = make_masked_fidelity_fit(gt, opt, 5, device="cpu")
    assert fit.scope == "fit"
    gj = j_parse(j_inc(j_brick(4, 1, 2)))
    target = np.array(j_contract(gj, {k: jnp.asarray(v) for k, v in
                                      params_to_numpy(init_params(gt, 1, torch.complex64,
                                                                  device="cpu")).items()}))
    res = fit.batched(init_params(gt, 2, torch.complex64, device="cpu"),
                      torch.ones(2, gt.ncores), torch.as_tensor(target), chunk_steps=2)
    assert res.steps == 6 and res.infidelity.shape == (2,)
