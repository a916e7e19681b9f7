"""Port parity: optimizers (tneq_tpu_torch.optim vs tneq_tpu.optim).

Each case minimises the same loss in both frameworks from the same numpy
point, with each framework's own autodiff, for several steps.  That settles
the complex-gradient convention end to end: torch's gradient of a real loss
is the conjugate of ``jax.grad``'s, and every port update must still take
the JAX package's step.  Retraction draws come from different generators,
so the Stiefel optimizers are held with ``retraction_prob=0`` and with the
retraction forced (``1``).  f32 tolerances: rtol 2e-5, atol 2e-6 over three
steps.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp

from tneq_tpu.optim import factory as jf
from tneq_tpu.optim import manifold as jm
from tneq_tpu.optim import schedules as js
from tneq_tpu.optim import stiefel as jst
from tneq_tpu_torch.optim import factory as tf
from tneq_tpu_torch.optim import manifold as tm
from tneq_tpu_torch.optim import pair_stiefel as tps
from tneq_tpu_torch.optim import schedules as ts
from tneq_tpu_torch.optim import stiefel as tst

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
SHAPES = {
    "a": (2, 2, 2, 2),  # Stiefel, shares its group with "b"
    "b": (2, 2, 2, 2),
    "c": (2, 2, 2, 4),  # Stiefel, a group of its own (rows 4 <= cols 8)
    "d": (4, 2, 2, 2),  # rows 8 > cols 4: the plain-update branch
}


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    params = {}
    for k, s in SHAPES.items():
        rows = int(np.prod(s[:2]))
        m = draw((rows, int(np.prod(s[2:]))))
        q, _ = np.linalg.qr(m.T if rows <= m.shape[1] else m)
        params[k] = (q.T if rows <= m.shape[1] else q).reshape(s).astype(dtype)
    coef = {k: (draw(s), draw(s)) for k, s in SHAPES.items()}
    return params, coef


def _j_loss(coef):
    def loss(p):
        return sum(jnp.abs(jnp.sum(coef[k][0] * p[k])) ** 2
                   + jnp.real(jnp.sum(coef[k][1] * p[k])) for k in p)
    return loss


def _t_loss(coef):
    tc = {k: tuple(torch.as_tensor(c) for c in v) for k, v in coef.items()}

    def loss(p):
        return sum(torch.abs(torch.sum(tc[k][0] * p[k])) ** 2
                   + torch.real(torch.sum(tc[k][1] * p[k])) for k in p)
    return loss


def _run(j_opt, t_opt, dtype, steps=3):
    p_np, coef = _problem(dtype)
    jl, tl = jax.grad(_j_loss(coef)), _t_loss(coef)
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: torch.as_tensor(v) for k, v in p_np.items()}
    sj, st = j_opt.init(pj), t_opt.init(pt)
    for _ in range(steps):
        uj, sj = j_opt.update(jl(pj), sj, pj)
        pj = jax.tree.map(lambda a, b: a + b, pj, uj)
        leaves = {k: v.detach().requires_grad_(True) for k, v in pt.items()}
        gt = dict(zip(leaves, torch.autograd.grad(tl(leaves), list(leaves.values()))))
        with torch.no_grad():
            ut, st = t_opt.update(gt, st, pt)
            pt = {k: pt[k] + ut[k] for k in pt}
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    return pt


DTYPES = [np.float32, np.complex64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("retraction", [0.0, 1.0])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgdg_parity(dtype, retraction, momentum):
    kw = dict(momentum=momentum, retraction_prob=retraction)
    _run(jst.sgdg(0.1, **kw), tst.sgdg(0.1, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgdg_variants_parity(dtype):
    kw = dict(momentum=0.9, nesterov=True, weight_decay=1e-2, retraction_prob=0.0,
              cayley="iterative", cayley_iters=6)
    _run(jst.sgdg(0.05, **kw), tst.sgdg(0.05, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("retraction", [0.0, 1.0])
def test_adamg_parity(dtype, retraction):
    kw = dict(retraction_prob=retraction)
    _run(jst.adamg(0.05, **kw), tst.adamg(0.05, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["adam", "sgd", "momentum", "nesterov", "rmsprop"])
def test_factory_parity(method, dtype):
    hyper = {"lr": 3e-2}
    _run(jf.make_optimizer(method, **hyper), tf.make_optimizer(method, **hyper), dtype, steps=4)


def test_factory_stiefel_names_and_errors():
    assert isinstance(tf.make_optimizer("sgdg", lr=0.1), tst.GradientTransformation)
    assert isinstance(tf.make_optimizer("AdamG", learning_rate=0.1), tst.GradientTransformation)
    with pytest.raises(ValueError):
        tf.make_optimizer("lbfgs")
    with pytest.raises(ValueError):
        tst.sgdg(0.1, nesterov=True)


def test_schedule_parity_and_use():
    table = [(0, 0.1), (2, 0.05), (5, 0.01)]
    sj, st = js.step_table_schedule(table), ts.step_table_schedule(table)
    for c in range(8):
        assert float(st(c)) == float(sj(jnp.int32(c)))
    sj2, st2 = js.step_table_schedule(table[1:], 0.2), ts.step_table_schedule(table[1:], 0.2)
    assert [float(st2(c)) for c in range(7)] == [float(sj2(jnp.int32(c))) for c in range(7)]
    _run(jst.sgdg(sj, momentum=0.9, retraction_prob=0.0),
         tst.sgdg(st, momentum=0.9, retraction_prob=0.0), np.float32, steps=4)
    with pytest.raises(ValueError):
        ts.step_table_schedule([])


@pytest.mark.parametrize("dtype", DTYPES)
def test_manifold_helpers_parity(dtype):
    rng = np.random.default_rng(1)

    def draw(*shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    y, g, h = draw(3, 5), draw(3, 5), draw(3, 5)
    w = draw(5, 5)
    w = w - w.conj().T
    cases = [
        (tm.sym, jm.sym, (w,)),
        (tm.skew, jm.skew, (w,)),
        (tm.polar_retraction, jm.polar_retraction, (y,)),
        (tm.stiefel_project_tangent, jm.stiefel_project_tangent, (y, g)),
        (tm.stiefel_project_normal, jm.stiefel_project_normal, (y, g)),
        (tm.sphere_exp, jm.sphere_exp, (y, h)),
        (tm.sphere_transport, jm.sphere_transport, (y, h)),
        (tm.qr_retraction, jm.qr_retraction, (y,)),
        (tm.unit_rows, jm.unit_rows, (y,)),
        (tm.matrix_norm_one, jm.matrix_norm_one, (w,)),
    ]
    for t_fn, j_fn, args in cases:
        got = t_fn(*(torch.as_tensor(a) for a in args))
        ref = j_fn(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(got.resolve_conj().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=t_fn.__name__)
    got = tm.cayley_step(torch.as_tensor(g.T), torch.as_tensor(w), 0.3)
    ref = jm.cayley_step(jnp.asarray(g.T), jnp.asarray(w), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# The three Cayley solves (SGD-G/Adam-G's, the pair form's, the manifold
# helper's) skip ``torch.linalg.solve``'s check of the LU on the host, which
# on a card is a stream synchronise in every optimizer step.  They must still
# give its result bit for bit, alone and vmapped over lanes as the batched
# fits run them, without falling back to a per-lane loop.

CAYLEY_CASES = ["stiefel-complex64", "stiefel-float32", "manifold-complex64",
                "manifold-float32", "pair-float32"]


def _cayley_case(case, lanes=0):
    """``(module, solve, args)``: one Cayley solve on random skew-Hermitian
    W, batched over 3 systems (the manifold helper takes one), with a
    leading axis of ``lanes`` if given."""
    where, dtype = case.split("-")
    gen = torch.Generator().manual_seed(5)
    batch = ((lanes,) if lanes else ()) + (() if where == "manifold" else (3,))
    pair = (2,) if where == "pair" else ()

    def draw(*shape):
        return torch.randn(*batch, *pair, *shape, generator=gen, dtype=getattr(torch, dtype))

    w, x = draw(4, 4), draw(4, 2)
    alpha = torch.rand(batch, generator=gen) + 0.05
    if where == "pair":
        re, im = tps._re(w), tps._im(w)
        return tps, tps._pair_cayley_solve, (alpha, tps._pair(re - re.mT, im + im.mT), x)
    w = w - w.mH
    if where == "stiefel":
        return tst, tst._cayley_solve, (alpha, w, x)
    return tm, tm.cayley_step, (x, w, 0.3)


@pytest.mark.parametrize("lanes", [0, 8])
@pytest.mark.parametrize("case", CAYLEY_CASES)
def test_cayley_solves_give_linalg_solves_bits(case, lanes, monkeypatch):
    mod, solve, args = _cayley_case(case, lanes)
    if lanes:
        dims = tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
        solve = vmap(solve, in_dims=dims, randomness="same")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = solve(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [w for w in caught if "batching rule" in str(w.message)]
    monkeypatch.setattr(mod, "_solve_unchecked", torch.linalg.solve)
    assert torch.equal(got, solve(*args))


@pytest.mark.parametrize("make", [tst.sgdg, tst.adamg, tps.pair_sgdg])
def test_stiefel_updates_never_call_linalg_solve(make, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg.solve checks the LU on the host")

    monkeypatch.setattr(torch.linalg, "solve", refuse)
    gen = torch.Generator().manual_seed(0)
    shape = (2, 2, 2, 2, 2) if make is tps.pair_sgdg else (2, 2, 2, 2)
    dtype = torch.float32 if make is tps.pair_sgdg else torch.complex64

    def draw():
        return {f"c{i:02d}": torch.randn(shape, generator=gen, dtype=dtype) for i in range(35)}

    params, grads = draw(), draw()
    opt = make(1e-2, momentum=0.9, retraction_prob=1.0)
    updates, state = opt.update(grads, opt.init(params), params)
    assert state.count == 1
    assert all(bool(torch.isfinite(u).all()) for u in updates.values())
