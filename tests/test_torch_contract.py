"""Port parity: the general einsum contractions (tneq_tpu_torch.ops.contract,
ops.scaling.scaled_siamese_fn, ops.compiler's einsum strategy, QCTN's
contraction conveniences and the Trainer on non-chain graphs vs their
tneq_tpu counterparts).

Cores, states and operators are drawn in numpy and handed to both
packages.  The port runs every equation as pairwise ``torch.einsum`` steps
along its native path; JAX runs one ``jnp.einsum`` with the same path (5+
operands) or opt_einsum's (fewer).  Values: max|port − jax| <= 1e-5 ·
max|jax| (f32 and c64); gradients of a real loss: rtol 1e-4 and atol 1e-4 ·
max|ref| against JAX's (conjugated for complex: torch's gradient of a real
loss is the conjugate of ``jax.grad``'s).
"""

import string

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import (
    build_brick_wall_incidence as j_brick,
    incidence_to_graph as j_inc,
    parse_graph as j_parse,
    tree_graph as j_tree,
    wall_graph as j_wall,
)
from tneq_tpu.model.qctn import QCTN as JQCTN
from tneq_tpu.ops import contract as jc
from tneq_tpu.ops.compiler import estimate_cost as j_estimate_cost
from tneq_tpu.ops.scaling import scaled_siamese_fn as j_scaled
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.train.losses import nll_loss as j_nll
from tneq_tpu.train.trainer import Trainer as JTrainer
from tneq_tpu.train.trainer import TrainingConfig as JConfig
from tneq_tpu_torch.graph import (
    build_brick_wall_incidence,
    get_symbol,
    incidence_to_graph,
    parse_graph,
    tree_graph,
    wall_graph,
)
from tneq_tpu_torch.model.qctn import QCTN, init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import contract as tc
from tneq_tpu_torch.ops import pairwise as pw
from tneq_tpu_torch.ops.compiler import compile_siamese, estimate_cost
from tneq_tpu_torch.ops.scaling import scaled_siamese_fn
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.train.losses import nll_loss
from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig

torch.set_num_threads(1)

RTOL_V, RTOL_G = 1e-5, 1e-4
NP = {torch.float32: np.float32, torch.complex64: np.complex64, torch.complex128: np.complex128}

SOURCES = {
    "wall4": (wall_graph, j_wall, (4, 2, 2)),
    "wall5": (wall_graph, j_wall, (5, 2, 2)),
    "wall6": (wall_graph, j_wall, (6, 2, 2)),
    "tree4": (tree_graph, j_tree, (4, 2)),
}


def _graphs(name):
    if name == "brick8x5":
        return (parse_graph(incidence_to_graph(build_brick_wall_incidence(8, 5, 2))),
                j_parse(j_inc(j_brick(8, 5, 2))))
    t, j, args = SOURCES[name]
    return parse_graph(t(*args)), j_parse(j(*args))


def _cores(g, dtype, seed=0):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _close(t, j, rtol=RTOL_V):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rtol * max(np.abs(j).max(), 1e-30), np.abs(t - j).max()


def _close_grads(tg, jg):
    for k in jg:
        ref = np.conj(np.asarray(jg[k]))
        np.testing.assert_allclose(tg[k], ref, rtol=RTOL_G, atol=RTOL_G * np.abs(ref).max())


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _inputs(g, dtype, B=5, seed=1, states_batched=False):
    """Per-qubit states and ``(B, K, K)`` Hermitian operators, numpy."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        x = rng.standard_normal(shape)
        if np.dtype(NP[dtype]).kind == "c":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(NP[dtype])

    states = [mk(B, r) if states_batched else mk(r) for r in g.input_ranks]
    measures = []
    for r in g.output_ranks:
        m = mk(B, r, r)
        measures.append((m + np.conj(np.swapaxes(m, -1, -2))) / 2)
    return states, measures


def _torch_value_and_grads(fn, p_np, *args):
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    val = fn(leaves, *args)
    loss = (val.abs() ** 2).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return val.detach(), {k: g.numpy() for k, g in grads.items()}


def _jax_value_and_grads(fn, p_np, *args):
    with jax.default_matmul_precision("highest"):
        val = fn(_jx(p_np), *args)
        grads = jax.grad(lambda p: jnp.sum(jnp.abs(fn(p, *args)) ** 2))(_jx(p_np))
    return np.asarray(val), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("name", ["wall4", "wall5", "wall6", "brick8x5"])
def test_contract_cores_matches_jax(name, dtype):
    gt, gj = _graphs(name)
    p = _cores(gt, dtype)
    with jax.default_matmul_precision("highest"):
        ref = jc.contract_cores(gj, _jx(p))
    _close(tc.contract_cores(gt, params_from_numpy(p, "cpu")), ref)
    _close(tc.make_core_only_fn(gt, "qubit")(params_from_numpy(p, "cpu")),
           jc.make_core_only_fn(gj, "qubit")(_jx(p)))


def test_brick_wall_steps_fit_torch_einsum():
    """The 8 x 5 core-only equation has 78 symbols; each pairwise step has
    at most 21, re-lettered, and the largest intermediate has rank 16."""
    gt, _ = _graphs("brick8x5")
    spec = tc.core_only_spec(gt)
    steps = tc._schedule(spec.equation, tuple(gt.shapes[n] for n in gt.core_names))
    assert len(steps) == gt.ncores - 1
    lettered = [pw._lettered(eq) for _, _, eq in steps]
    assert max(len(set(eq) - set(",->")) for eq, _ in lettered) == 21
    assert all(set(eq) - set(",->") <= set(string.ascii_letters) for eq, _ in lettered)
    assert max(rank for _, rank in lettered) == 16 <= pw.CUDA_MAX_DIMS
    with pytest.raises(ValueError, match="more than 52 symbols"):
        pw._lettered(",".join(get_symbol(i) for i in range(53)) + "->")


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("name", ["wall4", "tree4"])
def test_siamese_fn_values_and_gradients_match_jax(name, dtype):
    gt, gj = _graphs(name)
    p = _cores(gt, dtype)
    states, measures = _inputs(gt, dtype)
    t_args = ([torch.as_tensor(s) for s in states], [torch.as_tensor(m) for m in measures])
    j_args = ([jnp.asarray(s) for s in states], [jnp.asarray(m) for m in measures])
    tv, tg = _torch_value_and_grads(tc.make_siamese_fn(gt), p, *t_args)
    jv, jg = _jax_value_and_grads(jc.make_siamese_fn(gj), p, *j_args)
    _close(tv, jv)
    _close_grads(tg, jg)
    # the Born-rule probability and the Trainer's NLL gradient
    _close(tc.siamese_probability(gt, params_from_numpy(p, "cpu"), *t_args),
           jc.siamese_probability(gj, _jx(p), *j_args))
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    nll = nll_loss(tc.siamese_probability(gt, leaves, *t_args))
    tg = dict(zip(leaves, (g.numpy() for g in torch.autograd.grad(nll, list(leaves.values())))))
    with jax.default_matmul_precision("highest"):
        jg = jax.grad(lambda q: j_nll(jc.siamese_probability(gj, q, *j_args)))(_jx(p))
    _close_grads(tg, jg)


@pytest.mark.parametrize("kw", [{"states_batched": True}, {"measure_extra_dims": 2},
                                {"with_states": False}, {"conj_right": False}])
def test_siamese_fn_variants_match_jax(kw):
    gt, gj = _graphs("wall4")
    dtype = torch.complex64
    p = _cores(gt, dtype)
    states, measures = _inputs(gt, dtype, states_batched=kw.get("states_batched", False))
    if kw.get("measure_extra_dims") == 2:
        measures = [np.stack([m, 2 * m], axis=1) for m in measures]
    if kw.get("with_states") is False:
        states = None
    t_states = None if states is None else [torch.as_tensor(s) for s in states]
    j_states = None if states is None else [jnp.asarray(s) for s in states]
    tv = tc.make_siamese_fn(gt, **kw)(params_from_numpy(p, "cpu"), t_states,
                                      [torch.as_tensor(m) for m in measures])
    with jax.default_matmul_precision("highest"):
        jv = jc.make_siamese_fn(gj, **kw)(_jx(p), j_states, [jnp.asarray(m) for m in measures])
    _close(tv, jv)


def test_siamese_fn_validates_like_jax():
    gt, _ = _graphs("wall4")
    fn = tc.make_siamese_fn(gt)
    p = params_from_numpy(_cores(gt, torch.complex64), "cpu")
    states, measures = _inputs(gt, torch.complex64)
    ts_ = [torch.as_tensor(s) for s in states]
    ms = [torch.as_tensor(m) for m in measures]
    with pytest.raises(ValueError, match="one measurement operator per qubit"):
        fn(p, ts_, ms[:-1])
    with pytest.raises(ValueError, match="Hermite order K"):
        fn(p, ts_, [m[:, :1, :1] for m in ms])
    with pytest.raises(ValueError, match="one input state per qubit"):
        fn(p, None, ms)
    with pytest.raises(ValueError, match="one input state per qubit"):
        tc.make_siamese_fn(gt, rescale=True)(p, None, ms)


@pytest.mark.parametrize("env", [False, True])
def test_rescaled_siamese_fns_match_jax(env):
    """rescale=True: (value, log_scale) through the rescaled executor; the
    value times exp(log_scale) is JAX's, and so are both parts."""
    gt, gj = _graphs("wall4")
    p = {k: 3.0 * v for k, v in _cores(gt, torch.complex64).items()}
    states, measures = _inputs(gt, torch.complex64)
    t_args = ([torch.as_tensor(s) for s in states], [torch.as_tensor(m) for m in measures])
    j_args = ([jnp.asarray(s) for s in states], [jnp.asarray(m) for m in measures])
    make_t = (lambda g, **kw: tc.make_siamese_env_fn(g, 2, **kw)) if env else tc.make_siamese_fn
    make_j = (lambda g, **kw: jc.make_siamese_env_fn(g, 2, **kw)) if env else jc.make_siamese_fn
    val, log_scale = make_t(gt, rescale=True)(params_from_numpy(p, "cpu"), *t_args)
    with jax.default_matmul_precision("highest"):
        jval, jlog = make_j(gj, rescale=True)(_jx(p), *j_args)
        dense = make_j(gj)(_jx(p), *j_args)
    assert log_scale.dtype == torch.float32 and float(val.abs().max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(float(log_scale), float(jlog), rtol=1e-5)
    _close(val, jval)
    _close(val * torch.exp(log_scale), dense)


@pytest.mark.parametrize("open_qubit", [0, 2])
def test_siamese_env_fn_matches_jax(open_qubit):
    gt, gj = _graphs("wall4")
    p = _cores(gt, torch.complex64)
    states, measures = _inputs(gt, torch.complex64)
    t_args = ([torch.as_tensor(s) for s in states], [torch.as_tensor(m) for m in measures])
    j_args = ([jnp.asarray(s) for s in states], [jnp.asarray(m) for m in measures])
    tv, tg = _torch_value_and_grads(tc.make_siamese_env_fn(gt, open_qubit), p, *t_args)
    jv, jg = _jax_value_and_grads(jc.make_siamese_env_fn(gj, open_qubit), p, *j_args)
    _close(tv, jv)
    _close_grads(tg, jg)


@pytest.mark.parametrize("conj_target", [False, True])
def test_two_network_fn_matches_jax(conj_target):
    gt, gj = _graphs("wall5")
    p1, p2 = _cores(gt, torch.complex64, 0), _cores(gt, torch.complex64, 1)
    t2, j2 = params_from_numpy(p2, "cpu"), _jx(p2)
    tv, tg = _torch_value_and_grads(
        lambda p: tc.make_two_network_fn(gt, gt, conj_target)(p, t2), p1)
    jv, jg = _jax_value_and_grads(
        lambda p: jc.make_two_network_fn(gj, gj, conj_target)(p, j2), p1)
    _close(tv, jv)
    _close_grads(tg, jg)


@pytest.mark.parametrize("batched", [True, False])
def test_with_inputs_fn_matches_jax(batched):
    gt, gj = _graphs("tree4")
    p = _cores(gt, torch.complex64)
    states, _ = _inputs(gt, torch.complex64, states_batched=batched)
    tv, tg = _torch_value_and_grads(
        lambda q: tc.make_with_inputs_fn(gt, batched)(q, [torch.as_tensor(s) for s in states]), p)
    jv, jg = _jax_value_and_grads(
        lambda q: jc.make_with_inputs_fn(gj, batched)(q, [jnp.asarray(s) for s in states]), p)
    _close(tv, jv)
    _close_grads(tg, jg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_scaled_siamese_fn_matches_jax(dtype):
    gt, gj = _graphs("wall4")
    p = {k: 3.0 * v for k, v in _cores(gt, dtype).items()}
    states, measures = _inputs(gt, dtype)
    raw, log_scale = scaled_siamese_fn(gt)(
        params_from_numpy(p, "cpu"), [torch.as_tensor(s) for s in states],
        [torch.as_tensor(m) for m in measures])
    with jax.default_matmul_precision("highest"):
        jraw, jlog = j_scaled(gj)(_jx(p), [jnp.asarray(s) for s in states],
                                  [jnp.asarray(m) for m in measures])
    _close(raw, jraw)
    assert log_scale.dtype == torch.float32
    np.testing.assert_allclose(float(log_scale), float(jlog), rtol=1e-6)


def test_complex128_gradcheck_of_a_siamese_contraction():
    gt, _ = _graphs("tree4")
    p = _cores(gt, torch.complex64)
    states, measures = _inputs(gt, torch.complex128, B=2)
    fn = tc.make_siamese_fn(gt)
    names = list(gt.core_names)
    cores = [torch.as_tensor(p[n]).to(torch.complex128).requires_grad_(True) for n in names]
    ts_ = [torch.as_tensor(s) for s in states]
    ms = [torch.as_tensor(m) for m in measures]
    assert fn(dict(zip(names, cores)), ts_, ms).dtype == torch.complex128
    assert torch.autograd.gradcheck(
        lambda *cs: fn(dict(zip(names, cs)), ts_, ms), cores, eps=1e-6, atol=1e-6)


def test_compile_siamese_einsum_strategy_and_cost():
    gt, gj = _graphs("wall4")
    fn, name = compile_siamese(gt)
    assert name == "einsum_pairwise"
    p = _cores(gt, torch.complex64)
    states, measures = _inputs(gt, torch.complex64)
    args = ([torch.as_tensor(s) for s in states], [torch.as_tensor(m) for m in measures])
    pt = params_from_numpy(p, "cpu")
    torch.testing.assert_close(fn(pt, *args), tc.make_siamese_fn(gt)(pt, *args), rtol=0, atol=0)
    for batch in (1, 16):
        assert estimate_cost(gt, batch) == j_estimate_cost(gj, batch)


def test_qctn_contraction_conveniences_match_jax():
    _, gj = _graphs("wall4")
    src = j_wall(4, 2, 2)
    p = _cores(parse_graph(src), torch.complex64)
    q = _cores(parse_graph(src), torch.complex64, 1)
    tq = QCTN(src, params_from_numpy(p, "cpu"), device="cpu")
    tq2 = QCTN(src, params_from_numpy(q, "cpu"), device="cpu")
    jq, jq2 = JQCTN(src, _jx(p)), JQCTN(src, _jx(q))
    states, measures = _inputs(gj, torch.complex64)
    t_states, j_states = [torch.as_tensor(s) for s in states], [jnp.asarray(s) for s in states]
    with jax.default_matmul_precision("highest"):
        _close(tq.contract_core_only(), jq.contract_core_only())
        _close(tq.contract_with_inputs(t_states), jq.contract_with_inputs(j_states))
        _close(tq.contract_with_self(t_states, [torch.as_tensor(m) for m in measures]),
               jq.contract_with_self(j_states, [jnp.asarray(m) for m in measures]))
        for conj in (False, True):
            _close(tq.contract_with_qctn(tq2, conj), jq.contract_with_qctn(jq2, conj))


@pytest.mark.parametrize("name", ["wall4", "tree4"])
def test_trainer_on_non_chain_graphs_matches_jax(name):
    gt, gj = _graphs(name)
    p = _cores(gt, torch.complex64)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((8, gt.nqubits)).astype(np.float32) for _ in range(2)]
    tt = Trainer(gt, optimizer=t_sgdg(1e-2, momentum=0.9, retraction_prob=0.0),
                 config=TrainingConfig(max_steps=3, log_every=0), device="cpu")
    tj = JTrainer(gj, optimizer=j_sgdg(1e-2, momentum=0.9, retraction_prob=0.0),
                  config=JConfig(max_steps=3, log_every=0))
    assert tt.strategy == "einsum_pairwise"
    pt, st = tt.fit(params_from_numpy(p, "cpu"), [torch.as_tensor(x) for x in xs], verbose=False)
    with jax.default_matmul_precision("highest"):
        pj, sj = tj.fit(_jx(p), [jnp.asarray(x) for x in xs], verbose=False)
    assert st.steps == sj.steps == 3
    assert max(st.losses) < 23.0  # below the clip: the comparison is not vacuous
    np.testing.assert_allclose(st.losses, sj.losses, rtol=1e-5)
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=2e-5)
