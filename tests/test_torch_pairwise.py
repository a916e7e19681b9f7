"""Port parity: the rescaled pairwise executor (tneq_tpu_torch.ops.pairwise
vs tneq_tpu.ops.pairwise): path choice, the executor with and without
rescaling, ``log_abs_einsum`` and the two-network log overlaps.

Operands are drawn in numpy and handed to both packages; JAX runs on the
CPU at 'highest' precision, under ``jax.jit`` (its eager pairwise loop
dispatches op by op).  Paths are exact; log values agree within 1e-5
relative to max(|value|, 1) (a log overlap is a sum of O(1) log-scales,
so its rounding does not shrink with the value), gradients within 1e-4 of their max-abs (complex gradients against
the conjugate of JAX's: torch's convention for a real loss).
"""

import logging
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops import pairwise as jpair
from tneq_tpu.ops import row_scan as jrow
from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import pairwise as tpair
from tneq_tpu_torch.ops import row_scan as trow

torch.set_num_threads(1)

RTOL_V, RTOL_G = 1e-5, 1e-4
NP = {torch.float32: np.float32, torch.complex64: np.complex64}

# native path's largest intermediate 8, the linear fold's 4
SMALL_EQ = "hcf,ca,h,eab->"
SMALL_SHAPES = ((2, 8, 4), (8, 2), (2,), (2, 2, 2))


def brick_dsl(n, cells, wide_bonds=False):
    """The brick wall's DSL; ``wide_bonds``: its internal bonds at rank 3
    (same topology and boundary, other internal ranks)."""
    dsl = incidence_to_graph(build_brick_wall_incidence(n, cells, 2))
    return re.sub(r"(?<=[A-Za-z])-2-(?=[A-Za-z])", "-3-", dsl) if wide_bonds else dsl


def graphs(n, cells, wide_bonds=False):
    dsl = brick_dsl(n, cells, wide_bonds)
    return parse_graph(dsl), j_parse(dsl)


def cores(g, dtype, seed):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _operands(shapes, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        x = rng.standard_normal(s)
        if NP[dtype] == np.complex64:
            x = x + 1j * rng.standard_normal(s)
        out.append((scale * x).astype(NP[dtype]))
    return out


def _grads_close(tg, jg):
    for t, j in zip(tg, jg):
        ref = np.conj(np.asarray(j))
        np.testing.assert_allclose(t, ref, rtol=RTOL_G, atol=RTOL_G * np.abs(ref).max())


def _row_equations(n, cells):
    """(equation, shapes, cap) of every planned row of the n x cells sweep,
    at the caps the row sweep plans them with."""
    g = parse_graph(brick_dsl(n, cells))
    for st in trow.build_row_steps(g):
        shapes = ([st["env_in_shape"]] if st["has_env"] else []) + [
            g.shapes[nm] for nm in st["cores"]] * 2
        if len(shapes) > 2:
            env = max(int(np.prod(st["env_in_shape"])), int(np.prod(st["env_out_shape"])))
            yield st["equation"], tuple(tuple(s) for s in shapes), max(64 * env, 1 << 16)


def test_choose_path_matches_jax_on_the_row_equations():
    rows = list(_row_equations(6, 4))
    assert len(rows) == 5
    for eq, shapes, cap in rows:
        path = tpair.choose_path(eq, shapes, cap)
        assert path == jpair.choose_path(eq, shapes, cap)
        assert tpair._max_intermediate_size(eq, shapes, list(path)) <= cap
        assert tpair.path_flops(eq, shapes, list(path)) == jpair.path_flops(eq, shapes, list(path))
    eq, slots = tpair.two_network_interleave(parse_graph(brick_dsl(6, 4)))
    assert (eq, slots) == jpair.two_network_interleave(j_parse(brick_dsl(6, 4)))
    assert tpair.row_major_core_order(parse_graph(brick_dsl(6, 4))) == \
        jpair.row_major_core_order(j_parse(brick_dsl(6, 4)))


@pytest.mark.parametrize("cap,expect", [(8, "native"), (7, "linear"), (4, "linear"),
                                        (3, "no fit")])
def test_choose_path_size_guard_matches_jax(cap, expect, caplog):
    native = tuple(tuple(p) for p in tpair.find_path(SMALL_EQ, SMALL_SHAPES))
    linear = tuple(tpair._linear_path(4))
    assert native != linear
    with caplog.at_level(logging.WARNING):
        got = tpair.choose_path(SMALL_EQ, SMALL_SHAPES, cap)
    assert got == jpair.choose_path(SMALL_EQ, SMALL_SHAPES, cap)
    warned = any("no contraction path fits" in r.getMessage() for r in caplog.records)
    if expect == "no fit":
        assert warned and got == linear  # the smaller of the two (4 < 8)
        for mod in (tpair, jpair):
            with pytest.raises(ValueError, match="no contraction path fits"):
                mod.choose_path(SMALL_EQ, SMALL_SHAPES, cap, strict=True)
    else:
        assert not warned and got == (native if expect == "native" else linear)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("rescale", [False, True])
def test_execute_pairwise_matches_jax(dtype, rescale):
    ops = _operands(SMALL_SHAPES, dtype, 0, scale=30.0)
    steps = tpair.pairwise_steps(SMALL_EQ, tpair.choose_path(SMALL_EQ, SMALL_SHAPES))
    assert steps == jpair.pairwise_steps(SMALL_EQ, jpair.choose_path(SMALL_EQ, SMALL_SHAPES))

    def t_loss(*xs):
        out = tpair.execute_pairwise(steps, xs, rescale=rescale)
        if rescale:
            final, logs = out
            return torch.log(final.abs()) + logs, final, logs
        return torch.log(out.abs()), out, None

    def j_loss(*xs):
        out = jpair.execute_pairwise(steps, xs, rescale=rescale)
        if rescale:
            final, logs = out
            return jnp.log(jnp.abs(final)) + logs, (final, logs)
        return jnp.log(jnp.abs(out)), (out, None)

    leaves = [torch.tensor(o, requires_grad=True) for o in ops]
    val, final, logs = t_loss(*leaves)
    tg = [g.numpy() for g in torch.autograd.grad(val, leaves)]
    with jax.default_matmul_precision("highest"):
        (jval, (jfinal, jlogs)), jg = jax.jit(
            jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
            *[jnp.asarray(o) for o in ops])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL_V, atol=RTOL_V)
    _grads_close(tg, jg)
    if rescale:
        assert abs(abs(complex(final.detach())) - 1.0) < 1e-6  # the last step's rescale
        assert logs.dtype == torch.float32
        np.testing.assert_allclose(float(logs), float(jlogs), rtol=RTOL_V)
    # zero steps: the operand as it is, with a zero log-scale of its real dtype
    one, zero = tpair.execute_pairwise([], [torch.tensor(ops[0])], rescale=True)
    assert torch.equal(one, torch.tensor(ops[0])) and zero.dtype == torch.float32


def test_execute_pairwise_promotes_and_sums_logs_in_float64():
    a = torch.tensor(_operands([(3, 4)], torch.complex64, 1)[0]).to(torch.complex128)
    b = torch.tensor(_operands([(4, 3)], torch.float32, 2)[0])
    steps = tpair.pairwise_steps("ab,bc->ac", [(0, 1)])
    final, logs = tpair.execute_pairwise(steps, [a, b], rescale=True)
    assert final.dtype == torch.complex128 and logs.dtype == torch.float64
    torch.testing.assert_close(final * torch.exp(logs), a @ b.to(torch.complex128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_log_abs_einsum_matches_jax(dtype):
    ops = _operands(SMALL_SHAPES, dtype, 3, scale=50.0)
    got = tpair.log_abs_einsum(SMALL_EQ, [torch.tensor(o) for o in ops])
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda *xs: jpair.log_abs_einsum(SMALL_EQ, xs))(
            *[jnp.asarray(o) for o in ops])
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_V)
    dense = np.einsum(SMALL_EQ, *[o.astype(np.complex128) for o in ops])
    np.testing.assert_allclose(float(got), np.log(abs(dense)), rtol=RTOL_V)
    with pytest.raises(ValueError, match="scalar-output"):
        tpair.log_abs_einsum("ab,bc->ac", [torch.ones(2, 2)] * 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("wide_b", [False, True])
def test_log_abs_two_network_fn_matches_jax(dtype, wide_b):
    """4 x 2 brick wall; ``wide_b``: the B side has rank-3 internal bonds."""
    ga, gaj = graphs(4, 2)
    gb, gbj = graphs(4, 2, wide_bonds=wide_b)
    a, b = cores(ga, dtype, 0), cores(gb, dtype, 1)
    fn = tpair.make_log_abs_two_network_fn(ga, gb if wide_b else None)
    jfn = jpair.make_log_abs_two_network_fn(gaj, gbj if wide_b else None)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(a, "cpu").items()}
    val = fn(leaves, params_from_numpy(b, "cpu"))
    tg = torch.autograd.grad(val, list(leaves.values()))
    with jax.default_matmul_precision("highest"):
        jval, jg = jax.jit(jax.value_and_grad(lambda p: jfn(p, _jx(b))))(_jx(a))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL_V, atol=RTOL_V)
    _grads_close([g.numpy() for g in tg], [jg[k] for k in leaves])
    # signed: (mantissa, log_scale), summable across slices
    mant, logs = tpair.make_log_abs_two_network_fn(ga, gb if wide_b else None, signed=True)(
        params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu"))
    with jax.default_matmul_precision("highest"):
        jmant, jlogs = jax.jit(jpair.make_log_abs_two_network_fn(
            gaj, gbj if wide_b else None, signed=True))(_jx(a), _jx(b))
    np.testing.assert_allclose(complex(mant), complex(jmant), rtol=RTOL_V, atol=1e-6)
    np.testing.assert_allclose(float(logs), float(jlogs), rtol=RTOL_V, atol=RTOL_V)
    if not wide_b:  # the same-graph form, as the fits call it
        same = tpair.make_log_abs_overlap_fn(ga)(params_from_numpy(a, "cpu"),
                                                 params_from_numpy(b, "cpu"))
        np.testing.assert_allclose(float(same), float(jval), rtol=RTOL_V, atol=RTOL_V)


def test_overlaps_agree_with_the_row_sweep():
    """The generic executor and the row sweep contract the same overlap."""
    g, gj = graphs(5, 3)
    a, b = cores(g, torch.complex64, 2), cores(g, torch.complex64, 3)
    pa, pb = params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu")
    generic = tpair.make_log_abs_overlap_fn(g)(pa, pb)
    rows = trow.make_row_scan_log_overlap_fn(g)(pa, pb)
    np.testing.assert_allclose(float(generic), float(rows), rtol=RTOL_V)
    assert jrow.supports_row_scan(gj) and trow.supports_row_scan(g)


def test_cuda_rank_guard_applies_on_the_card_only(monkeypatch):
    eq = "abcdefghijklmnopqrstuvwxyz,a->bcdefghijklmnopqrstuvwxyz"
    x = torch.ones((1,) * 26)
    assert tpair.einsum(eq, x, torch.ones(1)).shape == (1,) * 25  # the host: no limit
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="rank-26"):
        tpair.einsum(eq, x, torch.ones(1))
