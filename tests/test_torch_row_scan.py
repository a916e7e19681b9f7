"""Port parity: the row-sweep overlap (tneq_tpu_torch.ops.row_scan vs
tneq_tpu.ops.row_scan).

The schedules (equations, core lists, env shapes) must be identical, and so
must the pairwise plans of every row.  Values and gradients of the log
overlap are held against JAX's (CPU, 'highest', under ``jax.jit``) on cores
drawn in numpy: log overlaps within 1e-5 relative to max(|value|, 1) (a
log overlap is a sum of O(1) per-row log-scales, so its rounding does not
shrink with the value), gradients within 1e-4 of their max-abs (complex
gradients against the conjugate of JAX's).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import mps_graph as j_mps, parse_graph as j_parse, tree_graph as j_tree
from tneq_tpu.graph import wall_graph_col as j_wall_col
from tneq_tpu.ops import row_scan as jrow
from tneq_tpu_torch.graph import (
    build_brick_wall_incidence,
    incidence_to_graph,
    mps_graph,
    parse_graph,
    tree_graph,
    wall_graph_col,
)
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import pairwise as tpair
from tneq_tpu_torch.ops import row_scan as trow

torch.set_num_threads(1)

RTOL_V, RTOL_G = 1e-5, 1e-4


def brick_dsl(n, cells, wide_bonds=False):
    dsl = incidence_to_graph(build_brick_wall_incidence(n, cells, 2))
    return re.sub(r"(?<=[A-Za-z])-2-(?=[A-Za-z])", "-3-", dsl) if wide_bonds else dsl


def graphs(n, cells, wide_bonds=False):
    dsl = brick_dsl(n, cells, wide_bonds)
    return parse_graph(dsl), j_parse(dsl)


def cores(g, dtype, seed):
    """Cores of ``g`` from ``init_params``, as numpy."""
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _value_and_grads(fn, jfn, a, b, reduce=lambda v: v.sum()):
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(a, "cpu").items()}
    val = fn(leaves, params_from_numpy(b, "cpu"))
    tg = dict(zip(leaves, torch.autograd.grad(reduce(val), list(leaves.values()))))
    with jax.default_matmul_precision("highest"):
        jval, jg = jax.jit(jax.value_and_grad(
            lambda p: (jnp.sum(jfn(p, _jx(b))), jfn(p, _jx(b))), has_aux=True))(_jx(a))
    return val.detach(), tg, np.asarray(jval[1]), jg


def _close(val, tg, jval, jg):
    np.testing.assert_allclose(val.numpy(), jval, rtol=RTOL_V, atol=RTOL_V)
    for k, g in tg.items():
        ref = np.conj(np.asarray(jg[k]))
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL_G, atol=RTOL_G * np.abs(ref).max())


@pytest.mark.parametrize("n,cells", [(4, 2), (5, 3), (6, 4), (8, 5)])
def test_build_row_steps_match_jax(n, cells):
    gt, gj = graphs(n, cells)
    assert trow.build_row_steps(gt) == jrow.build_row_steps(gj)
    gbt, gbj = graphs(n, cells, wide_bonds=True)
    assert trow.build_row_steps(gt, gbt) == jrow.build_row_steps(gj, gbj)


def test_row_plans_match_jax():
    """Every row's plan, at the row sweep's cap (``choose_path``), is
    JAX's; one-operand rows run one einsum."""
    gt, gj = graphs(6, 4)
    rows = trow._schedule(gt, None)
    jrow.make_row_scan_log_overlap_fn(gj)  # JAX writes its plans into its steps
    jsteps = jrow._cached_steps(gj, None)
    assert len(rows) == len(jsteps) == 6
    for row, js in zip(rows, jsteps):
        plan = js[("plan", None)]
        if plan is None:
            assert row.steps is None or len(row.steps) == 1
        else:
            assert (row.equation, list(row.steps)) == (plan[0], plan[1])
    assert rows[-1].steps is None  # the last row: a trace of one operand
    assert trow._schedule(gt, None) is rows  # cached


def test_flagship_plans_fit_the_card():
    """At 8 x 5 each overlap runs 69 pairwise einsums, at 32 x 5 309; the
    steps' terms stay within CUDA's 25 dimensions up to 6 cells."""
    for (n, cells), count in (((8, 5), 69), ((32, 5), 309)):
        g = parse_graph(brick_dsl(n, cells))
        rows = trow._schedule(g, None)
        assert sum(len(r.steps) for r in rows if r.steps) == count
    for cells, rank in ((5, 20), (6, 24)):
        g = parse_graph(brick_dsl(8, cells))
        assert trow.supports_row_scan(g)
        rows = trow._schedule(g, None)
        assert max(tpair._lettered(eq)[1] for r in rows if r.steps
                   for _, _, eq in r.steps) == rank <= tpair.CUDA_MAX_DIMS


def test_supports_row_scan_and_same_topology_match_jax():
    wide = "-2-A-2-\n-2-A-2-B-2-\n-2-A-2-B-2-\n-2-----B-2-"
    cases = [brick_dsl(6, 4), brick_dsl(2, 3), mps_graph(6, 4), tree_graph(5, 2),
             wall_graph_col(5, 3, 2), wide]
    jcases = [brick_dsl(6, 4), brick_dsl(2, 3), j_mps(6, 4), j_tree(5, 2),
              j_wall_col(5, 3, 2), wide]
    got = [trow.supports_row_scan(parse_graph(d)) for d in cases]
    assert got == [jrow.supports_row_scan(j_parse(d)) for d in jcases]
    assert got[0] and not got[1] and not got[-1]
    gt, gj = graphs(5, 3)
    gbt, gbj = graphs(5, 3, wide_bonds=True)
    assert trow.same_topology(gt, gbt) and jrow.same_topology(gj, gbj)
    assert trow.supports_row_scan(gt, gbt) == jrow.supports_row_scan(gj, gbj) is True
    assert not trow.same_topology(gt, parse_graph(brick_dsl(5, 2)))
    with pytest.raises(ValueError, match="layered 2-local"):
        trow.make_row_scan_log_overlap_fn(parse_graph(wide))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("n,cells", [(4, 2), (5, 3)])
def test_row_scan_log_overlap_matches_jax(n, cells, dtype):
    gt, gj = graphs(n, cells)
    a, b = cores(gt, dtype, 0), cores(gt, dtype, 1)
    got = _value_and_grads(trow.make_row_scan_log_overlap_fn(gt),
                           jrow.make_row_scan_log_overlap_fn(gj), a, b)
    _close(*got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_graph_b_and_signed_match_jax(dtype):
    """The B side with rank-3 internal bonds; ``signed`` gives the mantissa
    and log-scale, whose log-abs is the overlap."""
    gt, gj = graphs(4, 2)
    gbt, gbj = graphs(4, 2, wide_bonds=True)
    a, b = cores(gt, dtype, 4), cores(gbt, dtype, 5)
    got = _value_and_grads(trow.make_row_scan_log_overlap_fn(gt, graph_b=gbt),
                           jrow.make_row_scan_log_overlap_fn(gj, graph_b=gbj), a, b)
    _close(*got)
    mant, logs = trow.make_row_scan_log_overlap_fn(gt, graph_b=gbt, signed=True)(
        params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu"))
    with jax.default_matmul_precision("highest"):
        jmant, jlogs = jax.jit(jrow.make_row_scan_log_overlap_fn(gj, graph_b=gbj, signed=True))(
            _jx(a), _jx(b))
    np.testing.assert_allclose(complex(mant), complex(jmant), rtol=RTOL_V, atol=1e-6)
    np.testing.assert_allclose(float(logs), float(jlogs), rtol=RTOL_V, atol=RTOL_V)
    np.testing.assert_allclose(float(logs + torch.log(mant.abs())), float(got[0]),
                               rtol=RTOL_V, atol=RTOL_V)
    # the generic executor contracts the same two-graph overlap
    generic = tpair.make_log_abs_two_network_fn(gt, gbt)(params_from_numpy(a, "cpu"),
                                                         params_from_numpy(b, "cpu"))
    np.testing.assert_allclose(float(generic), float(got[0]), rtol=RTOL_V, atol=RTOL_V)


def test_row_scan_gradcheck_complex128():
    gt, _ = graphs(4, 2)
    p = cores(gt, torch.complex64, 6)
    q = params_from_numpy(cores(gt, torch.complex64, 7), "cpu", dtype=torch.complex128)
    names = list(gt.core_names)
    leaves = [torch.as_tensor(p[n]).to(torch.complex128).requires_grad_(True) for n in names]
    fn = trow.make_row_scan_log_overlap_fn(gt)
    assert fn(dict(zip(names, leaves)), q).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *xs: fn(dict(zip(names, xs)), q), leaves,
                                    eps=1e-6, atol=1e-6)


def test_deep_float32_overlap_is_finite_and_matches_jax():
    """30 x 3 in float32: the dense overlap would underflow; the row sweep
    stays finite and agrees with JAX's."""
    gt, gj = graphs(30, 3)
    a = cores(gt, torch.float32, 8)
    rng = np.random.default_rng(9)
    b = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in a.items()}
    got = trow.make_row_scan_log_overlap_fn(gt)(params_from_numpy(a, "cpu"),
                                                params_from_numpy(b, "cpu"))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jrow.make_row_scan_log_overlap_fn(gj))(_jx(a), _jx(b))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_V)
