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

import dataclasses
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


@pytest.mark.parametrize("n,cells", [(4, 2), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_graph_b_and_signed_match_jax(dtype, n, cells):
    """The B side with rank-3 internal bonds; ``signed`` gives the mantissa
    and log-scale, whose log-abs is the overlap.  At 5 x 3 the plan's gate
    steps take rank-3 legs (K·N up to 144) and run as gate steps."""
    gt, gj = graphs(n, cells)
    gbt, gbj = graphs(n, cells, wide_bonds=True)
    gate_steps = sum(f is not None for r in trow._schedule(gt, gbt) for f in (r.gates or ()))
    assert gate_steps == {(4, 2): 0, (5, 3): 15}[(n, cells)]
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


# ---------------------------------------------------------------------------
# Gate steps: the step forms of the 8 x 5 wall's plan, as the Function runs
# them (plain versions on the host) against the einsum step they replace
# ---------------------------------------------------------------------------


def _wall_forms():
    """One planned step of each gate form of the 8 x 5 wall: ``{name:
    (step equation, GateForm)}``."""
    forms = trow.gate_forms(parse_graph(brick_dsl(8, 5)))
    return {("diagonal" if diag else "main" if n == 4 else f"last{big}"): step
            for (_, n, diag, big), step in forms.items()}


FORMS = _wall_forms()


def _shrunk(form, keep=3):
    """``form`` with all but its last ``keep`` free legs cut to extent 1."""
    cut = set(form.f[:-keep])
    return dataclasses.replace(form, sizes=tuple((c, 1 if c in cut else s) for c, s in form.sizes))


def _einsum_step(eq, form, env, gate, conj):
    """The pairwise einsum the gate step replaces, operands in step order."""
    g = gate.conj() if conj else gate
    return tpair.einsum(eq, env, g) if form.big == 0 else tpair.einsum(eq, g, env)


def _inputs(form, dtype, seed, lanes=()):
    gen = torch.Generator().manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, dtype=dtype, generator=gen)

    return (rnd(lanes + form.shape(form.e)), rnd(form.shape(form.g)),
            rnd(lanes + form.shape(form.o)))


def test_wall_plan_has_the_three_gate_forms():
    """Main steps (K = N = 4), first-of-row steps across a diagonal of the
    2^20 environment, last-of-row steps writing N = 16 interleaved legs
    (the gate first or second in the step)."""
    assert sorted(FORMS) == ["diagonal", "last0", "last1", "main"]
    for name, (_, f) in FORMS.items():
        assert (f.size(f.k), f.size(f.n), bool(f.d)) == (
            4, 16 if name.startswith("last") else 4, name == "diagonal")
        assert f.size(f.e) == (1 << 20 if f.d else 1 << 18)


class _PlainGate(torch.autograd.Function):
    """The gate step's plain forward with its plain VJP, for gradcheck."""

    @staticmethod
    def forward(ctx, env, gate, form, conj):
        ctx.save_for_backward(env, gate)
        ctx.form, ctx.conj = form, conj
        return trow._gate_fwd_plain(env, gate, form, conj)

    @staticmethod
    def backward(ctx, dout):
        env, gate = ctx.saved_tensors
        d_env, d_gate = trow._gate_bwd_plain(env, gate, dout, ctx.form, ctx.conj, True, True)
        return d_env, d_gate, None, None


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("name", sorted(FORMS))
def test_gate_step_matches_einsum(name, conj):
    """The plain gate step equals the einsum step it replaces at the wall's
    full extents (complex64, the gate conjugated or not), and its VJP
    passes complex128 ``gradcheck`` at cut free extents."""
    eq, form = FORMS[name]
    env, gate, _ = _inputs(form, torch.complex64, 11)
    got = trow._gate_fwd_plain(env, gate, form, conj)
    ref = _einsum_step(eq, form, env, gate, conj)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    small = _shrunk(form)
    env, gate, _ = _inputs(small, torch.complex128, 12)
    env.requires_grad_(True)
    gate.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda e, g: _PlainGate.apply(e, g, small, conj),
                                    (env, gate), eps=1e-6, atol=1e-6)
    # one gradient alone, as the sweep asks for a target's (constant) gate
    dout = torch.randn(small.shape(small.o), dtype=torch.complex128)
    d_env, d_gate = trow._gate_bwd_plain(env.detach(), gate.detach(), dout, small, conj,
                                         True, False)
    assert d_gate is None and d_env.shape == env.shape


def _einsum_sweep(graph, params_a, params_b):
    """The row sweep as every step a ``torch.einsum`` under autograd (the
    executor the gate steps replace): the reference."""
    env, logs = None, None
    for row in trow._schedule(graph, None):
        ops = [env] if row.has_env else []
        ops += [params_a[nm] for nm in row.cores] + [params_b[nm].conj() for nm in row.cores]
        out = (tpair.einsum(row.equation, ops[0]) if row.steps is None
               else tpair.execute_pairwise(row.steps, ops))
        env, logs = tpair._rescale(out, logs)
    return logs + torch.log(torch.abs(env) + tpair._TINY)


def test_sweep_under_vmap_and_grad_and_value():
    """8 lanes of ``torch.func.vmap`` over the A side with the B side
    shared and unbatched (the target's cores: gates of lane stride 0), and
    ``grad_and_value`` inside, on the 6 x 4 wall, whose plan has every
    gate form of the 8 x 5 wall: values and gradients equal the einsum
    sweep's, for ⟨A, T⟩ and ⟨A, A⟩."""
    g = parse_graph(brick_dsl(6, 4))
    assert {(f.size(f.n), bool(f.d)) for r in trow._schedule(g, None)
            for f in (r.gates or ()) if f is not None} == {(4, False), (4, True), (16, False)}
    names = list(g.core_names)
    lanes = [cores(g, torch.complex64, 20 + i) for i in range(8)]
    a = {n: torch.stack([torch.as_tensor(lane[n]) for lane in lanes]) for n in names}
    t = params_from_numpy(cores(g, torch.complex64, 30), "cpu")
    fn = trow.make_row_scan_log_overlap_fn(g)

    def loss(overlap):
        def f(p):
            return 2.0 * overlap(p, t) - overlap(p, p)
        return f

    def lanes_of(f):
        return torch.func.vmap(torch.func.grad_and_value(f))(a)

    trow.reset_launch_counts()
    grads, vals = lanes_of(loss(fn))
    einsum_steps = trow.launch_counts()["row_step_einsum"]
    ref_grads, ref_vals = lanes_of(loss(lambda p, q: _einsum_sweep(g, p, q)))
    torch.testing.assert_close(vals, ref_vals, rtol=1e-5, atol=1e-5)
    for n in names:
        scale = float(ref_grads[n].abs().max())
        torch.testing.assert_close(grads[n], ref_grads[n], rtol=1e-4, atol=1e-4 * scale)
    # one vmapped call per overlap: its gate steps ran once for all lanes
    plan = [f for r in trow._schedule(g, None) for f in (r.gates or ())]
    assert einsum_steps == 2 * sum(f is None for f in plan)


@pytest.mark.parametrize("dtype,einsum_steps", [(torch.complex64, 15), (torch.complex128, 69)])
def test_gate_step_routing_on_the_8x5_plan(dtype, einsum_steps):
    """Of the 69 pairwise steps of an 8 x 5 overlap, 54 are gate steps (42
    main, 6 diagonal first-of-row, 6 N = 16 last-of-row): 15 stay on
    einsum in complex64 (on the card the counter then shows 54
    ``row_gate_fwd``); in complex128 every step does."""
    g = parse_graph(brick_dsl(8, 5))
    rows = trow._schedule(g, None)
    forms = [f for r in rows for f in (r.gates or ())]
    assert len(forms) == 69
    gates = [f for f in forms if f is not None]
    assert len(gates) == 54
    assert sum(1 for f in gates if f.d) == 6
    assert sum(1 for f in gates if f.size(f.n) == 16) == 6
    # the first and last rows and the core-core steps stay on einsum
    assert all(f is None for f in rows[0].gates) and rows[-1].steps is None
    p = params_from_numpy(cores(g, torch.complex64, 14), "cpu", dtype=dtype)
    q = params_from_numpy(cores(g, torch.complex64, 15), "cpu", dtype=dtype)
    trow.reset_launch_counts()
    val = trow.make_row_scan_log_overlap_fn(g)(p, q)
    assert torch.isfinite(val)
    assert trow.launch_counts() == {"row_gate_fwd": 0, "row_gate_bwd": 0,
                                    "row_step_einsum": einsum_steps}
