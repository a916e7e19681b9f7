"""Port parity: the mesh and bond-sliced contractions in one process
(tneq_tpu_torch.parallel vs tneq_tpu.parallel).

Inputs are drawn in numpy and handed to both packages.  JAX's side runs on
a mesh of the first 2 (or 3) of its virtual CPU devices, the port's on as
many positions on the host, all in this process.  Each JAX reference is
computed once per module.  Tolerances: rtol 1e-5 on raw values (1e-5 of
max(1, |value|) on overlaps), log overlaps at rtol 1e-5 with atol 1e-5 (a
sum of O(1) log-scales), gradients within 1e-4 of their max-abs (complex
gradients against the conjugate of JAX's, pair gradients as they are),
masked fits at rtol 1e-4 with atol 1e-5 (ROADMAP §C quirk).  Ports of
JAX's own cases (``tests/test_sliced_log.py``, ``tests/test_parallel.py``
``TestMesh``/``TestSlicedModelParallel``/``TestSlicedTwoNetwork``) hold the
port's sliced functions against its unsliced ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import build_brick_wall_incidence as j_brick
from tneq_tpu.graph import incidence_to_graph as j_inc
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.ops.compiler import compile_siamese as j_compile
from tneq_tpu.optim.pair_stiefel import pair_sgdg as j_pair_sgdg
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.parallel import make_mesh as j_make_mesh
from tneq_tpu.parallel import mp as jmp
from tneq_tpu.train.network_fit import make_masked_network_fidelity_fit as j_net_fit
from tneq_tpu_torch.graph import (
    build_brick_wall_incidence,
    incidence_to_graph,
    mps_graph,
    parse_graph,
    wall_graph,
)
from tneq_tpu_torch.graph.surgery import with_bond_ranks
from tneq_tpu_torch.model.qctn import init_params, params_to_numpy
from tneq_tpu_torch.ops import (
    compile_siamese,
    make_siamese_fn,
    make_two_network_fn,
    measurement_matrices,
)
from tneq_tpu_torch.ops.complex_pair import make_pair_log_abs_overlap_fn, to_pair
from tneq_tpu_torch.ops.contract import abs_square
from tneq_tpu_torch.ops.pairwise import make_log_abs_overlap_fn
from tneq_tpu_torch.ops.row_scan import (
    make_row_scan_log_overlap_fn,
    same_topology,
    supports_row_scan,
)
from tneq_tpu_torch.optim.pair_stiefel import pair_sgdg
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.parallel import (
    choose_slice_bonds,
    make_mesh,
    make_sliced_siamese_fn,
    sliced_nll_loss,
)
from tneq_tpu_torch.parallel import mp as tmp
from tneq_tpu_torch.train.losses import nll_loss
from tneq_tpu_torch.train.network_fit import make_masked_network_fidelity_fit
from tneq_tpu_torch.train.trainer import basis_states

torch.set_num_threads(1)

GRAD_TOL = 1e-4


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=["cpu"] * n), j_make_mesh(axes, devices=jax.devices()[:n])


def _graphs(kind):
    """(port graph, JAX graph) of one test topology."""
    if kind.startswith("brick"):
        nq, nc = int(kind[5]), int(kind[7])
        return (parse_graph(incidence_to_graph(build_brick_wall_incidence(nq, nc))),
                j_parse(j_inc(j_brick(nq, nc))))
    src = {"wall_d3": wall_graph(4, layers=2, dim=3), "mps_d4": mps_graph(3, dim=4),
           "wall_d2": wall_graph(4, layers=2, dim=2), "mps_d3": mps_graph(3, dim=3)}[kind]
    return parse_graph(src), j_parse(src)


def _cores(g, dtype, seed):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _pair_np(p):
    return {k: np.stack([v.real, v.imag]).astype(np.float32) for k, v in p.items()}


def _max_rel(got: dict, ref: dict) -> float:
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


def _t_grad(fn, params: dict) -> dict:
    x = {k: torch.as_tensor(v).clone().requires_grad_() for k, v in params.items()}
    out = fn(x)
    gs = torch.autograd.grad(out, list(x.values()))
    return float(out.detach()), {k: g.numpy() for k, g in zip(x, gs)}


def _j_grad(fn, params: dict):
    # jitted: JAX's eager shard_map calls cost seconds each
    val, g = jax.jit(jax.value_and_grad(fn))({k: jnp.asarray(v) for k, v in params.items()})
    return float(val), {k: np.asarray(v) for k, v in g.items()}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_default_and_2d():
    """``TestMesh``: every device on one data axis by default; named 2-d
    axes; a device repeats (the one-card form)."""
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8} and mesh.axis_names == ("data",)
    mesh2 = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert mesh2.shape == {"data": 4, "model": 2} and mesh2.devices.shape == (4, 2)
    assert list(mesh2.shape) == list(j_make_mesh({"data": 4, "model": 2}).shape)
    assert all(d == torch.device("cpu") for d in mesh2.devices.flat)


def test_make_mesh_bad_sizes_raise():
    with pytest.raises(ValueError, match="need 3 devices, have 8"):
        make_mesh({"data": 3}, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        j_make_mesh({"data": 3})


# ---------------------------------------------------------------------------
# the bond choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["brick4x2", "brick5x3", "wall_d2", "wall_d3", "mps_d4"])
def test_choose_slice_bonds_matches_jax(kind):
    g, jg = _graphs(kind)
    assert tmp._internal_bonds(g) == jmp._internal_bonds(jg)

    def outcome(choose, graph, n, early):
        try:
            return choose(graph, n, early)
        except ValueError as e:  # too few bonds: the same message in both
            return str(e)

    for n in (1, 2, 3, 4, 8):
        for early in (False, True):
            assert outcome(choose_slice_bonds, g, n, early) \
                == outcome(jmp.choose_slice_bonds, jg, n, early)


def test_choose_insufficient_raises_like_jax():
    with pytest.raises(ValueError, match="no internal bonds"):
        choose_slice_bonds(parse_graph("-2-A-2-"), 2)
    with pytest.raises(ValueError, match="no internal bonds"):
        jmp.choose_slice_bonds(j_parse("-2-A-2-"), 2)
    # one rank-2 bond cannot give 4 slices
    src = "-2-A-2-B-2-"
    with pytest.raises(ValueError, match="cannot reach 4 slices") as t_err:
        choose_slice_bonds(parse_graph(src), 4)
    with pytest.raises(ValueError, match="cannot reach 4 slices") as j_err:
        jmp.choose_slice_bonds(j_parse(src), 4)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# the log overlap: values and gradients against JAX
# ---------------------------------------------------------------------------

# (topology, model positions): brick walls sliced on one rank-2 bond; a
# rank-3 bond over 2 positions (slice space padded 3 -> 4); a rank-4 bond
# over 3 positions (padded 4 -> 6: the third position has no slice)
LOG_CASES = [("brick4x2", 2), ("brick5x3", 2), ("wall_d3", 2), ("mps_d4", 3)]
LOG_FORMS = ["float32", "complex64", "pair"]


@pytest.fixture(scope="module")
def log_refs():
    """JAX's sliced log overlap, value and gradient, per (case, form)."""
    out = {}
    for kind, n in LOG_CASES:
        g, jg = _graphs(kind)
        _, jmesh = _mesh({"model": n})
        for form in LOG_FORMS:
            dt = torch.float32 if form == "float32" else torch.complex64
            pa, pb = _cores(g, dt, 0), _cores(g, dt, 1)
            if form == "pair":
                pa, pb = _pair_np(pa), _pair_np(pb)
            f = jmp.make_sliced_log_overlap_fn(jg, jmesh, pair=form == "pair")
            jb = {k: jnp.asarray(v) for k, v in pb.items()}
            val, grad = _j_grad(lambda p: f(p, jb), pa)
            out[kind, n, form] = (pa, pb, val, grad)
    return out


@pytest.mark.parametrize("form", LOG_FORMS)
@pytest.mark.parametrize("kind,n", LOG_CASES)
def test_sliced_log_overlap_matches_jax(log_refs, kind, n, form):
    pa, pb, j_val, j_grad = log_refs[kind, n, form]
    g, _ = _graphs(kind)
    mesh, _ = _mesh({"model": n})
    f = tmp.make_sliced_log_overlap_fn(g, mesh, pair=form == "pair")
    assert not f.ranks
    tb = {k: torch.as_tensor(v) for k, v in pb.items()}
    val, grad = _t_grad(lambda p: f(p, tb), pa)
    np.testing.assert_allclose(val, j_val, rtol=1e-5, atol=1e-5)
    if form == "complex64":
        j_grad = {k: np.conj(v) for k, v in j_grad.items()}
    assert _max_rel(grad, j_grad) < GRAD_TOL
    # and the port's unsliced overlap at the same inputs
    ref = (make_pair_log_abs_overlap_fn(g) if form == "pair" else make_log_abs_overlap_fn(g))
    np.testing.assert_allclose(val, float(ref({k: torch.as_tensor(v) for k, v in pa.items()}, tb)),
                               rtol=1e-5, atol=1e-5)


def test_complex128_gradcheck_of_the_sliced_log_overlap():
    """The complex sliced log overlap in complex128 against finite
    differences (two cores: one sliced, one not), over a padded slice
    space."""
    g, _ = _graphs("wall_d3")
    mesh, _ = _mesh({"model": 2})
    f = tmp.make_sliced_log_overlap_fn(g, mesh)
    pa = {k: torch.as_tensor(v) for k, v in _cores(g, torch.complex128, 0).items()}
    pb = {k: torch.as_tensor(v) for k, v in _cores(g, torch.complex128, 1).items()}
    bonds = choose_slice_bonds(g, 2, prefer_early_rows=True)
    sliced = g.cores[bonds[0][0]].name
    free = next(c.name for c in g.cores if c.index not in bonds[0][:2])
    names = (sliced, free)

    def fn(*xs):
        return f({**pa, **dict(zip(names, xs))}, pb)

    xs = tuple(pa[n].clone().requires_grad_() for n in names)
    assert torch.autograd.gradcheck(fn, xs, eps=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the raw forms against JAX
# ---------------------------------------------------------------------------

def _measures(g, n_batch, seed, K):
    x = np.random.default_rng(seed).normal(size=(n_batch, g.nqubits)).astype(np.float32)
    mx = measurement_matrices(torch.as_tensor(x), K).to(torch.complex64)
    return x, [mx[:, q] for q in range(g.nqubits)]


@pytest.fixture(scope="module")
def siamese_refs():
    """JAX's sliced siamese values and NLL gradients per (topology, model
    positions), on a mesh {'data': 1, 'model': n}."""
    from tneq_tpu.ops import measurement_matrices as j_mx
    from tneq_tpu.train.trainer import basis_states as j_basis

    out = {}
    for kind, n, K in (("wall_d2", 2, 2), ("wall_d2", 4, 2), ("mps_d3", 2, 3)):
        g, jg = _graphs(kind)
        _, jmesh = _mesh({"data": 1, "model": n})
        p = _cores(g, torch.complex64, 7)
        x, _ = _measures(g, 4, 5, K)
        mx = j_mx(jnp.asarray(x), K).astype(jnp.complex64)
        jm = [mx[:, q] for q in range(jg.nqubits)]
        st = j_basis(jg)
        fn = jax.jit(jmp.make_sliced_siamese_fn(jg, jmesh))
        raw = np.asarray(fn({k: jnp.asarray(v) for k, v in p.items()}, st, jm))
        loss, grad = _j_grad(lambda q: jmp.sliced_nll_loss(jg, jmesh, q, st, jm), p)
        out[kind, n] = (p, raw, loss, grad, K)
    return out


@pytest.mark.parametrize("kind,n", [("wall_d2", 2), ("wall_d2", 4), ("mps_d3", 2)])
def test_sliced_siamese_and_nll_match_jax(siamese_refs, kind, n):
    p, j_raw, j_loss, j_grad, K = siamese_refs[kind, n]
    g, _ = _graphs(kind)
    mesh, _ = _mesh({"data": 1, "model": n})
    _, ms = _measures(g, 4, 5, K)
    st = basis_states(g, dtype=torch.complex64, device="cpu")
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    raw = make_sliced_siamese_fn(g, mesh)(tp, st, ms)
    np.testing.assert_allclose(raw.numpy(), j_raw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(raw.numpy(), make_siamese_fn(g)(tp, st, ms).numpy(),
                               rtol=1e-5, atol=1e-6)
    loss, grad = _t_grad(lambda q: sliced_nll_loss(g, mesh, q, st, ms), p)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert _max_rel(grad, {k: np.conj(v) for k, v in j_grad.items()}) < GRAD_TOL


def test_sliced_two_network_matches_jax():
    g, jg = _graphs("wall_d2")
    mesh, jmesh = _mesh({"data": 1, "model": 2})
    p1, p2 = _cores(g, torch.complex64, 2), _cores(g, torch.complex64, 3)
    j2 = {k: jnp.asarray(v) for k, v in p2.items()}
    t2 = {k: torch.as_tensor(v) for k, v in p2.items()}
    jf = jax.jit(jmp.make_sliced_two_network_fn(jg, jg, jmesh))
    tf = tmp.make_sliced_two_network_fn(g, g, mesh)
    j_ov = complex(jf({k: jnp.asarray(v) for k, v in p1.items()}, j2))
    t_ov = complex(tf({k: torch.as_tensor(v) for k, v in p1.items()}, t2))
    assert abs(t_ov - j_ov) < 1e-5 * max(1.0, abs(j_ov))

    def j_loss(p):
        ov = jf(p, j2)
        return jnp.real(ov) ** 2 + jnp.imag(ov) ** 2

    _, j_grad = _j_grad(j_loss, p1)
    _, grad = _t_grad(lambda p: abs_square(tf(p, t2)), p1)
    assert _max_rel(grad, {k: np.conj(v) for k, v in j_grad.items()}) < GRAD_TOL


def test_compile_siamese_with_a_mesh_matches_jax():
    """``mode='auto'`` with a model axis > 1 and ``mode='sliced'`` take the
    sliced strategy under JAX's name; a model axis of 1 does not."""
    g, jg = _graphs("wall_d2")
    mesh, jmesh = _mesh({"data": 1, "model": 2})
    fn, name = compile_siamese(g, mesh=mesh)
    j_fn, j_name = j_compile(jg, mesh=jmesh)
    assert name == j_name == "sliced_shard_map"
    assert compile_siamese(g, mesh=mesh, mode="sliced")[1] == "sliced_shard_map"
    one, _ = _mesh({"model": 1})
    assert compile_siamese(g, mesh=one)[1] == "einsum_pairwise"
    with pytest.raises(ValueError, match="needs a mesh"):
        compile_siamese(g, mode="sliced")
    p = _cores(g, torch.complex64, 4)
    _, ms = _measures(g, 3, 6, 2)
    st = basis_states(g, dtype=torch.complex64, device="cpu")
    from tneq_tpu.train.trainer import basis_states as j_basis

    got = fn({k: torch.as_tensor(v) for k, v in p.items()}, st, ms)
    ref = jax.jit(j_fn)({k: jnp.asarray(v) for k, v in p.items()}, j_basis(jg),
               [jnp.asarray(m.numpy()) for m in ms])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the masked network fit with a mesh against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["float32", "pair"])
def test_masked_fit_with_mesh_matches_jax(form):
    """Both packages' mesh-sliced masked fits from the same start (on the
    manifold): the same step count and 1 − F at rtol 1e-4, atol 1e-5."""
    kind, steps = ("brick5x3", 10) if form == "float32" else ("brick4x2", 10)
    g, jg = _graphs(kind)
    mesh, jmesh = _mesh({"model": 2})
    if form == "pair":
        p = _pair_np(_cores(g, torch.complex64, 0))
        t_opt, j_opt = pair_sgdg(1e-2, momentum=0.9), j_pair_sgdg(1e-2, momentum=0.9)
        kw = {"complex_as_real": True}
    else:
        p = _cores(g, torch.float32, 0)
        t_opt, j_opt = sgdg(1e-2, momentum=0.9), j_sgdg(1e-2, momentum=0.9)
        kw = {"dtype": torch.float32}
    mask = np.ones(g.ncores, np.float32)
    tmask = mask.copy()
    tmask[2] = 0.0
    fit = make_masked_network_fidelity_fit(g, t_opt, max_steps=steps, tol=1e-3, mesh=mesh,
                                           jit_scope="chunk", sync_every=10, device="cpu", **kw)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    res = fit(tp, torch.as_tensor(mask), tp, torch.as_tensor(tmask))
    j_kw = {"complex_as_real": True} if form == "pair" else {"dtype": jnp.float32}
    j_fit = j_net_fit(jg, j_opt, max_steps=steps, tol=1e-3, mesh=jmesh, jit_scope="chunk",
                      sync_every=10, **j_kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    j_res = j_fit(jp, jnp.asarray(mask), jp, jnp.asarray(tmask))
    assert res.steps == int(j_res.steps)
    np.testing.assert_allclose(float(res.infidelity), float(j_res.infidelity),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ports of JAX's own cases, against the port's unsliced functions
# ---------------------------------------------------------------------------

def _wall(nq, nc):
    return parse_graph(incidence_to_graph(build_brick_wall_incidence(nq, nc)))


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"model": 8}, devices=["cpu"] * 8)


def test_with_bond_ranks_slices_exactly_the_chosen_bonds():
    """``TestWithBondRanks``: the sliced graph keeps the topology, changes
    two axes per bond and still takes the row sweep."""
    g = _wall(6, 3)
    bonds = choose_slice_bonds(g, 8, prefer_early_rows=True)
    gs = with_bond_ranks(g, {b: 1 for b in bonds})
    assert same_topology(gs, g) and gs.signature != g.signature
    changed = sum(sa != sb for ca, cb in zip(gs.cores, g.cores)
                  for sa, sb in zip(ca.shape, cb.shape))
    assert changed == 2 * len(bonds)
    g8 = _wall(8, 3)
    b8 = choose_slice_bonds(g8, 8, prefer_early_rows=True)
    assert supports_row_scan(with_bond_ranks(g8, {b: 1 for b in b8}), g8)


def test_sliced_log_matches_generic_and_its_gradient(mesh8):
    """``TestSlicedLogOverlap``: 6 × 3 wall over 8 positions, ⟨a,b⟩ and
    ⟨a,a⟩ against the unsliced executor, and the gradient."""
    g = _wall(6, 3)
    pa = init_params(g, 0, torch.float32, device="cpu")
    pb = init_params(g, 1, torch.float32, device="cpu")
    f, ref = tmp.make_sliced_log_overlap_fn(g, mesh8), make_log_abs_overlap_fn(g)
    np.testing.assert_allclose(float(f(pa, pb)), float(ref(pa, pb)), rtol=1e-5)
    np.testing.assert_allclose(float(f(pa, pa)), float(ref(pa, pa)), rtol=1e-5)
    p_np = params_to_numpy(pa)
    _, ga = _t_grad(lambda p: f(p, pb), p_np)
    _, gb = _t_grad(lambda p: ref(p, pb), p_np)
    for k in ga:
        np.testing.assert_allclose(ga[k], gb[k], atol=2e-5)
    # the complex wall, sliced over 8 positions
    g4 = _wall(4, 2)
    ca = init_params(g4, 0, torch.complex64, device="cpu")
    cb = init_params(g4, 2, torch.complex64, device="cpu")
    np.testing.assert_allclose(float(tmp.make_sliced_log_overlap_fn(g4, mesh8)(ca, cb)),
                               float(make_log_abs_overlap_fn(g4)(ca, cb)), rtol=1e-5)


@pytest.mark.slow
def test_f32_safe_at_26q_where_raw_sliced_overflows(mesh8):
    """The raw sliced overlap under/overflows float32 at 26 qubits (cores
    x2: the overlap x2^(2·75)); the log form stays finite and matches the
    unsliced row sweep."""
    g = _wall(26, 3)
    pa = {k: 2.0 * v for k, v in init_params(g, 0, torch.float32, device="cpu").items()}
    pb = {k: 2.0 * v for k, v in pa.items()}
    raw = float(tmp.make_sliced_two_network_fn(g, g, mesh8)(pa, pb))
    assert not np.isfinite(raw) or raw == 0.0
    a = float(tmp.make_sliced_log_overlap_fn(g, mesh8)(pa, pb))
    assert np.isfinite(a)
    np.testing.assert_allclose(a, float(make_row_scan_log_overlap_fn(g)(pa, pb)), rtol=1e-5)


@pytest.mark.parametrize("form", ["float32", "pair"])
def test_masked_fit_with_mesh_matches_single_device(mesh8, form):
    """``TestMeshedNetworkFit``: the mesh-sliced masked fit reproduces the
    unsliced fit (same steps, 1 − F at rtol 1e-3)."""
    if form == "pair":
        g = _wall(4, 2)
        p = {k: to_pair(v) for k, v in init_params(g, 0, torch.complex64, device="cpu").items()}
        opt, kw, steps = (lambda: pair_sgdg(1e-2, momentum=0.9)), {"complex_as_real": True}, 10
        core = 1
    else:
        g = _wall(6, 3)
        p = init_params(g, 0, torch.float32, device="cpu")
        opt, kw, steps = (lambda: sgdg(1e-2, momentum=0.9)), {"dtype": torch.float32}, 10
        core = 2
    mask = torch.ones(g.ncores)
    tmask = mask.clone()
    tmask[core] = 0.0
    results = {}
    for name, mkw in (("single", {}), ("mesh", {"mesh": mesh8})):
        fit = make_masked_network_fidelity_fit(g, opt(), max_steps=steps, tol=1e-3,
                                               jit_scope="chunk", sync_every=10,
                                               device="cpu", **kw, **mkw)
        res = fit(p, mask, p, tmask)
        results[name] = (float(res.infidelity), res.steps)
    assert results["single"][1] == results["mesh"][1]
    np.testing.assert_allclose(results["single"][0], results["mesh"][0], rtol=1e-3, atol=1e-5)


def test_pair_sliced_matches_pair_unsliced_with_gradient(mesh8):
    g = _wall(6, 3)
    pa = {k: to_pair(v) for k, v in init_params(g, 0, torch.complex64, device="cpu").items()}
    pb = {k: to_pair(v) for k, v in init_params(g, 1, torch.complex64, device="cpu").items()}
    f, ref = tmp.make_sliced_log_overlap_fn(g, mesh8, pair=True), make_pair_log_abs_overlap_fn(g)
    np.testing.assert_allclose(float(f(pa, pb)), float(ref(pa, pb)), rtol=1e-5, atol=1e-5)
    p_np = params_to_numpy(pa)
    _, ga = _t_grad(lambda p: f(p, pb), p_np)
    _, gb = _t_grad(lambda p: ref(p, pb), p_np)
    for k in ga:
        np.testing.assert_allclose(ga[k], gb[k], atol=3e-5)


def test_mesh_fit_lanes_in_one_process(mesh8):
    """In one process a mesh-sliced fit runs lanes (``fit.batched``) as the
    unsliced one does."""
    g = _wall(4, 2)
    p = init_params(g, 0, torch.float32, device="cpu")
    masks = torch.ones((2, g.ncores))
    masks[1, 3] = 0.0
    out = {}
    for name, mkw in (("single", {}), ("mesh", {"mesh": mesh8})):
        fit = make_masked_network_fidelity_fit(g, sgdg(1e-2, momentum=0.9), max_steps=4,
                                               tol=1e-3, dtype=torch.float32, sync_every=4,
                                               device="cpu", **mkw)
        out[name] = fit.batched(p, masks, p, masks[1]).infidelity.numpy()
    np.testing.assert_allclose(out["mesh"], out["single"], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def wall_cx():
    g = parse_graph(wall_graph(4, layers=2, dim=2))
    return g, init_params(g, 0, torch.complex64, device="cpu")


def _wall_measures(g, seed, n):
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, g.nqubits)),
                        dtype=torch.float32)
    mx = measurement_matrices(x, 2).to(torch.complex64)
    return [mx[:, q] for q in range(g.nqubits)]


def test_choose_slice_bonds_counts(wall_cx):
    """``TestSlicedModelParallel::test_choose_slice_bonds``."""
    g, _ = wall_cx
    assert len(choose_slice_bonds(g, 2)) == 1
    assert choose_slice_bonds(g, 1) == ()
    assert len(choose_slice_bonds(g, 4)) == 2


def test_padded_slicing_matches_unsliced():
    """A rank-3 bond over a 2-position model axis: slice space padded 3 -> 4."""
    g = parse_graph(mps_graph(3, dim=3))
    params = init_params(g, 7, torch.complex64, device="cpu")
    mesh = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(4, 3)), dtype=torch.float32)
    mx = measurement_matrices(x, 3).to(torch.complex64)
    measures = [mx[:, q] for q in range(3)]
    states = basis_states(g, dtype=torch.complex64, device="cpu")
    full = make_siamese_fn(g)(params, states, measures)
    got = make_sliced_siamese_fn(g, mesh)(params, states, measures)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("model_size", [2, 4])
def test_sliced_matches_unsliced(wall_cx, model_size):
    g, params = wall_cx
    mesh = make_mesh({"data": 8 // model_size, "model": model_size}, devices=["cpu"] * 8)
    measures = _wall_measures(g, 1, 8)
    states = basis_states(g, dtype=torch.complex64, device="cpu")
    full = make_siamese_fn(g)(params, states, measures)
    got = make_sliced_siamese_fn(g, mesh)(params, states, measures)
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


def test_sliced_is_differentiable(wall_cx):
    g, params = wall_cx
    mesh = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    measures = _wall_measures(g, 2, 4)
    states = basis_states(g, dtype=torch.complex64, device="cpu")
    sliced, full = make_sliced_siamese_fn(g, mesh), make_siamese_fn(g)
    p_np = params_to_numpy(params)
    _, g_s = _t_grad(lambda p: nll_loss(abs_square(sliced(p, states, measures))), p_np)
    _, g_f = _t_grad(lambda p: nll_loss(abs_square(full(p, states, measures))), p_np)
    for n in g_s:
        np.testing.assert_allclose(g_s[n], g_f[n], atol=1e-4)


def test_sliced_two_network_matches_unsliced_with_gradient():
    """``TestSlicedTwoNetwork``: value and the gradient of |⟨p1,p2⟩|²."""
    g = parse_graph(wall_graph(4, layers=2, dim=2))
    mesh = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    p1 = init_params(g, 0, torch.complex64, device="cpu")
    p2 = init_params(g, 1, torch.complex64, device="cpu")
    full = complex(make_two_network_fn(g, g, conj_target=True)(p1, p2))
    sliced = complex(tmp.make_sliced_two_network_fn(g, g, mesh)(p1, p2))
    assert abs(full - sliced) < 1e-5 * max(1.0, abs(full))
    fn_s = tmp.make_sliced_two_network_fn(g, g, mesh)
    fn_f = make_two_network_fn(g, g, conj_target=True)
    q1 = init_params(g, 2, torch.complex64, device="cpu")
    q2 = init_params(g, 3, torch.complex64, device="cpu")
    _, g_s = _t_grad(lambda p: abs_square(fn_s(p, q2)), params_to_numpy(q1))
    _, g_f = _t_grad(lambda p: abs_square(fn_f(p, q2)), params_to_numpy(q1))
    for n in g_s:
        np.testing.assert_allclose(g_s[n], g_f[n], rtol=1e-3, atol=1e-5)


def test_positions_on_two_devices_need_the_rank_form():
    """One process runs its positions on one device; a mesh over two
    devices names the rank form."""
    g = parse_graph(wall_graph(4, layers=2, dim=2))
    mesh = make_mesh({"model": 2}, devices=["cpu", "meta"])
    for build in (lambda: make_sliced_siamese_fn(g, mesh),
                  lambda: tmp.make_sliced_log_overlap_fn(g, mesh),
                  lambda: tmp.make_sliced_two_network_fn(g, g, mesh)):
        with pytest.raises(ValueError, match="rank form"):
            build()
