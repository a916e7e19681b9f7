"""Port parity: inference (``tneq_tpu_torch.infer``: full, marginal and
conditional probabilities, the generic inverse-CDF sampler and the MPS
chain sampler) against ``tneq_tpu.infer``.

Cores, states, data and operators are drawn in numpy and handed to both
packages.  Probabilities are held at rtol 1e-4.  Random draws: JAX splits
one key per qubit and draws ``uniform(subkey, (S, 1))``; the tests replay
that schedule to get JAX's exact uniforms ``us [nq, S, 1]`` and feed them to
the port's ``_sample_from_uniforms`` / ``_chain_sample_from_uniforms``.
Draws across packages are held by JAX's own rule
(``tests/test_infer.py::test_fused_sweep_matches_per_site``): each sample
row is identical, or first differs by less than 4 grid bins (a last-ulp CDF
difference at a bin boundary), and at least 3/4 of the rows are identical
end to end.  Inside the port the same math on the same device gives
identical draws.  The 16- and 30-qubit cases run the port alone, as JAX's
``TestLargeNInference`` does.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import mps_graph as j_mps
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.graph import wall_graph as j_wall
from tneq_tpu.graph.dsl import CircuitGraph as JGraph
from tneq_tpu.graph.dsl import CoreSpec as JCore
from tneq_tpu.graph.dsl import Edge as JEdge
from tneq_tpu.infer import chain_sampling as jcs
from tneq_tpu.infer import conditional_probability as j_cond
from tneq_tpu.infer import full_probability as j_full
from tneq_tpu.infer import marginal_probability as j_marg
from tneq_tpu.infer import sample as j_sample
from tneq_tpu.infer import sampling as jsm
from tneq_tpu.ops.contract import make_siamese_env_fn as j_env_fn
from tneq_tpu_torch.graph import mps_graph, parse_graph, wall_graph
from tneq_tpu_torch.graph.dsl import CircuitGraph, CoreSpec, Edge
from tneq_tpu_torch.infer import (
    conditional_probability,
    full_probability,
    marginal_probability,
    sample,
)
from tneq_tpu_torch.infer import chain_sampling as tcs
from tneq_tpu_torch.infer import sampling as tsm
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops.contract import execute
from tneq_tpu_torch.ops.features import generate_data, measurement_matrices
from tneq_tpu_torch.train.trainer import basis_states

torch.set_num_threads(1)

RTOL = 1e-4
JDT = {torch.float32: jnp.float32, torch.complex64: jnp.complex64}
GRAPHS = {"wall4x2": lambda m: m.wall_graph(4, layers=2, dim=2),
          "mps5d3": lambda m: m.mps_graph(5, dim=3)}


class _Gen:
    wall_graph, mps_graph = staticmethod(j_wall), staticmethod(j_mps)


class _TGen:
    wall_graph, mps_graph = staticmethod(wall_graph), staticmethod(mps_graph)


def _graphs(name):
    return parse_graph(GRAPHS[name](_TGen)), j_parse(GRAPHS[name](_Gen))


def _cores(g, seed, dtype):
    return params_to_numpy(init_params(g, seed, dtype, device="cpu"))


def _jx(seq):
    if isinstance(seq, dict):
        return {k: jnp.asarray(v) for k, v in seq.items()}
    return [jnp.asarray(np.asarray(v)) for v in seq]


def _np(seq):
    return [np.asarray(v) for v in seq]


def jax_uniforms(key, nq, S):
    """JAX's per-qubit draws of ``sample``/``chain_sample``: one split per
    qubit, ``uniform(subkey, (S, 1))``."""
    us = []
    for _ in range(nq):
        key, sub = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(sub, (S, 1), jnp.float32)))
    return torch.as_tensor(np.stack(us))


def assert_draws_agree(a, b, bounds, G):
    """JAX's bin-flip rule: a row is identical, or first differs by less
    than 4 grid bins; at least 3/4 of the rows identical end to end."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    bin_w = (bounds[1] - bounds[0]) / (G - 1)
    n_ident = 0
    for ra, rb in zip(a, b):
        diff = np.nonzero(ra != rb)[0]
        if diff.size == 0:
            n_ident += 1
            continue
        j = diff[0]
        assert abs(ra[j] - rb[j]) < 4 * bin_w, (j, ra[j], rb[j])
    assert n_ident >= len(a) * 3 // 4, f"only {n_ident}/{len(a)} rows identical"


@pytest.fixture(scope="module")
def problems():
    """Per (graph, dtype): the graphs, numpy cores, basis states and a
    batch of 4 measurement operators per qubit, shared by the probability
    cases."""
    out = {}
    for name in GRAPHS:
        g, jg = _graphs(name)
        K = g.output_ranks[0]
        x = np.random.default_rng(0).normal(size=(4, g.nqubits)).astype(np.float32)
        for dtype in (torch.float32, torch.complex64):
            mx, _ = generate_data(torch.as_tensor(x), K, dtype=dtype)
            states = basis_states(g, dtype=dtype, device="cpu")
            out[name, dtype] = (g, jg, _cores(g, 0, dtype), _np(states), _np(mx))
    return out


# ---------------------------------------------------------------------------
# probabilities
# ---------------------------------------------------------------------------

_KINDS = {
    # kind: (port call, JAX call), each fn(graph, params, states, measures)
    "full": (lambda g, p, s, m: full_probability(g, p, s, m),
             lambda g, p, s, m: j_full(g, p, s, m)),
    "log_full": (lambda g, p, s, m: full_probability(g, p, s, m, log=True),
                 lambda g, p, s, m: j_full(g, p, s, m, log=True)),
    "marginal": (lambda g, p, s, m: marginal_probability(g, p, s, [m[0], m[2]], [0, 2]),
                 lambda g, p, s, m: j_marg(g, p, s, [m[0], m[2]], [0, 2])),
    "conditional": (
        lambda g, p, s, m: conditional_probability(g, p, s, m[:3], [0, 1, 2], [1],
                                                   rescale=False),
        lambda g, p, s, m: j_cond(g, p, s, m[:3], [0, 1, 2], [1], rescale=False)),
    "conditional_rescaled": (
        lambda g, p, s, m: conditional_probability(g, p, s, m[:3], [0, 1, 2], [1],
                                                   rescale=True),
        lambda g, p, s, m: j_cond(g, p, s, m[:3], [0, 1, 2], [1], rescale=True)),
}


@pytest.fixture(scope="module")
def jax_probabilities(problems):
    """JAX's value of every kind at each (graph, dtype), all kinds in one
    jitted program per problem (one compile, not one per kind)."""
    cache = {}

    def get(graph, dtype):
        if (graph, dtype) not in cache:
            _, jg, cores, states, mx = problems[graph, dtype]
            fn = jax.jit(lambda *a: {k: ref(jg, *a) for k, (_, ref) in _KINDS.items()})
            cache[graph, dtype] = {k: np.asarray(v) for k, v in
                                   fn(_jx(cores), _jx(states), _jx(mx)).items()}
        return cache[graph, dtype]

    return get


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("kind", list(_KINDS))
def test_probability_matches_jax(problems, jax_probabilities, kind, graph, dtype):
    g, _, cores, states, mx = problems[graph, dtype]
    got = _KINDS[kind][0](g, params_from_numpy(cores, "cpu"),
                          [torch.as_tensor(s) for s in states],
                          [torch.as_tensor(m) for m in mx])
    want = jax_probabilities(graph, dtype)[kind]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _two_qubit(dtype, batch=4):
    g = parse_graph("-2-A-2-\n-2-B-2-")
    p = init_params(g, 0, dtype, device="cpu")
    s0 = torch.tensor([1.0, 0.0], dtype=dtype).expand(batch, 2)
    proj0 = torch.tensor([[1.0, 0.0], [0.0, 0.0]], dtype=dtype).expand(batch, 2, 2)
    return g, p, [s0, s0], proj0


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
def test_projector_marginal_sums_to_one(dtype):
    """Over a complete projector basis of qubit 0 the siamese values sum to
    the norm, 1 (unitary cores, normalised states): P itself for real
    dtypes, √P for complex ones (P = |value|²)."""
    g, p, states, _ = _two_qubit(dtype)
    total = torch.zeros(4, dtype=torch.float64)
    for k in range(2):
        pk = torch.zeros(2, 2, dtype=dtype)
        pk[k, k] = 1.0
        pm = marginal_probability(g, p, states, [pk.expand(4, 2, 2)], [0])
        total += (pm.sqrt() if dtype.is_complex else pm).double()
    np.testing.assert_allclose(total.numpy(), np.ones(4), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
def test_conditional_identity(dtype):
    """P(q1=0 | q0=0) == P(00) / P(q0=0) to atol 1e-5 (the reference's main
    assertion)."""
    g, p, states, proj = _two_qubit(dtype)
    p00 = full_probability(g, p, states, [proj, proj])
    pq0 = marginal_probability(g, p, states, [proj], [0])
    cond = conditional_probability(g, p, states, [proj, proj], [0, 1], [1])
    torch.testing.assert_close(cond, p00 / (pq0 + 1e-10), atol=1e-5, rtol=0)


def test_full_probability_matches_dense():
    g, p, states, proj = _two_qubit(torch.complex64)
    from tneq_tpu_torch.ops.contract import make_with_inputs_fn

    got = full_probability(g, p, states, [proj, proj])
    psi = make_with_inputs_fn(g, batched=False)(p, [s[0] for s in states]).numpy()
    pr = proj[0].numpy()
    val = np.einsum("ab,ac,bd,cd->", psi, pr, pr, psi.conj())
    np.testing.assert_allclose(got.numpy(), np.abs(val) ** 2 * np.ones(4), rtol=1e-4)


@pytest.mark.parametrize("case", ["marginal_lengths", "conditional_lengths",
                                  "conditional_targets"])
def test_probability_value_errors(case):
    g, p, states, proj = _two_qubit(torch.complex64)
    with pytest.raises(ValueError):
        if case == "marginal_lengths":
            marginal_probability(g, p, states, [proj], [0, 1])
        elif case == "conditional_lengths":
            conditional_probability(g, p, states, [proj], [0, 1], [0])
        else:
            conditional_probability(g, p, states, [proj], [0], [1])


def _big_chain(n, scale):
    g = parse_graph(mps_graph(n, dim=2))
    p = {k: scale * v for k, v in init_params(g, 0, torch.float32, device="cpu").items()}
    return g, p, basis_states(g, dtype=torch.float32, device="cpu")


def test_log_probability_finite_at_30_qubits():
    """Cores ×16 at 30 qubits: P overflows float32, log P through the
    rescaled executor stays finite."""
    g, p, states = _big_chain(30, 16.0)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 30)).astype(np.float32))
    mx, _ = generate_data(x, 2, dtype=torch.float32)
    logp = full_probability(g, p, states, mx, log=True)
    assert bool(torch.isfinite(logp).all())
    assert not bool(torch.isfinite(full_probability(g, p, states, mx)).all())


def test_conditional_rescales_from_16_qubits():
    """``rescale=None`` turns the rescaled executor on from 16 qubits; the
    shared scale cancels, so it equals the plain contraction where that is
    representable (cores unscaled)."""
    g, p, states = _big_chain(16, 1.0)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    mx, _ = generate_data(x, 2, dtype=torch.float32)
    auto = conditional_probability(g, p, states, mx[:4], [0, 1, 2, 3], [0])
    plain = conditional_probability(g, p, states, mx[:4], [0, 1, 2, 3], [0], rescale=False)
    assert bool(torch.isfinite(auto).all())
    torch.testing.assert_close(auto, plain, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# samplers: the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("graph,dtype", [("wall4x2", torch.complex64),
                                         ("mps5d3", torch.float32)])
def test_env_and_grid_density_match_jax(problems, graph, dtype, rescale):
    """Each qubit's environment under random sampled operators on the
    others, and its [S, G] grid density, against JAX's (rescaled: up to
    the scale, which cancels in the CDF)."""
    g, jg, cores, states, _ = problems[graph, dtype]
    K, S, G = g.output_ranks[0], 6, 40
    y = np.random.default_rng(2).normal(size=(S, g.nqubits)).astype(np.float32)
    meas = _np(measurement_matrices(torch.as_tensor(y), K).to(dtype).unbind(1))
    gx = np.linspace(-5, 5, G, dtype=np.float32)
    mg = measurement_matrices(torch.as_tensor(gx)[:, None], K)[:, 0].to(dtype)
    pt, st = params_from_numpy(cores, "cpu"), [torch.as_tensor(s) for s in states]
    mt = [torch.as_tensor(m) for m in meas]
    # JAX's envs of every qubit as one program (one compile)
    jenvs = jax.jit(lambda *a: [j_env_fn(jg, q, rescale=rescale)(*a)
                                for q in range(g.nqubits)])(_jx(cores), _jx(states), _jx(meas))
    for q, jenv in enumerate(jenvs):
        env = tsm._env_fn(g, q, rescale)(pt, st, mt)
        if rescale:
            (env, logs), (jenv, jlogs) = env, jenv
            env = env * torch.exp(logs - float(jlogs)).to(env.dtype)
        jenv = np.asarray(jenv)
        np.testing.assert_allclose(env.numpy(), jenv, rtol=RTOL, atol=RTOL * np.abs(jenv).max())
        dens = execute("skl,gkl->sg", [env, mg]).numpy()
        jdens = np.einsum("skl,gkl->sg", jenv, mg.numpy())
        np.testing.assert_allclose(dens, jdens, rtol=RTOL, atol=RTOL * np.abs(jdens).max())


def _noncanonical():
    """is_mps_chain admits it (head core with boundary outs on both its
    qubits) but the sweep cannot canonicalise it."""
    def build(C, E, G):
        a = C(0, "a", (E(0, 2), E(1, 2)), (E(0, 2), E(1, 2), E(1, 3, neighbor=1)))
        b = C(1, "b", (E(1, 3, neighbor=0), E(2, 2)), (E(1, 2), E(2, 2)))
        return G(nqubits=3, cores=(a, b))

    return build(CoreSpec, Edge, CircuitGraph), build(JCore, JEdge, JGraph)


@pytest.mark.parametrize("graph", ["mps6d3", "mps5d2p3", "noncanonical"])
def test_chain_plan_and_site_tensors_match_jax(graph):
    if graph == "noncanonical":
        g, jg = _noncanonical()
        assert tcs._chain_plan(g) is None and jcs._chain_plan(jg) is None
        assert not tcs.supports_chain_sampling(g) and not jcs.supports_chain_sampling(jg)
        return
    args = (6, 3, None) if graph == "mps6d3" else (5, 2, 3)
    g, jg = parse_graph(mps_graph(*args)), j_parse(j_mps(*args))
    assert tcs._chain_plan(g) == [(list(s), list(o)) for s, o in jcs._chain_plan(jg)]
    assert tcs.supports_chain_sampling(g) and jcs.supports_chain_sampling(jg)
    cores = _cores(g, 0, torch.complex64)
    rng = np.random.default_rng(3)
    states = [(rng.normal(size=r) + 1j * rng.normal(size=r)).astype(np.complex64)
              for r in g.input_ranks]
    sites = tcs._site_tensors(g, params_from_numpy(cores, "cpu"),
                              [torch.as_tensor(s) for s in states])
    jsites = jcs._site_tensors(jg, _jx(cores), _jx(states))
    assert len(sites) == len(jsites)
    for s, js in zip(sites, jsites):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("module", ["generic", "chain"])
def test_density_power_2_order_matches_jax(module):
    """``density_power=2``: the generic sampler squares, then clips; the
    chain sampler clips, then squares.  They differ where the density is
    negative, which an indefinite operator makes happen: on another qubit
    (generic) or in the left environment (chain).  Each module follows its
    JAX counterpart draw for draw, and the other order gives other draws."""
    S, G, K = 16, 50, 2
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    u = torch.as_tensor(np.array(jax.random.uniform(sub, (S, 1), jnp.float32)))
    gx = torch.as_tensor(np.linspace(-5, 5, G, dtype=np.float32))
    mg = measurement_matrices(gx[:, None], K)[:, 0]
    jmg, jgx = jnp.asarray(mg.numpy()), jnp.asarray(gx.numpy())
    if module == "generic":
        g, jg = parse_graph(mps_graph(3, dim=2)), j_parse(j_mps(3, dim=2))
        cores = _cores(g, 0, torch.float32)
        states = _np(basis_states(g, dtype=torch.float32, device="cpu"))
        eye = np.broadcast_to(np.eye(2, dtype=np.float32), (S, 2, 2))
        indef = np.broadcast_to(np.array([[1.0, 2.0], [2.0, -1.0]], np.float32), (S, 2, 2))
        pers = np.stack([eye, indef, eye])
        pt, st = params_from_numpy(cores, "cpu"), [torch.as_tensor(s) for s in states]
        mt = [torch.as_tensor(m.copy()) for m in pers]
        step = jsm._env_step_program(jg, 0, False, S, G, K, 2, "float32")
        jy, _ = step(_jx(cores), tuple(_jx(states)), jnp.asarray(pers), sub, jmg, jgx)
        y, _ = tsm._qubit_step(g, 0, False, pt, st, mt, mg, gx, u, 2, torch.float32)
        dens = execute("skl,gkl->sg", [tsm._env_fn(g, 0, False)(pt, st, mt), mg])
        other = tcs._invert_cdf(dens.clamp(min=0.0) ** 2, gx, u)  # the chain's order
    else:
        L = np.random.default_rng(4).normal(size=(S, K, K)).astype(np.float32)
        jstep = jcs._step_programs(S, G, K, 2, "float32")[3]
        jy = jstep(jnp.asarray(L), jmg, jgx, sub)
        y = tcs._step_bodies(S, K, 2, torch.float32)[4](torch.as_tensor(L), mg, gx, u)
        dens = execute("spr,gpr->sg", [torch.as_tensor(L), mg])
        other = tcs._invert_cdf((dens * dens).clamp(min=0.0), gx, u)  # the generic's
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert bool((dens < 0).any())
    assert not torch.equal(other, y)


# ---------------------------------------------------------------------------
# samplers: draws against JAX from JAX's uniforms
# ---------------------------------------------------------------------------

# (graph args, dtype, path): generic = chain=False in both; chain = the
# sweep (JAX's per-site dispatch, fused=False); fused = JAX's one-program
# sweep (fused=True), which may flip a bin against its per-site path
_DRAWS = {
    "generic-wall4x2-c64": ("wall", (4, 2, 2), torch.complex64, "generic"),
    "generic-mps6d3-f32": ("mps", (6, 3), torch.float32, "generic"),
    "chain-mps6d3-c64": ("mps", (6, 3), torch.complex64, "chain"),
    "chain-mps6d3-f32": ("mps", (6, 3), torch.float32, "chain"),
    "fused-mps10d2-f32": ("mps", (10, 2), torch.float32, "fused"),
}


def _draw_graphs(kind, args):
    if kind == "wall":
        n, layers, dim = args
        return (parse_graph(wall_graph(n, layers=layers, dim=dim)),
                j_parse(j_wall(n, layers=layers, dim=dim)))
    n, dim = args
    return parse_graph(mps_graph(n, dim=dim)), j_parse(j_mps(n, dim=dim))


@pytest.mark.parametrize("case", list(_DRAWS))
def test_draws_match_jax_from_its_uniforms(case):
    kind, args, dtype, path = _DRAWS[case]
    g, jg = _draw_graphs(kind, args)
    K, S, G, bounds = g.output_ranks[0], 32, 80, (-5.0, 5.0)
    cores = _cores(g, 0, dtype)
    states = _np(basis_states(g, dtype=dtype, device="cpu"))
    key = jax.random.PRNGKey(1)
    want = np.asarray(j_sample(jg, _jx(cores), _jx(states), S, K, key, grid_size=G,
                               dtype=JDT[dtype], chain=path != "generic",
                               fused=path == "fused"))
    us = jax_uniforms(key, g.nqubits, S)
    pt, st = params_from_numpy(cores, "cpu"), [torch.as_tensor(s) for s in states]
    if path == "generic":
        got = tsm._sample_from_uniforms(g, pt, st, K, us, grid_size=G, dtype=dtype)
    else:
        got = tcs._chain_sample_from_uniforms(g, pt, st, K, us, grid_size=G, dtype=dtype)
    assert got.shape == (S, g.nqubits) and got.dtype == torch.float32
    assert_draws_agree(got.numpy(), want, bounds, G)


def _chain_setup(n=6, dim=3, dtype=torch.float32, scale=1.0):
    g = parse_graph(mps_graph(n, dim=dim))
    p = {k: scale * v for k, v in init_params(g, 0, dtype, device="cpu").items()}
    return g, p, basis_states(g, dtype=dtype, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64], ids=["f32", "c64"])
def test_fused_equals_per_site_bit_for_bit(dtype):
    g, p, states = _chain_setup(8, 2, dtype)
    kw = dict(num_samples=32, K=2, grid_size=60, dtype=dtype)
    a = sample(g, p, states, generator=_gen(1), fused=True, **kw)
    b = sample(g, p, states, generator=_gen(1), fused=False, **kw)
    c = tcs.chain_sample(g, p, states, generator=_gen(1), **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, sample(g, p, states, generator=_gen(2), **kw))


def test_chain_true_forces_sweep_sampler():
    g, p, states = _chain_setup(5, 2)
    kw = dict(num_samples=8, K=2, grid_size=60, dtype=torch.float32)
    a = sample(g, p, states, generator=_gen(1), chain=True, **kw)
    b = sample(g, p, states, generator=_gen(1), chain=False, **kw)
    assert_draws_agree(a.numpy(), b.numpy(), (-5.0, 5.0), 60)


def test_noncanonical_chain_falls_back_to_generic():
    g, _ = _noncanonical()
    rng = np.random.default_rng(0)
    p = {c.name: torch.as_tensor(rng.normal(size=c.shape).astype(np.float32))
         for c in g.cores}
    states = [torch.ones(2) / np.sqrt(2.0)] * 3
    kw = dict(num_samples=4, K=2, grid_size=50, dtype=torch.float32)
    out = sample(g, p, states, generator=_gen(1), **kw)  # auto: generic fallback
    assert torch.equal(out, sample(g, p, states, generator=_gen(1), chain=False, **kw))
    with pytest.raises(ValueError, match="canonical MPS-chain"):
        sample(g, p, states, generator=_gen(1), chain=True, **kw)


def test_rescale_equals_dense_at_4_qubits():
    g, p, states = _chain_setup(4, 2)
    kw = dict(num_samples=64, K=2, grid_size=100, dtype=torch.float32, chain=False)
    dense = sample(g, p, states, generator=_gen(1), rescale=False, **kw)
    resc = sample(g, p, states, generator=_gen(1), rescale=True, **kw)
    torch.testing.assert_close(dense, resc, atol=1e-4, rtol=0)


def test_wrong_K_raises():
    g = parse_graph("-2-A-2-")
    p = init_params(g, 5, torch.complex64, device="cpu")
    with pytest.raises(ValueError):
        sample(g, p, [torch.tensor([1.0, 0.0])], 4, K=5, generator=_gen(0))


def test_sample_shapes_bounds_and_spread():
    g = parse_graph(wall_graph(4, layers=2, dim=2))
    p = init_params(g, 1, torch.complex64, device="cpu")
    out = sample(g, p, basis_states(g, device="cpu"), num_samples=64, K=2,
                 generator=_gen(2), bounds=(-4, 4), grid_size=64)
    assert out.shape == (64, 4) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= -4 and float(out.max()) <= 4
    assert float(out.std()) > 1e-3


def test_sample_statistics_match_density():
    """One qubit: the empirical mean of 2000 draws is the mean of the
    density on the grid."""
    g = parse_graph("-2-A-2-")
    p = init_params(g, 3, torch.complex64, device="cpu")
    state = [torch.tensor([1.0, 0.0], dtype=torch.complex64)]
    G = 201
    xs = np.linspace(-5, 5, G, dtype=np.float32)
    mx, _ = generate_data(torch.as_tensor(xs[:, None]), 2, dtype=torch.complex64)
    dens = full_probability(g, p, state, mx).numpy()
    mean_expected = float((xs * dens / dens.sum()).sum())
    s = sample(g, p, state, num_samples=2000, K=2, generator=_gen(4), grid_size=G)
    assert abs(float(s.mean()) - mean_expected) < 0.15


def test_12_qubits_at_grid_1000():
    g, p, states = _chain_setup(12, 2)
    out = sample(g, p, states, num_samples=256, K=2, generator=_gen(1), grid_size=1000,
                 dtype=torch.float32)
    assert out.shape == (256, 12) and bool(torch.isfinite(out).all())
    assert float(out.abs().max()) <= 5.0


def test_sample_16_qubits_auto_rescale():
    """The generic sampler at 16 qubits: the rescaled executor turns on,
    draws are finite, in bounds and spread."""
    g, p, states = _chain_setup(16, 2, scale=2.0)
    out = sample(g, p, states, num_samples=8, K=2, generator=_gen(1), grid_size=50,
                 dtype=torch.float32, chain=False)
    assert out.shape == (8, 16) and bool(torch.isfinite(out).all())
    assert float(out.abs().max()) <= 5.0
    assert len(np.unique(out.numpy().round(3))) > 4


def test_30_qubit_cdf_finite_and_normalised():
    """One qubit's rescaled environment at 30 qubits (cores ×8): the dense
    env overflows float32, the rescaled one gives finite, normalised,
    monotone CDFs."""
    g, p, states = _chain_setup(30, 2, scale=8.0)
    pers = [torch.eye(2).expand(8, 2, 2)] * 30
    assert not bool(torch.isfinite(tsm._env_fn(g, 15, False)(p, states, pers)).all())
    env, _ = tsm._env_fn(g, 15, True)(p, states, pers)
    assert bool(torch.isfinite(env).all())
    gx = torch.linspace(-5.0, 5.0, 50)
    mg = measurement_matrices(gx[:, None], 2)[:, 0]
    cdf = torch.cumsum(execute("skl,gkl->sg", [env, mg]).clamp(min=0.0), dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    assert bool(torch.isfinite(cdf).all())
    np.testing.assert_allclose(cdf[:, -1].numpy(), 1.0, atol=1e-5)
    assert bool((torch.diff(cdf, dim=1) >= -1e-6).all())


def test_30_qubit_chain_sampler_fast_and_finite():
    g, p, states = _chain_setup(30, 2, scale=8.0)
    t0 = time.time()
    out = sample(g, p, states, num_samples=32, K=2, generator=_gen(1), grid_size=100,
                 dtype=torch.float32)
    assert time.time() - t0 < 60
    assert out.shape == (32, 30) and bool(torch.isfinite(out).all())
    assert len(np.unique(out.numpy().round(3))) > 8
