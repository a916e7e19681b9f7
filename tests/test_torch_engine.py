"""Port parity: the EngineSiamese facade (``tneq_tpu_torch.engine``) against
``tneq_tpu.engine``; one counterpart for each facade test of
``tests/test_engine.py``.

Both engines get the same numpy cores (the JAX ``QCTN`` and the port's are
built from one dict) and the same data.  Probabilities and losses: rtol
1e-4; gradients: 1e-4 of their largest entry, against the conjugate of
JAX's (torch's gradient of a real loss is the conjugate of ``jax.grad``'s,
ROADMAP §C).  Draws: from JAX's replayed uniforms, by JAX's bin-flip rule
(``tests/test_torch_infer.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.engine import EngineSiamese as JEngine
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.graph import wall_graph as j_wall
from tneq_tpu.model import QCTN as JQCTN
from tneq_tpu_torch.engine import EngineSiamese, _LRU
from tneq_tpu_torch.graph import mps_graph, parse_graph, wall_graph
from tneq_tpu_torch.infer import sample
from tneq_tpu_torch.infer.sampling import _sample_from_uniforms
from tneq_tpu_torch.model.qctn import QCTN, init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops.scaling import scaled_siamese_fn
from tneq_tpu_torch.train.trainer import basis_states

from test_torch_infer import assert_draws_agree, jax_uniforms

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """The 4-qubit, 2-layer wall (complex64) in both packages, from one
    numpy dict, with the basis states."""
    g, jg = parse_graph(wall_graph(4, layers=2, dim=2)), j_parse(j_wall(4, layers=2, dim=2))
    cores = params_to_numpy(init_params(g, 0, torch.complex64, device="cpu"))
    m = QCTN(g, params_from_numpy(cores, "cpu"), device="cpu")
    jm = JQCTN(jg, {k: jnp.asarray(v) for k, v in cores.items()})
    states = basis_states(g, device="cpu")
    return m, jm, states, [jnp.asarray(s.numpy()) for s in states]


def _x(seed, rows=4):
    return np.random.default_rng(seed).normal(size=(rows, 4)).astype(np.float32)


def _engines(**kw):
    return EngineSiamese(device="cpu", **kw), JEngine(**kw)


def _data(eng, jeng, x, K=2):
    mx, phi = eng.generate_data(x, K=K)
    jmx, _ = jeng.generate_data(jnp.asarray(x), K=K)
    return mx, phi, jmx


def test_generate_data():
    eng = EngineSiamese(device="cpu")
    mx_list, phi = eng.generate_data(np.zeros((5, 3)), K=4)
    assert len(mx_list) == 3 and mx_list[0].shape == (5, 4, 4)
    assert phi.shape == (5, 3, 4) and mx_list[0].dtype == torch.complex64


@pytest.mark.parametrize("mode", ["plain", "ret_scaled", "use_scaling"])
def test_contract_matches_jax(models, mode):
    m, jm, states, jstates = models
    eng, jeng = _engines(use_scaling=mode == "use_scaling")
    mx, _, jmx = _data(eng, jeng, _x(2))
    ret = "scaled" if mode == "ret_scaled" else "tensor"
    got = eng.contract_with_compiled_strategy(m, states, mx, ret_type=ret)
    want = jeng.contract_with_compiled_strategy(jm, jstates, jmx, ret_type=ret)
    if mode == "ret_scaled":
        (got, logs), (want, jlogs) = got, want
        np.testing.assert_allclose(float(logs), float(jlogs), rtol=RTOL)
    assert got.shape == (4,) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_contract_scaled_matches_plain(models):
    m, _, states, _ = models
    eng = EngineSiamese(use_scaling=True, device="cpu")
    mx, _ = eng.generate_data(_x(2, 3), K=2)
    p_scaled = eng.contract_with_compiled_strategy(m, states, mx)
    p_plain = EngineSiamese(device="cpu").contract_with_compiled_strategy(m, states, mx)
    torch.testing.assert_close(p_scaled, p_plain, rtol=1e-3, atol=0)


def test_scaled_avoids_overflow():
    """Cores ×1e4 overflow float32 in the plain contraction; the scaled one
    stays finite with its log-scale beside it."""
    g = parse_graph(wall_graph(4, layers=4, dim=2))
    big = {k: v * 1e4 for k, v in init_params(g, 1, torch.float32, device="cpu").items()}
    states = basis_states(g, dtype=torch.float32, device="cpu")
    eng = EngineSiamese(dtype=torch.float32, device="cpu")
    mx, _ = eng.generate_data(np.zeros((2, 4)), K=2)
    plain = eng.contract_with_compiled_strategy(QCTN(g, big, device="cpu"), states, mx)
    assert not bool(torch.isfinite(plain).all())
    raw, log_scale = scaled_siamese_fn(g)(big, states, mx)
    assert bool(torch.isfinite(raw).all()) and bool(torch.isfinite(log_scale))


@pytest.mark.parametrize("use_scaling", [False, True])
@pytest.mark.parametrize("ret", ["dict", "list"])
def test_gradient_matches_conj_jax(models, ret, use_scaling):
    m, jm, states, jstates = models
    eng, jeng = _engines(use_scaling=use_scaling)
    mx, _, jmx = _data(eng, jeng, _x(3))
    loss, grads = eng.contract_with_compiled_strategy_for_gradient(m, states, mx, ret=ret)
    jloss, jgrads = jeng.contract_with_compiled_strategy_for_gradient(jm, jstates, jmx,
                                                                      ret=ret)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    if ret == "dict":
        assert set(grads) == set(m.cores)
        pairs = [(grads[n], jgrads[n]) for n in m.cores]
    else:
        assert isinstance(grads, list) and len(grads) == m.ncores
        pairs = list(zip(grads, jgrads))
    scale = max(float(np.abs(np.asarray(j)).max()) for _, j in pairs)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.conj(np.asarray(want)), rtol=0,
                                   atol=RTOL * scale)


def test_gradient_list_form_follows_the_cores(models):
    m, _, states, _ = models
    eng = EngineSiamese(device="cpu")
    mx, _ = eng.generate_data(np.zeros((4, 4)), K=2)
    loss_d, gd = eng.contract_with_compiled_strategy_for_gradient(m, states, mx)
    loss_l, gl = eng.contract_with_compiled_strategy_for_gradient(m, states, mx, ret="list")
    assert float(loss_d) == float(loss_l)
    for name, g in zip(m.cores, gl):
        assert torch.equal(g, gd[name])


def test_gradient_cache(models):
    m, _, states, _ = models
    eng = EngineSiamese(device="cpu")
    mx, _ = eng.generate_data(np.zeros((4, 4)), K=2)
    eng.contract_with_compiled_strategy_for_gradient(m, states, mx)
    n = len(eng._grad_cache)
    eng.contract_with_compiled_strategy_for_gradient(m, states, mx)
    assert len(eng._grad_cache) == n == 1


def test_probabilities_match_jax(models):
    m, jm, _, _ = models
    eng, jeng = _engines()
    B = 3
    s0 = np.broadcast_to(np.array([1.0, 0.0], np.complex64), (B, 2))
    proj = np.broadcast_to(np.array([[1.0, 0.0], [0.0, 0.0]], np.complex64), (B, 2, 2))
    st, pt = [torch.as_tensor(s0.copy())] * 4, torch.as_tensor(proj.copy())
    jst, jpr = [jnp.asarray(s0)] * 4, jnp.asarray(proj)
    cases = [
        (eng.calculate_full_probability(m, st, [pt] * 4),
         jeng.calculate_full_probability(jm, jst, [jpr] * 4)),
        (eng.calculate_marginal_probability(m, st, [pt], [0]),
         jeng.calculate_marginal_probability(jm, jst, [jpr], [0])),
        (eng.calculate_conditional_probability(m, st, [pt] * 4, [0, 1, 2, 3], [3]),
         jeng.calculate_conditional_probability(jm, jst, [jpr] * 4, [0, 1, 2, 3], [3])),
    ]
    for got, want in cases:
        assert got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_sample_default_generator_is_seeded_zero(models):
    m, _, states, _ = models
    eng = EngineSiamese(device="cpu")
    got = eng.sample(m, states, 8, 2, grid_size=32)
    want = sample(m.graph, m.params, states, 8, 2, torch.Generator().manual_seed(0),
                  grid_size=32)
    assert got.shape == (8, 4) and torch.equal(got, want)
    other = eng.sample(m, states, 8, 2, grid_size=32,
                       generator=torch.Generator().manual_seed(1))
    assert not torch.equal(got, other)


def test_sample_matches_jax_from_its_uniforms(models):
    """The engine's default grid (1000) on the wall: the generic env
    sampler, from JAX's key schedule of ``PRNGKey(0)``."""
    m, jm, states, jstates = models
    _, jeng = _engines()
    want = np.asarray(jeng.sample(jm, jstates, 32, 2))
    us = jax_uniforms(jax.random.PRNGKey(0), 4, 32)
    got = _sample_from_uniforms(m.graph, m.params, states, 2, us, grid_size=1000)
    assert_draws_agree(got.numpy(), want, (-5.0, 5.0), 1000)


def test_vector_measure_matches_matrix(models):
    """``measure_is_matrix=False`` builds rank-1 operators from φ vectors."""
    m, _, states, _ = models
    eng = EngineSiamese(device="cpu")
    mx, phi = eng.generate_data(_x(5, 3), K=2)
    phi_list = [phi[:, q] for q in range(4)]
    p_vec = eng.contract_with_compiled_strategy(m, states, phi_list, measure_is_matrix=False)
    p_mat = eng.contract_with_compiled_strategy(m, states, mx)
    torch.testing.assert_close(p_vec, p_mat, rtol=1e-4, atol=0)
    loss_v, _ = eng.contract_with_compiled_strategy_for_gradient(
        m, states, phi_list, measure_is_matrix=False)
    loss_m, _ = eng.contract_with_compiled_strategy_for_gradient(m, states, mx)
    np.testing.assert_allclose(float(loss_v), float(loss_m), rtol=1e-4)


def test_engine_with_mesh_raises(models):
    """``mesh=`` routes the contraction through the bond-sliced strategy:
    the same probabilities as JAX's engine on its own 2-device mesh and as
    the port's ``mesh=None`` (1e-5 of the batch's largest), the scaled path
    unchanged; a mesh over two devices raises, naming the rank form."""
    from tneq_tpu.parallel import make_mesh as j_make_mesh
    from tneq_tpu_torch.parallel import make_mesh

    m, jm, states, jstates = models
    eng = EngineSiamese(device="cpu", mesh=make_mesh({"data": 1, "model": 2},
                                                     devices=["cpu"] * 2))
    jeng = JEngine(mesh=j_make_mesh({"data": 1, "model": 2}, devices=jax.devices()[:2]))
    mx, _, jmx = _data(eng, jeng, _x(11, 6))
    got = eng.contract_with_compiled_strategy(m, states, mx)
    ref = np.asarray(jeng.contract_with_compiled_strategy(jm, jstates, jmx))
    plain = EngineSiamese(device="cpu").contract_with_compiled_strategy(m, states, mx)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    scaled = eng.contract_with_compiled_strategy(m, states, mx, ret_type="scaled")
    torch.testing.assert_close(scaled[0] * torch.exp(scaled[1]), plain, rtol=1e-4, atol=0)
    two = EngineSiamese(device="cpu", mesh=make_mesh({"model": 2}, devices=["cpu", "meta"]))
    with pytest.raises(ValueError, match="rank form"):
        two.contract_with_compiled_strategy(m, states, mx)


def test_compiled_closure_caches_are_lru_bounded():
    eng = EngineSiamese(dtype=torch.float32, cache_size=3, device="cpu")
    g = parse_graph(mps_graph(2, dim=2))
    model = QCTN(g, init_params(g, 0, torch.float32, device="cpu"), device="cpu")
    states = basis_states(g, dtype=torch.float32, device="cpu")
    for b in (1, 2, 3, 4, 5):  # 5 batch shapes -> 5 keys, bounded at 3
        mx = torch.ones((b, 2, 2))
        eng.contract_with_compiled_strategy(model, states, [mx, mx])
    assert len(eng._fwd_cache) == 3


def test_lru_evicts_the_least_recent():
    lru = _LRU(2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1  # a is now the most recent
    lru.put("c", 3)
    assert lru.get("b") is None and lru.get("a") == 1 and lru.get("c") == 3
    assert len(lru) == 2
