"""Port parity: model-state sharding (tneq_tpu_torch.parallel.fsdp vs
tneq_tpu.parallel.fsdp), in one process.

Mirrors ``tests/test_fsdp.py``.  Inputs are drawn in numpy and handed to
both packages; JAX's FSDP step runs on its 8-device virtual CPU mesh, the
port's on 8 host positions (the stacks stay whole in one process; the rank
form is in ``tests/test_torch_parallel_ranks.py``).  Tolerances: stacked
SGD-G updates within rtol 1e-4, atol 1e-6 of JAX's and of the port's
per-core ``sgdg`` (JAX's own bound; complex gradients handed to the port
as the conjugate of JAX's), retraction off and forced; the FSDP step's
first loss within rtol 1e-4, atol 1e-5 of ``network_log_fidelity`` and of
JAX's step (a difference of O(1) log-overlaps); the identity padding
bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tneq_tpu.graph import mps_graph as j_mps
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.parallel import make_mesh as j_make_mesh
from tneq_tpu.parallel.fsdp import make_fsdp_network_fit_step as j_fsdp_step
from tneq_tpu.parallel.fsdp import stack_params as j_stack
from tneq_tpu.parallel.fsdp import stacked_sgdg as j_stacked_sgdg
from tneq_tpu_torch.graph import mps_graph, parse_graph
from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.optim.stiefel import sgdg
from tneq_tpu_torch.parallel import make_mesh
from tneq_tpu_torch.parallel.fsdp import (
    StackedParams,
    StackedSGDGState,
    group_shardings,
    make_fsdp_network_fit_step,
    shard_stacked,
    stack_params,
    stacked_sgdg,
    unstack_params,
)
from tneq_tpu_torch.train.network_fit import network_log_fidelity

torch.set_num_threads(1)


def _numpy_params(n, dim, seed, dtype=np.float32):
    """Orthogonal-ish numpy cores of ``mps_graph(n, dim)`` (QR of a
    Gaussian), the same draws for both packages."""
    g = parse_graph(mps_graph(n, dim=dim))
    rng = np.random.default_rng(seed)
    out = {}
    for c in g.cores:
        rows = int(np.prod(c.shape[: len(c.shape) // 2]))
        a = rng.normal(size=(int(np.prod(c.shape)) // rows, rows))
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.normal(size=a.shape)
        q = np.linalg.qr(a)[0].T.conj()
        out[c.name] = q.reshape(c.shape).astype(dtype)
    return g, out


def test_roundtrip():
    g = parse_graph(mps_graph(6, dim=4))
    params = init_params(g, 0, torch.float32, device="cpu")
    back = unstack_params(stack_params(g, params, pad_to=1))
    for n in params:
        assert torch.equal(back[n], params[n])


def test_padding_to_mesh_multiple_like_jax():
    """5 cores of one shape: padded with identity cores to a multiple of 4,
    as JAX pads them; a group smaller than ``pad_to`` stays unpadded."""
    g, p = _numpy_params(6, 4, 0)
    stacked = stack_params(g, params_from_numpy(p, "cpu"), pad_to=4)
    j_stacked = j_stack(j_parse(j_mps(6, dim=4)), {k: jnp.asarray(v) for k, v in p.items()}, 4)
    assert stacked.names == j_stacked.names and stacked.n_real == j_stacked.n_real
    for arr, j_arr, ns in zip(stacked.arrays, j_stacked.arrays, stacked.names):
        assert arr.shape[0] % 4 == 0 and arr.shape[0] >= len(ns)
        np.testing.assert_array_equal(arr.numpy(), np.asarray(j_arr))
    assert stack_params(g, params_from_numpy(p, "cpu"), pad_to=8).arrays[0].shape[0] == 5
    # the numpy bridge carries a StackedParams both ways
    back = params_from_numpy(params_to_numpy(stacked), "cpu")
    assert isinstance(back, StackedParams) and back.names == stacked.names
    assert all(torch.equal(a, b) for a, b in zip(back.arrays, stacked.arrays))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
def test_stacked_sgdg_matches_jax_and_per_core_sgdg(dtype, retraction_prob):
    """The stacked update against JAX's ``stacked_sgdg`` and against the
    port's ``sgdg`` on the unstacked cores, two steps."""
    g, p = _numpy_params(6, 4, 1, dtype)
    rng = np.random.default_rng(2)
    grads_seq = []
    for _ in range(2):
        gr = {k: (0.01 * rng.normal(size=v.shape)).astype(dtype) for k, v in p.items()}
        if np.dtype(dtype).kind == "c":
            gr = {k: (v + 0.01j * rng.normal(size=v.shape)).astype(dtype) for k, v in gr.items()}
        grads_seq.append(gr)

    jg = j_parse(j_mps(6, dim=4))
    j_opt = j_stacked_sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob)
    j_arr = j_stack(jg, {k: jnp.asarray(v) for k, v in p.items()}).arrays
    j_state = j_opt.init(j_arr)

    opt = stacked_sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob)
    stacked = stack_params(g, params_from_numpy(p, "cpu"))
    arr = stacked.arrays
    state = opt.init(arr)
    assert isinstance(state, StackedSGDGState)

    ref = sgdg(0.05, momentum=0.9, retraction_prob=retraction_prob)
    rp = params_from_numpy(p, "cpu")
    r_state = ref.init(rp)
    for gr in grads_seq:
        # JAX's gradient of a real loss is the conjugate of torch's
        t_gr = {k: np.conj(v) for k, v in gr.items()}
        j_upd, j_state = j_opt.update(j_stack(jg, {k: jnp.asarray(v) for k, v in gr.items()})
                                      .arrays, j_state, j_arr)
        upd, state = opt.update(stack_params(g, params_from_numpy(t_gr, "cpu")).arrays,
                                state, arr)
        r_upd, r_state = ref.update(params_from_numpy(t_gr, "cpu"), r_state, rp)
        for u, ju in zip(upd, j_upd):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-6)
        per_core = unstack_params(StackedParams(tuple(upd), stacked.names, stacked.n_real))
        for n in r_upd:
            np.testing.assert_allclose(per_core[n].numpy(), r_upd[n].numpy(),
                                       rtol=1e-4, atol=1e-6)
        j_arr = tuple(a + u for a, u in zip(j_arr, j_upd))
        arr = tuple(a + u for a, u in zip(arr, upd))
        rp = {k: v + r_upd[k] for k, v in rp.items()}


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"model": 8}, devices=["cpu"] * 8)


def test_step_loss_matches_network_log_fidelity_and_jax(mesh8):
    """``TestFSDPStep.test_loss_matches_replicated``: the first step's loss
    is −log F of the unstacked cores, and JAX's FSDP step's on its 8
    devices."""
    g, p = _numpy_params(8, 4, 5)
    _, t = _numpy_params(8, 4, 6)
    step, prepare, opt = make_fsdp_network_fit_step(g, mesh8)
    arrays, t_arrays = prepare(params_from_numpy(p, "cpu")), prepare(params_from_numpy(t, "cpu"))
    _, _, loss = step(arrays, opt.init(arrays), t_arrays)
    want = -float(network_log_fidelity(g, params_from_numpy(p, "cpu"),
                                       params_from_numpy(t, "cpu")))
    np.testing.assert_allclose(float(loss), want, rtol=1e-4, atol=1e-5)
    j_step, j_prepare, j_opt = j_fsdp_step(j_parse(j_mps(8, dim=4)), j_make_mesh({"model": 8}))
    j_arrays = j_prepare({k: jnp.asarray(v) for k, v in p.items()})
    _, _, j_loss = j_step(j_arrays, j_opt.init(j_arrays),
                          j_prepare({k: jnp.asarray(v) for k, v in t.items()}))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4, atol=1e-5)


def test_sharded_training_step(mesh8):
    """``TestFSDPStep.test_sharded_training_step``: 4 steps, finite and not
    rising; the dominant group (9 cores, padded to 16) is split over
    ``model``, and in one process the stacks stay whole; the momentum has
    the stacks' rows."""
    g = parse_graph(mps_graph(10, dim=8))
    params = init_params(g, 3, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(4)
    target = {n: v + 0.01 * torch.randn(v.shape, generator=gen) for n, v in params.items()}
    step, prepare, opt = make_fsdp_network_fit_step(g, mesh8, learning_rate=1e-2, momentum=0.9)
    arrays, t_arrays = prepare(params), prepare(target)
    places = group_shardings(stack_params(g, params, 8), mesh8)
    big = max(range(len(arrays)), key=lambda i: arrays[i].numel())
    assert places[big].spec == ("model",) and arrays[big].shape[0] == 16
    whole = stack_params(g, params, 8)
    assert all(a is b for a, b in zip(shard_stacked(whole, mesh8).arrays, whole.arrays))
    o = opt.init(arrays)
    losses = []
    for _ in range(4):
        arrays, o, loss = step(arrays, o, t_arrays)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] <= losses[0] + 1e-6
    assert o.momentum[big].shape[0] == arrays[big].shape[0]


def test_gradient_rows_and_identity_padding(mesh8):
    """The stacked gradient's real rows are the unstacked gradient's, its
    padded rows zero; over 10 steps, and under a forced retraction, the
    identity padding stays the identity bit for bit."""
    mesh4 = make_mesh({"model": 4}, devices=["cpu"] * 4)
    g, p = _numpy_params(6, 4, 7)
    _, t = _numpy_params(6, 4, 8)
    step, prepare, opt = make_fsdp_network_fit_step(g, mesh4)
    arrays, t_arrays = prepare(params_from_numpy(p, "cpu")), prepare(params_from_numpy(t, "cpu"))
    assert arrays[0].shape[0] == 8  # 5 cores + 3 identity rows
    _, grads = step.value_and_grad(arrays, t_arrays)
    x = {k: v.clone().requires_grad_() for k, v in params_from_numpy(p, "cpu").items()}
    nlf = -network_log_fidelity(g, x, params_from_numpy(t, "cpu"))
    ref = dict(zip(x, torch.autograd.grad(nlf, list(x.values()))))
    names = stack_params(g, x).names[0]
    want = torch.stack([ref[n] for n in names])
    assert float((grads[0][:5] - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.count_nonzero(grads[0][5:]) == 0
    ident = torch.eye(16).reshape(4, 4, 4, 4)
    o = opt.init(arrays)
    for _ in range(10):
        arrays, o, _ = step(arrays, o, t_arrays)
    assert all(torch.equal(arrays[0][i], ident) for i in range(5, 8))
    forced = stacked_sgdg(1e-2, momentum=0.9, retraction_prob=1.0)
    pad = ident.expand(3, 4, 4, 4, 4).contiguous()
    upd, _ = forced.update((torch.zeros_like(pad),), forced.init((pad,)), (pad,))
    assert torch.count_nonzero(upd[0]) == 0
