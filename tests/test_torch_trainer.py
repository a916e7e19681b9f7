"""Port parity: Born-rule likelihood training (tneq_tpu_torch.train.trainer,
losses, data, model.QCTN and apps.train_single_node vs their tneq_tpu
counterparts).

The JAX Trainer contracts with ``make_siamese_fn``; the port's takes the
chain sweep through B3/B4 (their plain versions on the CPU).  Both start
from the same numpy cores and data.  SGD-G is held with
``retraction_prob=0`` and with the retraction forced.  Every case checks
that the step-0 loss is below the clip's 23.0 and that the gradient is
non-zero, so the comparison is not vacuous.

Tolerances: one step, losses rtol 1e-5 and cores atol 2e-5; ten steps,
losses rtol 1e-4 and cores atol 1e-4 (float32 gradients at probabilities
near 1e-7 agree to about 1e-4 relative, and each Stiefel step moves a core
by about 1e-2).  The float32 case is a 4-qubit chain: on deeper float32
chains the Born-rule probabilities are tiny differences of large terms,
and two summation orders part after a few Stiefel steps (measured on the
host: past 1e-4 from step 7 at 8 qubits, D = 8, K = 4).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.graph import mps_graph
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.graph.generators import example_graph
from tneq_tpu.model.qctn import QCTN as JQCTN
from tneq_tpu.optim.stiefel import sgdg as j_sgdg
from tneq_tpu.train import data as jdata
from tneq_tpu.train import losses as jl
from tneq_tpu.train.trainer import Trainer as JTrainer
from tneq_tpu.train.trainer import TrainingConfig as JConfig
from tneq_tpu.train.trainer import basis_states as j_basis
from tneq_tpu_torch.apps.train_single_node import main
from tneq_tpu_torch.graph import parse_graph as t_parse
from tneq_tpu_torch.model.qctn import QCTN, init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.optim.stiefel import sgdg as t_sgdg
from tneq_tpu_torch.train import data as tdata
from tneq_tpu_torch.train import losses as tl
from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig, basis_states

torch.set_num_threads(1)

CLIP_LOSS = float(-np.log(np.float32(1e-10)))  # 23.02585
CASES = {
    # name: (qubits, bond, phys = K, torch dtype, jax dtype)
    "float32": (4, 3, 2, torch.float32, jnp.float32),
    "complex64": (4, 2, 3, torch.complex64, jnp.complex64),
}


def _setup(case, steps, retraction_prob, B=16):
    n, bond, K, tdt, jdt = CASES[case]
    src = mps_graph(n, bond, phys=K)
    gt = t_parse(src)
    p_np = params_to_numpy(init_params(gt, 0, tdt, device="cpu"))
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((B, n)).astype(np.float32) for _ in range(2)]
    tt = Trainer(gt, optimizer=t_sgdg(1e-2, momentum=0.9, retraction_prob=retraction_prob),
                 config=TrainingConfig(max_steps=steps, log_every=0), dtype=tdt, device="cpu")
    gj = j_parse(src)
    tj = JTrainer(gj, optimizer=j_sgdg(1e-2, momentum=0.9, retraction_prob=retraction_prob),
                  config=JConfig(max_steps=steps, log_every=0), dtype=jdt)
    return gt, gj, tt, tj, p_np, xs


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("retraction_prob", [0.0, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_jax(case, retraction_prob, steps):
    gt, gj, tt, tj, p_np, xs = _setup(case, steps, retraction_prob)
    states = basis_states(gt, dtype=tt.dtype, device="cpu")
    # not vacuous: below the clip, with a gradient
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, "cpu").items()}
    loss0 = tt.loss(leaves, states, torch.as_tensor(xs[0]))
    grads = torch.autograd.grad(loss0, list(leaves.values()))
    assert float(loss0.detach()) < 23.0
    assert max(float(g.abs().max()) for g in grads) > 0
    pt, st = tt.fit(params_from_numpy(p_np, "cpu"), [torch.as_tensor(x) for x in xs],
                    states=states, verbose=False)
    with jax.default_matmul_precision("highest"):
        pj, sj = tj.fit({k: jnp.asarray(v) for k, v in p_np.items()},
                        [jnp.asarray(x) for x in xs], states=j_basis(gj, dtype=tj.dtype),
                        verbose=False)
    rtol, atol = (1e-5, 2e-5) if steps == 1 else (1e-4, 1e-4)
    assert st.steps == sj.steps == steps
    np.testing.assert_allclose(st.losses, sj.losses, rtol=rtol)
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=atol)


def test_cli_default_sits_at_the_clip_like_jax():
    """The CLI's default (8 qubits, dim 3, complex64, batch 32, sgdg) from
    JAX's own initial cores: 3 of 4 batches give -log(1e-10) from step 0
    in both packages, and the port follows JAX step for step."""
    src = example_graph(8, "mps", 3)
    jm = JQCTN(src, key=jax.random.PRNGKey(0), dtype=jnp.complex64)
    p_np = {k: np.asarray(v) for k, v in jm.params.items()}
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(32, 8)).astype(np.float32) for _ in range(4)]
    steps = 12
    with jax.default_matmul_precision("highest"):
        _, sj = JTrainer(jm.graph, optimizer=j_sgdg(1e-2, momentum=0.9, retraction_prob=0.0),
                         config=JConfig(max_steps=steps, log_every=0)).fit(
            jm.params, [jnp.asarray(x) for x in xs], states=j_basis(jm.graph), verbose=False)
    g = t_parse(src)
    _, st = Trainer(g, optimizer=t_sgdg(1e-2, momentum=0.9, retraction_prob=0.0),
                    config=TrainingConfig(max_steps=steps, log_every=0), device="cpu").fit(
        params_from_numpy(p_np, "cpu"), [torch.as_tensor(x) for x in xs],
        states=basis_states(g, device="cpu"), verbose=False)
    np.testing.assert_allclose(st.losses, sj.losses, rtol=1e-5)
    at_clip = np.isclose(st.losses, CLIP_LOSS, rtol=1e-6)
    assert at_clip.sum() == 3 * steps // 4


def test_chunked_step_equals_the_step_loop():
    gt, _, tt, _, p_np, xs = _setup("complex64", 3, 0.0)
    states = basis_states(gt, device="cpu")
    xs_t = torch.stack([torch.as_tensor(xs[i % 2]) for i in range(3)])
    params = params_from_numpy(p_np, "cpu")
    opt = tt.optimizer.init(params)
    losses = []
    for i in range(3):
        params, opt, loss = tt.train_step(params, opt, states, xs_t[i])
        losses.append(float(loss))
    p2, _, l2 = tt.make_chunked_step(3)(
        params_from_numpy(p_np, "cpu"), tt.optimizer.init(params_from_numpy(p_np, "cpu")),
        states, xs_t)
    assert l2.shape == (3,)
    np.testing.assert_array_equal(l2.numpy(), np.array(losses, np.float32))
    for k in params:
        torch.testing.assert_close(p2[k], params[k], rtol=0, atol=0)


def test_fit_hooks_and_tol_exit():
    g = t_parse(mps_graph(3, 2))
    cfg = TrainingConfig(max_steps=6, log_every=2, eval_every=2, save_every=2, tol=1e9)
    evals, saves = [], []
    tr = Trainer(g, config=cfg, device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, stats = tr.fit(init_params(g, 0, device="cpu"), tdata.gaussian_batches(2, 8, 3, device="cpu"),
                          eval_fn=lambda p, i: evals.append(i),
                          checkpoint_fn=lambda p, i: saves.append(i))
    # tol 1e9: the second loss is within tol of the first
    assert stats.converged and stats.steps == 2 and len(stats.losses) == 2
    assert evals == [0] and saves == [] and "step 0: loss=" in out.getvalue()
    assert stats.final_loss == stats.losses[-1] and stats.wall_time >= 0
    cfg2 = TrainingConfig(max_steps=5, log_every=0, eval_every=2, save_every=2)
    _, stats2 = Trainer(g, config=cfg2, device="cpu").fit(
        init_params(g, 0, device="cpu"), tdata.gaussian_batches(2, 8, 3, device="cpu"),
        eval_fn=lambda p, i: evals.append(i), checkpoint_fn=lambda p, i: saves.append(i),
        verbose=False)
    assert stats2.steps == 5 and not stats2.converged
    assert evals == [0, 0, 2, 4] and saves == [2, 4]


def test_trainer_options():
    g = t_parse(mps_graph(3, 2))
    assert Trainer(g, device="cpu").strategy == "mps_sweep_cuda"
    assert Trainer(g, device="cpu").K == 2
    for method in ("adamg", "momentum", "adam"):
        cfg = TrainingConfig(method=method, max_steps=2, log_every=0,
                             lr_schedule=[(1, 0.5)])
        _, stats = Trainer(g, config=cfg, device="cpu").fit(
            init_params(g, 0, device="cpu"), tdata.gaussian_batches(1, 4, 3, device="cpu"),
            verbose=False)
        assert stats.steps == 2 and np.isfinite(stats.losses).all()
    mixed = t_parse("-2-A-3-\n-2-A-2-")
    with pytest.raises(ValueError, match="mixed output ranks"):
        Trainer(mixed, device="cpu")
    states = basis_states(g, index=0, dtype=torch.float64, device="cpu")
    assert [s.tolist() for s in states] == [[1.0, 0.0]] * 3


def test_train_single_node_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = main(["--device", "cpu", "--steps", "5", "--num-qubits", "4"])
        stats32 = main(["--device", "cpu", "--steps", "3", "--dtype", "float32",
                        "--num-qubits", "3", "--dim", "2"])
    assert stats.steps == 5 and np.isfinite(stats.losses).all()
    assert stats32.steps == 3
    assert "graph (mps, 4 qubits, 3 cores)" in out.getvalue()
    assert "trained 5 steps" in out.getvalue()
    with pytest.raises(NotImplementedError, match="item 2"):
        main(["--device", "cpu", "--steps", "1", "--save", "x.safetensors"])
    with pytest.raises(NotImplementedError, match="item 12"):
        main(["--device", "cpu", "--steps", "1", "--profile", "trace"])
    # non-chain graphs take the pairwise einsum path (tests/test_torch_contract.py)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for graph_type in ("tree", "wall", "wall_col"):
            stats = main(["--device", "cpu", "--steps", "2", "--graph-type", graph_type,
                          "--num-qubits", "4", "--dim", "2"])
            assert stats.steps == 2 and np.isfinite(stats.losses).all()
    assert "graph (wall, 4 qubits" in out.getvalue()


def test_nll_clip_gives_no_gradient_like_jax():
    p = np.array([1e-12, 5e-11, 1e-3, 0.5], np.float32)
    tp = torch.tensor(p, requires_grad=True)
    loss = tl.nll_loss(tp, log_scale=2.0)
    loss.backward()
    jv, jg = jax.value_and_grad(lambda q: jl.nll_loss(q, 2.0))(jnp.asarray(p))
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-6)
    assert tp.grad[0] == 0 and tp.grad[1] == 0 and tp.grad[2] != 0
    # the log-scale is a constant for the gradient
    s = torch.tensor(1.0, requires_grad=True)
    tl.nll_loss(torch.tensor(p, requires_grad=True), log_scale=s).backward()
    assert s.grad is None
    # complex probabilities take their real part
    np.testing.assert_allclose(float(tl.nll_loss(torch.tensor(p).to(torch.complex64))),
                               float(tl.nll_loss(torch.tensor(p))))


@pytest.mark.parametrize("complex_", [False, True])
def test_fidelity_matches_jax(complex_):
    rng = np.random.default_rng(4)
    o, t = rng.standard_normal((2, 3, 4))
    if complex_:
        o, t = o + 1j * rng.standard_normal((3, 4)), t + 1j * rng.standard_normal((3, 4))
    for fn_t, fn_j in ((tl.fidelity, jl.fidelity), (tl.fidelity_loss, jl.fidelity_loss)):
        np.testing.assert_allclose(float(fn_t(torch.as_tensor(o), torch.as_tensor(t))),
                                   float(fn_j(jnp.asarray(o), jnp.asarray(t))), rtol=1e-6)
    assert float(tl.fidelity(torch.as_tensor(o), torch.as_tensor(o))) == pytest.approx(1.0)


def test_data_matches_jax():
    tb = tdata.gaussian_batches(3, 5, 4, seed=7, scale=2.0, device="cpu")
    jb = jdata.gaussian_batches(3, 5, 4, seed=7, scale=2.0)
    for a, b in zip(tb, jb):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seq = list(range(5))
    it_t, it_j = tdata.shuffled_epochs(seq, seed=3), jdata.shuffled_epochs(seq, seed=3)
    assert [next(it_t) for _ in range(12)] == [next(it_j) for _ in range(12)]
    it_t, it_j = tdata.cycle_batches(seq), jdata.cycle_batches(seq)
    assert [next(it_t) for _ in range(7)] == [next(it_j) for _ in range(7)]


def test_qctn_wrapper():
    src = mps_graph(4, 2)
    m = QCTN(src, seed=3, dtype=torch.float32, device="cpu")
    assert (m.nqubits, m.ncores, list(m.cores)) == (4, 3, ["a", "b", "c"])
    assert "QCTN(nqubits=4, ncores=3" in repr(m) and "float32" in repr(m)
    ref = init_params(t_parse(src), 3, torch.float32, device="cpu")
    for k in ref:
        torch.testing.assert_close(m.params[k], ref[k], rtol=0, atol=0)
    c = m.copy()
    c.set_cores([np.ones(16, np.float32)] * 3)
    assert c.params["a"].shape == m.graph.shapes["a"] and float(c.params["a"].sum()) == 16
    assert float(m.params["a"].sum()) != 16  # the copy owns its dict
    c.set_cores({"b": np.zeros(m.graph.shapes["b"])}, strict=False)
    assert float(c.params["b"].abs().sum()) == 0 and c.params["b"].dtype == torch.float32
    with pytest.raises(ValueError, match="strict"):
        c.set_cores([np.ones(16)])
    with pytest.raises(ValueError, match="strict"):
        c.set_cores({"a": np.ones(16)})
    with pytest.raises(ValueError, match="size mismatch"):
        c.set_cores({"a": np.ones(5)}, strict=False)
    with pytest.raises(TypeError):
        c.set_cores(np.ones(3))
    with pytest.warns(UserWarning, match="first 2"):
        c.set_cores([np.ones(16)] * 2, strict=False)
    with pytest.raises(NotImplementedError, match="item 2"):
        m.save_cores("x.safetensors")
    with pytest.raises(NotImplementedError, match="item 2"):
        m.load_cores("x.safetensors")


def test_clip_fraction_script():
    from tneq_tpu_torch.bench.clip_fraction import clip_fraction

    row = clip_fraction(4, 2, 2, 16, torch.float32, device="cpu")
    assert row["qubits"] == 4 and 0.0 <= row["below_clip"] <= 1.0
    assert row["median_probability"] > 0
