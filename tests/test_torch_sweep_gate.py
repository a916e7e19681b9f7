"""The gate that sends a Born-rule chain to the transfer-sweep kernels B3/B4
(``ops/transfer_step.transfer_sweep_supported``,
``ops/mps_sweep.chain_takes_kernel``) and its callers: ``compile_siamese``,
``Trainer``, ``DistributedTrainer`` and the meshed ``EngineSiamese``.

A chain the gate refuses (a dtype other than float32 / complex64, a middle
bond past 256 or a physical rank past 64) takes the kernel-free sweep
``"mps_sweep"`` and computes what JAX computes (ROADMAP C4, C5); a chain it
takes goes on through the kernels (their plain versions on host tensors).
Values against JAX's ``mps_sweep`` / engine at f32 rounding (rtol 2e-5 of
the batch's largest); the engine's against its ``mesh=None`` path at 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tneq_tpu.engine import EngineSiamese as JEngine
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu.model import QCTN as JQCTN
from tneq_tpu.parallel import make_mesh as j_make_mesh
from tneq_tpu_torch.engine import EngineSiamese
from tneq_tpu_torch.graph import mps_graph, parse_graph
from tneq_tpu_torch.model.qctn import QCTN, init_params, params_from_numpy, params_to_numpy
from tneq_tpu_torch.ops import transfer_step as ts
from tneq_tpu_torch.ops.compiler import compile_siamese
from tneq_tpu_torch.ops.features import measurement_matrices
from tneq_tpu_torch.ops.mps_sweep import chain_takes_kernel, mps_sweep_siamese_fn
from tneq_tpu_torch.parallel import make_mesh
from tneq_tpu_torch.parallel.trainer import DistributedConfig, DistributedTrainer
from tneq_tpu_torch.train.trainer import Trainer, basis_states

from test_torch_mps_sweep import NP_DT, RTOL_V, _chain_value, _j_chain_value, _spy

torch.set_num_threads(1)

F32, C64, F64, C128 = torch.float32, torch.complex64, torch.float64, torch.complex128


@pytest.mark.parametrize("Da,K,Dc,dtype,takes", [
    (256, 64, 256, F32, True), (256, 64, 256, C64, True),
    (257, 64, 257, C64, False), (256, 65, 256, F32, False),
    (257, 4, 256, F32, False), (256, 4, 257, C64, False),  # either bond of a step
    (8, 4, 8, F64, False), (8, 4, 8, C128, False), (1, 1, 1, F32, True),
])
def test_gate_at_its_edges(Da, K, Dc, dtype, takes):
    """The gate is the region where ``kernel_plan`` plans a sweep, forward
    and (transposed) backward, at every batch: it refuses what the plan
    refuses and nothing else."""
    assert ts.transfer_sweep_supported(Da, K, Dc, dtype) is takes
    for B in (1, 32, 4096):
        for dims in ((Da, K, Dc), (Dc, K, Da)):
            if takes:
                assert ts.kernel_plan(B, *dims, dtype).smem <= ts.SMEM_MAX
            else:
                with pytest.raises(ValueError):
                    ts.kernel_plan(B, *dims, dtype)


# (source, dtype, strategy, middle sites): fault C4's widths on both sides of
# the gate's edges
CHAINS = [
    (mps_graph(4, 264, phys=2), C64, "mps_sweep", 1),
    (mps_graph(5, 4, phys=72), F32, "mps_sweep", 2),
    (mps_graph(4, 256, phys=2), C64, "mps_sweep_cuda", 1),
    (mps_graph(5, 4, phys=64), F32, "mps_sweep_cuda", 2),
]


@pytest.mark.parametrize("src,dtype,strategy,mids", CHAINS,
                         ids=["c64-bond264", "f32-rank72", "c64-bond256", "f32-rank64"])
def test_trainers_compile_through_the_gate(monkeypatch, src, dtype, strategy, mids):
    """``Trainer`` and a one-process ``DistributedTrainer`` name the
    strategy the gate gives; a refused chain makes no kernel sweep and
    matches JAX's sweep, a taken one sweeps through the kernel."""
    g = parse_graph(src)
    tr = Trainer(g, dtype=dtype, device="cpu")
    assert tr.strategy == strategy
    assert chain_takes_kernel(g, dtype) is (strategy == "mps_sweep_cuda")
    dist = DistributedTrainer(DistributedConfig(graph=src, dtype=str(dtype).split(".")[1]),
                              devices=["cpu"])
    assert dist.strategy == strategy
    K = g.output_ranks[0]
    rng = np.random.default_rng(0)
    p_np = {}  # random cores over sqrt(fan-in): init_params' QR takes seconds at rank 72
    for name, shape in g.shapes.items():
        c = rng.standard_normal(shape)
        if dtype.is_complex:
            c = c + 1j * rng.standard_normal(shape)
        p_np[name] = (c / np.sqrt(np.prod(shape[:2]))).astype(NP_DT[dtype])
    states = [rng.standard_normal(K).astype(NP_DT[dtype]) for _ in range(g.nqubits)]
    x = rng.standard_normal((3, g.nqubits)).astype(np.float32)
    calls = _spy(monkeypatch)
    val = _chain_value(g, p_np, states, x, dtype, fn=tr._siamese)
    if strategy == "mps_sweep":
        assert calls == {"kernel": 0, "einsum": mids}
    else:  # one site, or the uniform middle cores as one sweep
        assert calls == {"kernel": 1, "einsum": 0}
    v = val.detach().numpy()
    assert np.isfinite(v).all()
    ref = _j_chain_value(src, p_np, states, x, K,
                         jnp.complex64 if dtype.is_complex else jnp.float32)
    np.testing.assert_allclose(v, ref, rtol=RTOL_V, atol=RTOL_V * np.abs(ref).max())


def test_explicit_kernel_on_a_refused_chain_raises():
    """``use_kernel=True`` never falls back: a chain past the gate raises at
    its first call, on any device, and so does a closure compiled for the
    kernels in complex64 that is handed complex128 cores."""
    g = parse_graph(mps_graph(4, 264, phys=2))
    mx = measurement_matrices(torch.zeros(2, 4), 2).to(C64)
    measures = [mx[:, q] for q in range(4)]
    args = (init_params(g, 0, C64, device="cpu"), basis_states(g, dtype=C64, device="cpu"),
            measures)
    for fn in (mps_sweep_siamese_fn(g, use_kernel=True),
               compile_siamese(g, use_kernel=True, dtype=C64)[0]):
        with pytest.raises(ValueError, match="use_kernel=True"):
            fn(*args)
    g8 = parse_graph(mps_graph(4, 8, phys=2))
    fn, strategy = compile_siamese(g8, dtype=C64)
    assert strategy == "mps_sweep_cuda"
    with pytest.raises(ValueError, match="use_kernel=True"):
        fn(init_params(g8, 0, C128, device="cpu"), basis_states(g8, dtype=C128, device="cpu"),
           [m.to(C128) for m in measures])


def test_meshed_engine_takes_the_gate(monkeypatch):
    """Fault C5: ``EngineSiamese(mesh=...)`` with a ``model`` axis of 1
    compiles the chain sweep; a complex128 chain takes it without the
    kernels and matches JAX's meshed engine (complex64 there: JAX runs
    without x64) and the port's ``mesh=None`` engine.  A complex64 QCTN of
    the same graph takes the kernel through a closure of its own."""
    src = mps_graph(6, dim=3, phys=2)
    g = parse_graph(src)
    p_np = params_to_numpy(init_params(g, 0, C64, device="cpu"))
    x = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    eng = EngineSiamese(dtype=C128, device="cpu",
                        mesh=make_mesh({"data": 1}, devices=["cpu"]))
    jeng = JEngine(mesh=j_make_mesh({"data": 1}, devices=jax.devices()[:1]))
    mx, _ = eng.generate_data(x, K=2)
    jmx, _ = jeng.generate_data(jnp.asarray(x), K=2)
    states = basis_states(g, dtype=C128, device="cpu")
    calls = _spy(monkeypatch)
    got = eng.contract_with_compiled_strategy(
        QCTN(g, params_from_numpy(p_np, "cpu", C128), device="cpu"), states, mx)
    assert got.dtype == F64 and calls == {"kernel": 0, "einsum": 3}
    ref = np.asarray(jeng.contract_with_compiled_strategy(
        JQCTN(j_parse(src), {k: jnp.asarray(v) for k, v in p_np.items()}),
        [jnp.asarray(s.numpy()) for s in states], jmx))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL_V, atol=RTOL_V * np.abs(ref).max())
    plain = EngineSiamese(dtype=C128, device="cpu").contract_with_compiled_strategy(
        QCTN(g, params_from_numpy(p_np, "cpu", C128), device="cpu"), states, mx)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6 * float(plain.abs().max()))
    # the same graph in complex64: a closure of its own, through the kernel
    calls.update(kernel=0, einsum=0)
    low = eng.contract_with_compiled_strategy(
        QCTN(g, params_from_numpy(p_np, "cpu"), device="cpu"),
        basis_states(g, dtype=C64, device="cpu"), [m.to(C64) for m in mx])
    assert low.dtype == F32 and calls == {"kernel": 1, "einsum": 0}
    np.testing.assert_allclose(low.numpy(), ref, rtol=RTOL_V, atol=RTOL_V * np.abs(ref).max())


def _random_chain(rng) -> str:
    """A chain DSL of 4-6 qubits whose bonds and output ranks fall on both
    sides of the gate's edges, one line per qubit as ``mps_graph`` writes
    them."""
    n = int(rng.integers(4, 7))
    bonds = rng.choice([1, 2, 31, 32, 255, 256, 257, 300], size=n - 2)
    outs = rng.choice([1, 2, 63, 64, 65, 72], size=n)
    ins = rng.choice([1, 2], size=n)
    sym = [chr(ord("a") + i) for i in range(n - 1)]
    lines = [f"-{ins[0]}-a-{outs[0]}-"]
    for q in range(1, n - 1):
        lines.append(f"-{ins[q]}-{sym[q - 1]}-{bonds[q - 1]}-{sym[q]}-{outs[q]}-")
    lines.append(f"-{ins[-1]}-{sym[-1]}-{outs[-1]}-")
    return "\n".join(lines)


def test_no_compiled_kernel_strategy_covers_a_refused_plan():
    """Over 200 seeded chains and the four dtypes: wherever ``Trainer`` or
    ``compile_siamese`` names ``"mps_sweep_cuda"``, ``kernel_plan`` plans
    every middle step forward and backward (and the stacked sweep of uniform
    middle cores); wherever it refuses one, the strategy is
    ``"mps_sweep"``; in float32 / complex64 a chain it plans whole takes
    the kernel."""
    rng = np.random.default_rng(2024)
    seen = set()
    for _ in range(200):
        src = _random_chain(rng)
        dtype = (F32, C64, F64, C128)[int(rng.integers(4))]
        g = parse_graph(src)
        mids = [g.shapes[n] for n in g.core_names[1:-1]]
        fwd = [(s[0], g.output_ranks[i + 1], s[3]) for i, s in enumerate(mids)]
        steps = [(B, *d, 1) for d in fwd for B in (1, 32)]
        steps += [(B, Dc, K, Da, 1) for B, Da, K, Dc, _ in steps]  # the d_env sweep
        if len(set(mids)) == 1 and len(mids) > 1:  # one stacked sweep
            steps.append((32, *fwd[0], len(mids)))
        planned = all(_plans(*step, dtype) for step in steps)
        strategies = {compile_siamese(g, dtype=dtype)[1],
                      Trainer(g, K=g.output_ranks[0], dtype=dtype, device="cpu").strategy}
        assert len(strategies) == 1
        strategy = strategies.pop()
        if strategy == "mps_sweep_cuda":
            assert planned, src
        if not planned:
            assert strategy == "mps_sweep", src
        if ts.kernel_supported(dtype):
            assert (strategy == "mps_sweep_cuda") is planned, src
        seen.add((strategy, planned, ts.kernel_supported(dtype)))
    # both sides of the gate, and both reasons for a refusal, were drawn
    assert seen == {("mps_sweep_cuda", True, True), ("mps_sweep", False, True),
                    ("mps_sweep", False, False)}


def _plans(B, Da, K, Dc, n, dtype) -> bool:
    try:
        ts.kernel_plan(B, Da, K, Dc, dtype, n)
    except ValueError:
        return False
    return True
