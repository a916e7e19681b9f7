"""Micro-benchmark stages (see the package docstring for the tools/ mapping).

Counterpart of ``tneq_tpu/bench/microbench.py``: each stage returns a JSON
record with the reference package's keys, measured on ``device`` (default
``"cuda"``; a card is required unless the caller asks for the CPU).  Every
timed call ends in ``torch.cuda.synchronize`` on the card, so a time is the
work's and not its launch's.  Shares are against one H100 SXM's published
peaks (``bench/flops.py``).

``9_flagship_32q`` (the reference package's subprocess run of
``bench/flagship.py``) joins ``ALL_STAGES`` when ``bench/flagship.py`` is
ported.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = [
    "stage_env_audit",
    "stage_matmul_peak",
    "stage_memory_bandwidth",
    "stage_transpose_cost",
    "stage_collectives",
    "stage_checkpoint_io",
    "stage_tn_workload",
    "ALL_STAGES",
]

# one H100's HBM holds a stream above this many bytes read plus written only
# in part in its 50 MB L2, so stage 3 holds those points against the HBM rate
L2_BYTES = 50 * 2**20


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn: Callable[[], Any], dev: torch.device, repeats: int = 5,
            warmup: int = 2) -> float:
    """Median wall time of ``fn`` followed by a synchronise of ``dev``."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def _brick_wall(n_qubits: int, n_cells: int):
    from ..graph import build_brick_wall_incidence, incidence_to_graph, parse_graph

    return parse_graph(incidence_to_graph(build_brick_wall_incidence(n_qubits, n_cells, 2)))


def stage_env_audit(device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """Stage 1 analogue (``tools/stage1_env_audit``): platform + library audit."""
    import subprocess

    dev = resolve_device(device)
    rec = {
        "stage": "env_audit",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": _platform(dev),
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "default_backend": dev.type,
        "nvidia_smi": None,
    }
    if dev.type == "cuda":
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[dev.index or 0]
    from ..native import native_available

    rec["native_pathfinder"] = native_available()
    return rec


def stage_matmul_peak(
    sizes=(512, 1024, 2048), dtypes=("float32", "bfloat16", "complex64"),
    device: DeviceLike = "cuda", **_
) -> Dict[str, Any]:
    """Stage 2 analogue (``test_single_cmg_peak.py``): square matmul GFLOP/s
    per size/dtype under the port's float32 matmul precision (complex counts
    4x real flops), with each point's share of the H100's peak."""
    from .flops import mxu_utilization

    dev = resolve_device(device)
    precision = torch.get_float32_matmul_precision()
    share_at = {"highest": "highest", "high": "high", "medium": "default"}[precision]
    results = []
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        for n in sizes:
            if dtype_name == "complex64":
                a = torch.complex(torch.ones(n, n), torch.ones(n, n)).to(dev)
            else:
                a = torch.ones((n, n), dtype=dtype, device=dev)
            dt = _timeit(lambda: torch.matmul(a, a), dev)
            flops = 2.0 * n**3 * (4.0 if dtype_name == "complex64" else 1.0)
            results.append(
                {"size": n, "dtype": dtype_name,
                 "gflops": round(flops / dt / 1e9, 2),
                 "ms": round(dt * 1e3, 3),
                 "peak_share": round(mxu_utilization(flops / dt / 1e12, dtype_name,
                                                     share_at), 4)}
            )
            del a
    return {"stage": "matmul_peak", "precision": precision, "platform": _platform(dev),
            "results": results}


def stage_memory_bandwidth(sizes_mb=(16, 64, 256), device: DeviceLike = "cuda",
                           **_) -> Dict[str, Any]:
    """Stage 3 analogue (``test_hbm2_bandwidth.py``): copy/scale bandwidth.
    Points whose bytes read plus written exceed the 50 MB L2 carry their
    share of the 3.35 TB/s HBM rate; smaller ones run from the L2 (None)."""
    from .flops import PEAK_HBM_TBPS

    dev = resolve_device(device)
    results = []
    for mb in sizes_mb:
        n = mb * 1024 * 1024 // 4
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        dt = _timeit(lambda: x * 1.0000001, dev)
        gbps = 2 * n * 4 / dt / 1e9  # read + write
        results.append(
            {"size_mb": mb, "gbps": round(gbps, 2), "ms": round(dt * 1e3, 3),
             "hbm_share": round(gbps / (PEAK_HBM_TBPS * 1e3), 4)
             if 2 * n * 4 > L2_BYTES else None}
        )
        del x
    return {"stage": "memory_bandwidth", "platform": _platform(dev), "results": results}


def stage_transpose_cost(n: int = 2048, device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """Stage 3 analogue (``test_transpose_cost.py``): permute+materialize vs
    copy.  torch keeps a transposed view's strides in elementwise results,
    so the transpose is materialised with ``contiguous()``."""
    dev = resolve_device(device)
    x = torch.ones((n, n), dtype=torch.float32, device=dev)
    t_copy = _timeit(lambda: x + 0.0, dev)
    t_tr = _timeit(lambda: x.t().contiguous(), dev)
    return {
        "stage": "transpose_cost",
        "size": n,
        "copy_ms": round(t_copy * 1e3, 3),
        "transpose_ms": round(t_tr * 1e3, 3),
        "ratio": round(t_tr / max(t_copy, 1e-12), 2),
    }


def stage_collectives(size_mb: int = 8, device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """Stage 5/7 analogue (``test_mpi_baseline.py``): psum / all_gather /
    ppermute latency+bandwidth over a mesh line.

    The reference package runs them over the devices of one process.  In
    one process the port's mesh positions share one device and run their
    slices in turn, so the stage skips there, as the reference package's
    does on one device.  Under an initialised ``torch.distributed`` group of
    two or more ranks it times the port's ``parallel/_collectives.py``
    (``all_reduce``, ``gather_rows``, ``ring``) on the rank's line, each
    under the reference package's name with the primitive it took."""
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ..parallel._collectives import all_reduce, gather_rows, ring

    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() >= 2):
        return {"stage": "collectives",
                "skipped": "one process: its mesh positions share one device"}
    world = dist.get_world_size()
    line = make_mesh({"x": world}, devices=[dev] * world).line(("x",))
    n = size_mb * 1024 * 1024 // 4
    x = torch.ones((n // world,), dtype=torch.float32, device=dev)
    results = {}
    for name, (fn, collective) in {
        "psum": (lambda v: all_reduce(v, line), "all_reduce"),
        "all_gather": (lambda v: gather_rows(v, line), "all_gather"),
        "ppermute": (lambda v: ring(v, line), "ring"),
    }.items():
        dt = _timeit(lambda: fn(x), dev)
        results[name] = {
            "ms": round(dt * 1e3, 3),
            "algo_gbps": round(n // world * 4 * (world - 1) / dt / 1e9, 2),
            "collective": collective,
            "route": line.routes[collective],
        }
    return {"stage": "collectives", "n_devices": world, "backend": dist.get_backend(),
            "size_mb": size_mb, "results": results}


def stage_checkpoint_io(tmpdir: Optional[str] = None, size_mb: int = 64,
                        device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """Stage 6 analogue (``test_llio_performance.py``): checkpoint save/load
    through ``utils/checkpoint.CheckpointManager``."""
    import tempfile

    from ..utils.checkpoint import CheckpointManager

    dev = resolve_device(device)
    d = tmpdir or tempfile.mkdtemp()
    # the stage measures DISK throughput; dtype is incidental.  The
    # reference package's rule, kept so the records compare: complex64
    # (the real/imag split path) on the CPU, float32 off it, because its
    # TPU channel refused complex64.
    dtype, elt = (torch.complex64, 8) if dev.type == "cpu" else (torch.float32, 4)
    n = size_mb * 1024 * 1024 // elt
    params = {
        "a": torch.ones((n // 2,), dtype=dtype, device=dev),
        "b": torch.ones((n // 2,), dtype=dtype, device=dev),
    }
    mgr = CheckpointManager(d, keep=1)
    _sync(dev)
    t0 = time.perf_counter()
    mgr.save(0, params)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.load()
    t_load = time.perf_counter() - t0
    return {
        "stage": "checkpoint_io",
        "size_mb": size_mb,
        "dtype": str(dtype).removeprefix("torch."),
        "save_mbps": round(size_mb / t_save, 1),
        "load_mbps": round(size_mb / t_load, 1),
    }


def stage_tn_workload(n_qubits: int = 8, n_cells: int = 5, batch: int = 32,
                      device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """Stage 6 analogue (``test_tensor_network_workload.py``): end-to-end
    siamese contraction + gradient throughput on the brick-wall QCTN, eager
    through ``ops/contract.make_siamese_fn``."""
    from ..model.qctn import init_params
    from ..ops.contract import abs_square, make_siamese_fn
    from ..ops.features import measurement_matrices
    from ..train.losses import nll_loss
    from ..train.trainer import basis_states

    dev = resolve_device(device)
    graph = _brick_wall(n_qubits, n_cells)
    params = init_params(graph, 0, torch.complex64, device=dev)
    states = basis_states(graph, device=dev)
    fn = make_siamese_fn(graph)

    def loss(params, x):
        mx = measurement_matrices(x, 2).to(torch.complex64)
        measures = [mx[:, q] for q in range(graph.nqubits)]
        raw = fn(params, states, measures)
        return nll_loss(abs_square(raw))

    x = torch.zeros((batch, n_qubits), dtype=torch.float32, device=dev)
    grad = torch.func.grad_and_value(loss)

    def fwd():
        with torch.no_grad():
            return loss(params, x)

    t_fwd = _timeit(fwd, dev)
    t_grad = _timeit(lambda: grad(params, x), dev)
    return {
        "stage": "tn_workload",
        "n_qubits": n_qubits,
        "n_cells": n_cells,
        "batch": batch,
        "forward_ms": round(t_fwd * 1e3, 3),
        "forward_per_sample_us": round(t_fwd / batch * 1e6, 2),
        "grad_ms": round(t_grad * 1e3, 3),
        "grad_steps_per_sec": round(1.0 / t_grad, 1),
    }


def stage_dtype_policy(n_qubits: int = 8, n_cells: int = 5, batch: int = 256,
                       device: DeviceLike = "cuda", **_) -> Dict[str, Any]:
    """bf16-compute vs f32 throughput for REAL-dtype likelihood training
    (the dtype-policy knob, ``utils/dtypes.py``): the same cores cast to
    each dtype, every contraction step in that dtype (bf16 GEMMs on the
    tensor cores), the loss taken in float32."""
    from ..model.qctn import init_params
    from ..ops.contract import make_siamese_fn
    from ..ops.features import measurement_matrices
    from ..train.losses import nll_loss
    from ..train.trainer import basis_states

    dev = resolve_device(device)
    graph = _brick_wall(n_qubits, n_cells)
    params32 = init_params(graph, 0, torch.float32, device=dev)
    states = basis_states(graph, dtype=torch.float32, device=dev)
    fn = make_siamese_fn(graph)
    x = torch.zeros((batch, n_qubits), dtype=torch.float32, device=dev)

    results = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        params = {k: v.to(dtype) for k, v in params32.items()}
        st = [s.to(dtype) for s in states]

        def loss(params, x):
            mx = measurement_matrices(x, 2).to(dtype)
            measures = [mx[:, q] for q in range(graph.nqubits)]
            raw = fn(params, st, measures)
            return nll_loss(raw.to(torch.float32))

        grad = torch.func.grad_and_value(loss)
        dt = _timeit(lambda: grad(params, x), dev)
        results[name] = {"grad_ms": round(dt * 1e3, 3),
                         "loss": float(grad(params, x)[1])}
    results["bf16_speedup"] = round(
        results["float32"]["grad_ms"] / results["bfloat16"]["grad_ms"], 2
    )
    return {"stage": "dtype_policy", "n_qubits": n_qubits, "batch": batch,
            "precision": torch.get_float32_matmul_precision(), "results": results}


def stage_large_network(n_qubits: int = 32, n_cells: int = 2, device: DeviceLike = "cuda",
                        **_) -> Dict[str, Any]:
    """North-star proxy: 30+-qubit symmetry-breaking circuit, network-space
    fidelity gradient step (no dense target — impossible at this size),
    timed end to end: the masked fit of a 32 x 2 complex64 brick wall on
    the row sweep."""
    from ..model.qctn import init_params
    from ..optim.stiefel import sgdg
    from ..train.network_fit import make_masked_network_fidelity_fit

    dev = resolve_device(device)
    graph = _brick_wall(n_qubits, n_cells)
    gen = torch.Generator().manual_seed(0)
    t_params = init_params(graph, gen, torch.complex64, device=dev)
    params = init_params(graph, gen, torch.complex64, device=dev)
    mask = torch.ones(graph.ncores, dtype=torch.float32, device=dev)
    # mask a quarter of the target's cores
    t_mask = torch.ones(graph.ncores, dtype=torch.float32, device=dev)
    t_mask[::4] = 0.0

    fit_1, fit_16 = (
        make_masked_network_fidelity_fit(
            graph, sgdg(1e-2, momentum=0.9, stiefel=True), max_steps=k, tol=0.0, device=dev)
        for k in (1, 16)
    )

    t0 = time.perf_counter()
    fit_1(params, mask, t_params, t_mask)
    _sync(dev)
    compile_s = time.perf_counter() - t0

    dt = _timeit(lambda: fit_16(params, mask, t_params, t_mask), dev, repeats=3, warmup=1)
    rec = {
        "stage": "large_network",
        "n_qubits": n_qubits,
        "n_cells": n_cells,
        "n_cores": graph.ncores,
        "compile_s": round(compile_s, 1),
        "steps_per_sec": round(16.0 / dt, 2),
        "ms_per_step": round(dt / 16.0 * 1e3, 3),
    }
    try:
        from .flops import mxu_utilization, overlap_flops

        # masked fit: 2 overlaps per gradient step (⟨eff,target⟩, ⟨eff,eff⟩),
        # x3 for forward+backward
        fl = 3.0 * 2.0 * overlap_flops(graph, "complex64")
        tflops = rec["steps_per_sec"] * fl / 1e12
        rec["flops_per_step"] = fl
        rec["tflops"] = round(tflops, 4)
        rec["mxu_util"] = round(mxu_utilization(tflops, "complex64", precision="highest"), 6)
    except Exception as e:
        rec["flops_error"] = f"{type(e).__name__}: {e}"
    try:
        torch_sps = _torch_network_step_baseline(graph)
        rec["torch_cpu_steps_per_sec"] = round(torch_sps, 2)
        rec["vs_torch_cpu"] = round(rec["steps_per_sec"] / torch_sps, 1)
    except Exception as e:  # baseline is best-effort
        rec["torch_cpu_error"] = f"{type(e).__name__}: {e}"
    return rec


def _torch_network_step_baseline(graph, n_steps: int = 10) -> float:
    """The reference's stack on the host: the two-network overlap equation
    contracted as one expression (here the port's path finder and pairwise
    executor, on CPU tensors) + torch autograd + a momentum update."""
    from ..ops.contract import execute
    from ..ops.einsum_spec import two_network_spec

    spec = two_network_spec(graph, graph)
    gen = torch.Generator().manual_seed(0)
    params = [
        torch.randn(graph.shapes[n], generator=gen, dtype=torch.complex64).requires_grad_()
        for n in graph.core_names
    ]
    target = [
        torch.randn(graph.shapes[n], generator=gen, dtype=torch.complex64)
        for n in graph.core_names
    ]
    bufs = [torch.zeros_like(p) for p in params]

    def step():
        ov = execute(spec.equation, [*params, *[t.conj() for t in target]])
        oo = execute(spec.equation, [*params, *[p.conj() for p in params]])
        loss = -(torch.log(ov.abs() ** 2 + 1e-30) - torch.log(oo.real + 1e-30))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, b, g in zip(params, bufs, grads):
                b.mul_(0.9).add_(g)
                p.add_(b, alpha=-0.01)

    step()  # warmup
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    return n_steps / (time.perf_counter() - t0)


def stage_bond_sweep(
    n_qubits: int = 32,
    bond_dims=(8, 16, 32, 64),
    bench_steps: int = 50,
    device: DeviceLike = "cuda",
    **_,
) -> Dict[str, Any]:
    """Sweep the MPS bond dimension on the headline network-fidelity
    gradient step (plain SGD, lr 1e-3), reporting achieved TFLOP/s and its
    share of the H100's float32 peak per D.  FLOPs are exact counts of the
    contraction path (``bench/flops.py``).  ``compile_s`` is the first
    step's seconds (kernel builds, plans, allocator).  Each point records
    its route — the sweep kernels B1/B2 where S = D² fits them, the
    per-site einsum scan beyond — and the B1/B2 launches per step that the
    port's counters saw (the kernels count only on the card)."""
    from ..graph import mps_graph, parse_graph
    from ..ops import chain_overlap
    from ..train.network_fit import _chain_cores
    from .flops import mxu_utilization, network_fidelity_step_flops
    from .headline import sgd_step
    from .util_peak import sweep_problem

    dev = resolve_device(device)
    results = []
    for dim in bond_dims:
        # phys=2 decouples the boundary ranks from D (a coupled boundary
        # grows cores as D^4)
        g = parse_graph(mps_graph(n_qubits, dim=dim, phys=2))
        params, target = sweep_problem(g, torch.float32, dev)
        route = ("chain_sweep" if chain_overlap.fused_chain_supported(_chain_cores(g, params))
                 else "chain_scan")
        t0 = time.perf_counter()
        params, loss = sgd_step(g, params, target)
        float(loss)
        compile_s = time.perf_counter() - t0
        chain_overlap.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(bench_steps):
            params, loss = sgd_step(g, params, target)
        out = float(loss)  # the host read waits for the card
        dt = time.perf_counter() - t0
        launches = chain_overlap.launch_counts()
        sps = bench_steps / dt
        fl = network_fidelity_step_flops(g, "float32", gradient=True)
        tflops = sps * fl / 1e12
        results.append({
            "bond_dim": dim,
            "steps_per_sec": round(sps, 2),
            "flops_per_step": fl,
            "tflops": round(tflops, 4),
            "mxu_util": round(mxu_utilization(tflops, "float32"), 6),
            "compile_s": round(compile_s, 1),
            "final_loss": out,
            "route": route,
            "launches_per_step": {k: v / bench_steps for k, v in launches.items()},
        })
    best = max(results, key=lambda r: r["tflops"])
    return {
        "stage": "bond_sweep",
        "n_qubits": n_qubits,
        "bench_steps": bench_steps,
        "device": _platform(dev),
        "sweep": results,
        "peak_tflops": best["tflops"],
        "peak_bond_dim": best["bond_dim"],
        "peak_mxu_util": best["mxu_util"],
    }


def stage_fsdp_memory(
    n_qubits: int = 12, bond_dim: int = 32, model_sizes=(1, 2, 4, 8),
    device: DeviceLike = "cuda", **_
) -> Dict[str, Any]:
    """Model-STATE sharding memory curve: bytes of params + optimizer state
    per mesh position at fixed topology as the model axis grows
    (``parallel/fsdp.py``).  The reference package skips model axes larger
    than its device count; here the m positions of every point share
    ``device`` (one process), so the curve covers every m, and a position's
    bytes are its rows of the split stacks plus the replicated ones.  Each
    point takes one FSDP step and records its B1/B2 launches."""
    from ..graph import mps_graph, parse_graph
    from ..model.qctn import init_params
    from ..ops import chain_overlap
    from ..parallel import make_mesh
    from ..parallel.fsdp import group_shardings, make_fsdp_network_fit_step, stack_params

    dev = resolve_device(device)
    graph = parse_graph(mps_graph(n_qubits, dim=bond_dim))
    params = init_params(graph, 0, torch.float32, device=dev)
    target = init_params(graph, 1, torch.float32, device=dev)
    total_param_bytes = sum(v.numel() * v.element_size() for v in params.values())
    results = []
    for m in model_sizes:
        mesh = make_mesh({"model": m}, devices=[dev] * m)
        step, prepare, opt = make_fsdp_network_fit_step(graph, mesh)
        arrays = prepare(params)
        t_arrays = prepare(target)
        opt_state = opt.init(arrays)
        split = [bool(pl.spec) for pl in group_shardings(stack_params(graph, params, m), mesh)]
        # model state one position holds (params + momentum): its rows of
        # the split stacks, the replicated stacks whole
        per_pos = sum(a.numel() * a.element_size() // (m if s else 1)
                      for stacks in (arrays, opt_state.momentum)
                      for a, s in zip(stacks, split))
        chain_overlap.reset_launch_counts()
        arrays2, opt_state2, loss = step(arrays, opt_state, t_arrays)
        results.append({
            "model_axis": m,
            "model_state_bytes_per_device": per_pos,
            "loss": float(loss),
            "launches": chain_overlap.launch_counts(),
        })
    rec = {
        "stage": "fsdp_memory",
        "n_qubits": n_qubits,
        "bond_dim": bond_dim,
        "positions_share": str(dev),
        "replicated_param_bytes": total_param_bytes,
        "curve": results,
    }
    if len(results) >= 2:
        first, last = results[0], results[-1]
        rec["scaling"] = round(
            first["model_state_bytes_per_device"]
            / last["model_state_bytes_per_device"],
            2,
        )
        rec["mesh_growth"] = last["model_axis"] // first["model_axis"]
    return rec


def stage_util_peak(
    dims=(64, 256, 512), n_qubits: int = 16, flop_budget: float = 2e11,
    device: DeviceLike = "cuda", **_
) -> Dict[str, Any]:
    """Utilization operating point on the real training step: large-bond
    phys-2 MPS network-fidelity gradient steps (``bench/util_peak.py``)."""
    from .util_peak import measure

    dev = resolve_device(device)
    results = measure(list(dims), n_qubits, "float32", flop_budget, phys=2, device=dev)
    measured = [r for r in results if "tflops" in r]
    best = max(measured, key=lambda r: r["tflops"]) if measured else {}
    return {
        "stage": "util_peak",
        "device": _platform(dev),
        "sweep": results,
        "peak_tflops": best.get("tflops"),
        "peak_bond_dim": best.get("bond_dim"),
        "peak_practical_util": best.get("practical_util"),
    }


ALL_STAGES: Dict[str, Callable[..., Dict[str, Any]]] = {
    "1_env_audit": stage_env_audit,
    "2_matmul_peak": stage_matmul_peak,
    "3_memory_bandwidth": stage_memory_bandwidth,
    "3b_transpose_cost": stage_transpose_cost,
    "5_collectives": stage_collectives,
    "6_checkpoint_io": stage_checkpoint_io,
    "2b_dtype_policy": stage_dtype_policy,
    "6b_tn_workload": stage_tn_workload,
    "7_large_network": stage_large_network,
    "7b_bond_sweep": stage_bond_sweep,
    "7c_util_peak": stage_util_peak,
    "8_fsdp_memory": stage_fsdp_memory,
}
