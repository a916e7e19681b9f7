#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tneq_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, imports nothing of
JAX or ``tneq_tpu``, and prints one JSON line per phase:

1. setup — the card's name and power limit (``nvidia-smi``), the kernels
   built from ``tneq_tpu_torch/csrc`` with ``nvcc`` (build time), TF32 off;
2. kernels — B1/B2 (``csrc/chain_sweep.cu``, thread-block-cluster
   kernels) against their plain PyTorch versions on the card at n = 29
   sites, S in {9, 256, 1024}, with the tolerances stated below; their
   times (CUDA events around one call, median, and the card's own time from
   torch.profiler, also per site), their launch plans (cluster size,
   shared memory) and bounds;
3. bench — the ``bench.py`` training program on the port: 32-qubit, bond-16
   MPS, float32, plain SGD lr 1e-3 on −log F, 200 steps; step-0 loss against
   the port's plain path on the host, falling loss, launch counts
   (B1 = 3, B2 = 2 per step), steps/s;
4. experiment — the symmetry-breaking experiment, MPS topology, network
   fidelity, end to end (target → validate → prune), plus a 20-step
   validation fit held against the same fit on the host;
5. transfer_kernels — the transfer-sweep kernel, B3 (float32) and B4
   (complex64, ``csrc/transfer_step.cu``), against its plain version at
   (B, D, K) in {(130, 3, 2), (32, 3, 3), (512, 8, 4), (4096, 16, 4)}, and
   at the wide cores (32, 32, 32), (32, 64, 16) that it reads from global
   memory, n in {1, 5} sites, forward and the backward's d_env chain (the same
   kernel, sites reversed, cores transposed), with its plan, its times
   (CUDA events around one call, and the card's own time from
   torch.profiler, also per site), the bound of the whole sweep and, at
   n = 1, the time of the one ``torch.einsum`` call that computes a step;
6. born_rule — the Born-rule Trainer at full width: 8 qubits, bond 8,
   Hermite order 4, batch 512, float32, SGD-G, 200 steps; the losses of the
   first 20 steps against the host's loss at the card's cores, a falling
   loss, B3 = 2 launches per step (one 5-site sweep forward, one d_env
   sweep backward), B4 = 0;
7. cli — ``apps.train_single_node.main`` at its defaults (complex64, 8
   qubits, dim 3, batch 32, SGD-G), 200 steps; B4 = 2 launches per step,
   finite losses, the first 20 against the same run on the host; then
   ``--dim 32`` (complex64 cores of 256 KiB) for 3 steps, B4 = 2 per step;
8. brick — the reference experiment's default at full width: the 8-qubit,
   5-cell, rank-2 brick wall (35 cores), complex64, SGD-G, dense fidelity,
   the planted 20-core mask.  Its dense target (4^8 entries) against the
   host's from the same cores; the validation fit at its default budget
   (<= 4000 steps, lr 1) to 1 - F < 1e-3; the first 20 validation losses
   against the host's loss at the card's cores; one pass of the prune loop
   warm-started at the planted network, its prune budget cut to
   ``BRICK_PRUNE_STEPS``, which must prune exactly the planted cores, as
   the same pass on the host does; fit steps/s, launches per fit step and
   the device idle share from torch.profiler; then the experiment's CLI at
   4 qubits x 2 cells in a process of its own, on the card and on the
   host, with the same result.  This path runs no kernel of the port:
   every contraction is pairwise ``torch.einsum`` steps.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before the last line.  Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import replace

# f32 tolerances, as max|kernel - plain| / max|plain| per output (f: over
# sum|u_n * w|, the scale of the dot product).  Kernel and plain version do
# the same f32 arithmetic in another summation order; 29 rescaled sites of
# S-term sums stay within a few 1e-6 of each other.
TOL_KERNEL = 5e-5
TOL_STEP0 = 1e-4  # bench step-0 loss, card vs host, relative
TOL_FIT = 1e-4  # 20-step validation fit, card vs host
SWEEP_N = 29  # middle sites of the 32-qubit chain
SWEEP_BONDS = (3, 16, 32)  # S = 9 (ragged), 256 (bench), 1024 (the cap)
BENCH_STEPS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# B3/B4 against their plain versions, per site: the same f32 sums of at
# most D^2 K^2 = 4096 terms in another order
TOL_STEP = 2e-5
STEP_SHAPES = ((130, 3, 2), (32, 3, 3), (512, 8, 4), (4096, 16, 4))  # (B, D, K)
# cores of 256 KiB and more, which the plan reads from global memory:
# train_single_node --dim 32 (complex64), and D = 64, K = 16 (float32)
WIDE_SHAPES = ((32, 32, 32), (32, 64, 16))
WIDE_STEPS = 3  # steps of train_single_node --dim 32 in the cli phase
BORN_SHAPE = (512, 8, 4)  # the born_rule phase's transfer steps
CLI_SHAPE = (32, 3, 3)  # the cli phase's
BORN_STEPS = 200
CLI_STEPS = 200
CHECK_STEPS = 20  # card-vs-host comparisons of the two training phases
MIDDLE_STEPS = 5  # sites of the transfer sweep of an 8-qubit chain
# the brick phase: the reference CLI's planted mask of the 8 x 5 wall, and
# the cuts that keep the phase near 150 s (the defaults are 5000 prune
# steps and, for the CLI, 20 restarts).  The prune pass starts at the
# planted network, where each planted candidate is accepted at once and
# each other one stays far above tol after its 60 steps (1 - F >= 1e-2).
BRICK_MASK = [2, 3, 5, 8, 9, 12, 13, 14, 15, 17, 18, 20, 21, 23, 25, 26, 29, 31, 32, 33]
BRICK_PRUNE_STEPS = 60
BRICK_CLI_PRUNE_STEPS = 100
TOL_TARGET = 1e-5  # dense target, card vs host, max-abs-normalised
# 1 - F ~ 1e-3 at the validated cores, card vs host, absolute: F ~ 0.999 in
# float32 carries ~1e-7 of rounding per summation order
TOL_FIT_INFID = 5e-6

_KERNELS = {
    "chain_sweep_fwd": {
        "id": "B1",
        "replaces": "tneq_tpu/ops/chain_overlap.py:160",
    },
    "chain_sweep_bwd": {
        "id": "B2",
        "replaces": "tneq_tpu/ops/chain_overlap.py:224",
    },
    "transfer_step": {
        "id": "B3",
        "replaces": "tneq_tpu/ops/pallas_kernels.py:91",
    },
    "transfer_step_complex": {
        "id": "B4",
        "replaces": "tneq_tpu/ops/pallas_kernels.py:177",
    },
}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one ``fn()`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20):
    """Device time of one ``fn()``: the CUDA kernels it launches, summed by
    torch.profiler over ``reps`` calls after a warm-up; ``None`` where the
    trace shows no device time.  At small shapes the CUDA-event time of
    :func:`cuda_ms` is the host's time to issue the call, and this is the
    card's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            return total / 1e3 / reps
    return None


def _bound(nbytes: float, flops: float) -> dict:
    """Least time on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations"}


def sweep_bounds(n: int, S: int) -> dict:
    """B1/B2: each input read once, each output written once, over the
    work the sweep does."""
    fwd_bytes = 4 * (n * S * S + 2 * S + n * S + n + 2 + S)
    fwd_flops = 2 * n * S * S
    bwd_bytes = 4 * (S + n * S * S + n * S + n + n * S * S + S)
    bwd_flops = 3 * n * S * S
    return {"chain_sweep_fwd": _bound(fwd_bytes, fwd_flops),
            "chain_sweep_bwd": _bound(bwd_bytes, bwd_flops)}


def sweep_bound(n: int, B: int, D: int, K: int, complex_: bool) -> dict:
    """B3/B4 over an n-site sweep, env0 [B,D,D], a [n,D,K,D], mx [n,B,K,K]
    -> out [n,B,D,D]: bytes of the inputs and the outputs once; flops of
    the factorised step, 2 B (2 D^3 K + D^2 K^2) per site, four times as
    many for complex64."""
    elem = 8 if complex_ else 4
    nbytes = elem * (B * D * D + n * (D * K * D + B * K * K + B * D * D))
    flops = n * 2 * B * (2 * D ** 3 * K + D * D * K * K) * (4 if complex_ else 1)
    return _bound(nbytes, flops)


def rel_err(k, p, scale=None) -> float:
    denom = float(p.abs().max()) if scale is None else float(scale)
    return float((k - p).abs().max()) / max(denom, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_setup() -> dict:
    import torch

    from tneq_tpu_torch.ops import cuda_build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name in libs:
        print(f"--- nvcc log: {name} ---\n{cuda_build.build_log(name)}",
              file=sys.stderr, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    rec = {
        "phase": "setup",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "build_s": build_s,
        "libraries": sorted(str(p.name) for p in libs.values()),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(rec)
    return rec


def _random_sweep(bond: int, n: int, seed: int, dev):
    """u0, M, w of the M-form of two random max-abs-normalised chains with
    ``n`` middle sites, physical rank 2, bond ``bond`` (S = bond²)."""
    import numpy as np
    import torch

    from tneq_tpu_torch.ops.chain_overlap import chain_pair_to_mv

    rng = np.random.default_rng(seed)

    def core(*shape):
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)
        return x / x.abs().max()

    def chain():
        mids = torch.stack([core(bond, 2, 2, bond) for _ in range(n)])
        return core(2, 2, 2, bond), mids, core(bond, 2, 2, 2)

    v0, M, w = chain_pair_to_mv(chain(), chain())
    u0 = v0 / v0.abs().max()
    return u0.contiguous(), M.contiguous(), w.contiguous()


def phase_kernels() -> dict:
    import torch

    from tneq_tpu_torch.ops import chain_overlap as co

    dev = torch.device("cuda", 0)
    cases = []
    for bond in SWEEP_BONDS:
        S = bond * bond
        u0, M, w = _random_sweep(bond, SWEEP_N, seed=bond, dev=dev)
        kf = co._sweep_fwd_cuda(u0, M, w)
        pf = co._sweep_fwd_plain(u0, M, w)
        torch.cuda.synchronize()
        names = ("ustack", "scales", "f", "logsum", "ulast")
        err = {nm: rel_err(k, p) for nm, k, p in zip(names, kf, pf)}
        err["f"] = rel_err(kf[2], pf[2], scale=(pf[4] * w).abs().sum())
        r0 = (1.7 * w).contiguous()
        kb = co._sweep_bwd_cuda(r0, M, pf[0], pf[1])
        pb = co._sweep_bwd_plain(r0, M, pf[0], pf[1])
        torch.cuda.synchronize()
        err["dM"] = rel_err(kb[0], pb[0])
        err["du0"] = rel_err(kb[1], pb[1])
        abs_fwd = max(float((k - p).abs().max()) for k, p in zip(kf, pf))
        abs_bwd = max(float((k - p).abs().max()) for k, p in zip(kb, pb))
        calls = {
            "chain_sweep_fwd": (lambda: co._sweep_fwd_cuda(u0, M, w),
                                lambda: co._sweep_fwd_plain(u0, M, w)),
            "chain_sweep_bwd": (lambda: co._sweep_bwd_cuda(r0, M, pf[0], pf[1]),
                                lambda: co._sweep_bwd_plain(r0, M, pf[0], pf[1])),
        }
        times, plans = {}, {}
        for name, (kernel, plain) in calls.items():
            dms = device_ms(kernel)
            times[name] = {
                "ms": cuda_ms(kernel),
                "device_ms": dms,
                "per_site_device_ms": dms / SWEEP_N if dms else None,
                "plain_ms": cuda_ms(plain),
                "plain_device_ms": device_ms(plain),
            }
            cluster, strip, stages, tile_rows, smem = co._plan_for(
                M, backward=name == "chain_sweep_bwd")
            plans[name] = {"cluster": cluster, "strip": strip, "ring_stages": stages,
                           "tile_rows": tile_rows, "smem_bytes": smem}
        case = {"n": SWEEP_N, "S": S, "rel_err": err,
                "max_abs_err": {"chain_sweep_fwd": abs_fwd, "chain_sweep_bwd": abs_bwd},
                "times": times, "plans": plans, "bounds": sweep_bounds(SWEEP_N, S)}
        cases.append(case)
        bad = {k: v for k, v in err.items() if not v <= TOL_KERNEL}
        check(not bad, f"S={S}: kernel disagrees with plain version beyond "
                       f"{TOL_KERNEL}: {bad}")
    rec = {"phase": "kernels", "tolerance": TOL_KERNEL, "cases": cases}
    emit(rec)
    return rec


def _profile_steps(step, step_ms: float, steps: int = 5) -> dict:
    """Device time by kernel over a short window of ``step()`` calls
    (torch.profiler), and the device's idle share against ``step_ms``, the
    unprofiled wall time of one step; ``None`` where the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()  # keep one-time work out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_time_total and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = ev.device_time_total / 1e3 / steps  # ms per step
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "device_busy_ms_per_step": busy if busy else None,
        "device_idle_share": (1.0 - busy / step_ms) if busy else None,
        "kernel_launches_per_step": sum(
            ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA) / steps,
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top} if top else None,
    }


def phase_bench(smi: str) -> dict:
    import torch

    from tneq_tpu_torch.bench.headline import build_problem, sgd_step
    from tneq_tpu_torch.model.qctn import params_from_numpy
    from tneq_tpu_torch.ops.chain_overlap import launch_counts, reset_launch_counts
    from tneq_tpu_torch.train.network_fit import network_log_fidelity

    graph, params_np, target_np = build_problem()
    p_host = params_from_numpy(params_np, "cpu")
    t_host = params_from_numpy(target_np, "cpu")
    with torch.no_grad():
        loss0_host = float(-network_log_fidelity(graph, p_host, t_host))
    params = params_from_numpy(params_np, "cuda")
    target = params_from_numpy(target_np, "cuda")
    _, loss0 = sgd_step(graph, params, target)
    loss0 = float(loss0)
    check(math.isfinite(loss0), f"step-0 loss is not finite: {loss0}")
    rel0 = abs(loss0 - loss0_host) / max(abs(loss0_host), 1e-30)
    check(rel0 <= TOL_STEP0, f"step-0 loss {loss0} vs host {loss0_host} (rel {rel0})")

    p = params
    for _ in range(3):  # warm-up
        p, _ = sgd_step(graph, p, target)
    torch.cuda.synchronize()
    p = params
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(BENCH_STEPS):
        p, loss = sgd_step(graph, p, target)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite loss in the bench run")
    check(float(losses[-1]) < float(losses[0]),
          f"loss did not fall: {float(losses[0])} -> {float(losses[-1])}")
    check(counts["chain_sweep_fwd"] == 3 * BENCH_STEPS
          and counts["chain_sweep_bwd"] == 2 * BENCH_STEPS,
          f"launch counts {counts}, expected B1 = {3 * BENCH_STEPS}, "
          f"B2 = {2 * BENCH_STEPS}")
    box = {"p": p}

    def one_step():
        box["p"], _ = sgd_step(graph, box["p"], target)

    prof = _profile_steps(one_step, dt / BENCH_STEPS * 1e3)
    rec = {
        "phase": "bench",
        "program": "bench.py::_build_step_fn on tneq_tpu_torch: 32q MPS, "
                   "bond 16, phys 16, float32, SGD lr 1e-3 on -log F",
        "steps": BENCH_STEPS,
        "steps_per_s": BENCH_STEPS / dt,
        "ms_per_step": dt / BENCH_STEPS * 1e3,
        "loss_step0": loss0,
        "loss_step0_host": loss0_host,
        "loss_step0_rel_err": rel0,
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "launches": counts,
        "launches_per_step": {k: v / BENCH_STEPS for k, v in counts.items()},
        "profile": prof,
        "card": smi,
    }
    emit(rec)
    return rec


def _experiment_config(**kw):
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import SymmetryBreakingConfig

    # Budgets from a host rehearsal of this configuration: validation
    # converges near 1400 steps, and the planted cores refit within ~320
    # steps; the other candidates spend the whole prune budget.  The exit
    # is tested every 16 steps, so the host runs ahead of the card.
    base = dict(
        n_qubits=12, rank=2, topology="mps", bond_dim=16,
        fidelity_mode="network", dtype=torch.float32, optimizer="adam",
        validate_lr=2e-2, validate_steps=2000, prune_lr=5e-2, prune_steps=480,
        max_outer_iterations=1, tol=1e-3, fit_jit_scope="step",
        fit_sync_every=16, device="cuda",
    )
    base.update(kw)
    return SymmetryBreakingConfig(**base)


def phase_experiment() -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        make_experiment, symmetry_breaking, target_tensor_init,
        validate_target_tensor,
    )
    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops.chain_overlap import launch_counts, reset_launch_counts

    cfg = _experiment_config()
    exp = make_experiment(cfg)
    planted = [3, 7]
    reset_launch_counts()
    t0 = time.perf_counter()
    target = target_tensor_init(exp, planted, 1)
    ok, fid, vsteps, fitted = validate_target_tensor(exp, target, 2, return_params=True)
    pruned, attempts = symmetry_breaking(exp, target, shuffle_seed=0,
                                         warm_params=fitted, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    check(math.isfinite(fid), f"validation fidelity is not finite: {fid}")
    check(counts["chain_sweep_fwd"] > 0 and counts["chain_sweep_bwd"] > 0,
          f"the experiment did not run the sweep kernels: {counts}")

    # the same 20-step validation fit on the card and on the host
    short = replace(cfg, validate_steps=20)
    t_np = params_to_numpy(target[0])
    mask_np = target[1].cpu().numpy()
    p_np = params_to_numpy(init_params(exp.graph, 5, torch.float32, device="cpu"))
    fits = {}
    for where in ("cuda", "cpu"):
        e = make_experiment(replace(short, device=where))
        res = e.run_fit(
            e.validate_fit, params_from_numpy(p_np, where), e.mask_vector([]),
            (params_from_numpy(t_np, where), torch.as_tensor(mask_np, device=where)),
        )
        fits[where] = (float(-torch.log1p(-res.infidelity)), int(res.steps),
                       params_to_numpy(res.params))
    nlf_d, nlf_h = fits["cuda"][0], fits["cpu"][0]
    nlf_err = abs(nlf_d - nlf_h) / max(abs(nlf_h), 1e-30)
    p_err = max(
        float(np.abs(fits["cuda"][2][k] - fits["cpu"][2][k]).max())
        / max(float(np.abs(fits["cpu"][2][k]).max()), 1e-30)
        for k in fits["cpu"][2]
    )
    check(fits["cuda"][1] == fits["cpu"][1] == 20,
          f"20-step fit steps: card {fits['cuda'][1]}, host {fits['cpu'][1]}")
    check(nlf_err <= TOL_FIT and p_err <= TOL_FIT,
          f"20-step fit card vs host: -log F rel {nlf_err}, params rel {p_err}")
    rec = {
        "phase": "experiment",
        "config": {"n_qubits": cfg.n_qubits, "bond_dim": cfg.bond_dim,
                   "rank": cfg.rank, "dtype": "float32",
                   "optimizer": cfg.optimizer,
                   "validate_lr": cfg.validate_lr,
                   "validate_steps": cfg.validate_steps,
                   "prune_lr": cfg.prune_lr,
                   "prune_steps": cfg.prune_steps,
                   "sync_every": cfg.fit_sync_every, "planted": planted},
        "validated": ok,
        "fidelity": fid,
        "validate_steps_taken": vsteps,
        "pruned": sorted(pruned),
        "planted_recovered": sorted(set(pruned) & set(planted)),
        "attempts": attempts,
        "seconds": dt,
        "launches": counts,
        "fit20": {"neg_log_f_card": nlf_d, "neg_log_f_host": nlf_h,
                  "neg_log_f_rel_err": nlf_err, "params_rel_err": p_err},
    }
    emit(rec)
    return rec


def _sweep_inputs(n: int, B: int, D: int, K: int, complex_: bool, seed: int, dev):
    """env0 [B,D,D], a [n,D,K,D], mx [n,B,K,K] from numpy, max-abs 1 (a
    scaled by 1/(D K), so the envs of a sweep stay of order one)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        x = rng.standard_normal(shape)
        if complex_:
            x = x + 1j * rng.standard_normal(shape)
        x = scale * x / np.abs(x).max()
        return torch.as_tensor(x.astype(np.complex64 if complex_ else np.float32), device=dev)

    return mk(B, D, D), mk(n, D, K, D, scale=1.0 / (D * K)), mk(n, B, K, K)


def phase_transfer_kernels() -> dict:
    import torch

    from tneq_tpu_torch.ops import transfer_step as ts

    dev = torch.device("cuda", 0)
    cases = []
    for B, D, K in STEP_SHAPES + WIDE_SHAPES:
        for n in (1, MIDDLE_STEPS):
            for name, complex_ in (("transfer_step", False), ("transfer_step_complex", True)):
                plain = ts.transfer_sweep_complex_plain if complex_ else ts.transfer_sweep_plain
                env, a, mx = _sweep_inputs(n, B, D, K, complex_, seed=B + D + n, dev=dev)
                g = _sweep_inputs(1, B, D, K, complex_, seed=B + D + n + 1, dev=dev)[0]
                kf, pf = ts._launch(env, a, mx, complex_), plain(env, a, mx)
                # the backward's d_env chain: the same kernel, sites reversed
                kb = ts._launch(g, a, mx, complex_, backward=True)
                pb = plain(g, a, mx, backward=True)
                torch.cuda.synchronize()
                err = {"fwd": max(rel_err(k, p) for k, p in zip(kf, pf)),
                       "d_env": max(rel_err(k, p) for k, p in zip(kb, pb))}
                calls = {
                    "": lambda: ts._launch(env, a, mx, complex_),
                    "bwd_": lambda: ts._launch(g, a, mx, complex_, backward=True),
                    "plain_": lambda: plain(env, a, mx),
                }
                if n == 1:  # one torch.einsum computes one step
                    bra = a[0].conj() if complex_ else a[0]
                    calls["library_"] = lambda: torch.einsum(
                        "zab,akc,zkl,bld->zcd", env, a[0], mx[0], bra)
                times = {f"{k}ms": cuda_ms(fn) for k, fn in calls.items()}
                times.update({f"{k}device_ms": device_ms(fn) for k, fn in calls.items()})
                case = {
                    "kernel": name, "n": n, "B": B, "D": D, "K": K,
                    "plan": ts.kernel_plan(B, D, K, D, env.dtype, n)._asdict(),
                    "rel_err": err,
                    "max_abs_err": max(float((kf - pf).abs().max()),
                                       float((kb - pb).abs().max())),
                    **times,
                    "library_ms": times.get("library_ms"),
                    "library_device_ms": times.get("library_device_ms"),
                    "per_site_device_us": (times["device_ms"] * 1e3 / n
                                           if times["device_ms"] else None),
                    "bwd_per_site_device_us": (times["bwd_device_ms"] * 1e3 / n
                                               if times["bwd_device_ms"] else None),
                    **sweep_bound(n, B, D, K, complex_),
                }
                cases.append(case)
                bad = {k: v for k, v in err.items() if not v <= TOL_STEP}
                check(not bad, f"{name} at n = {n}, (B, D, K) = {(B, D, K)} disagrees "
                               f"with its plain version beyond {TOL_STEP}: {bad}")
    rec = {"phase": "transfer_kernels", "tolerance": TOL_STEP, "cases": cases}
    emit(rec)
    return rec


def phase_born_rule(smi: str) -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import transfer_step as ts
    from tneq_tpu_torch.train.data import gaussian_batches
    from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig, basis_states

    B, D, K = BORN_SHAPE
    graph = parse_graph(mps_graph(8, D, phys=K))
    p_np = params_to_numpy(init_params(graph, 0, torch.float32, device="cpu"))

    def setup(where: str, steps: int):
        tr = Trainer(graph, config=TrainingConfig(max_steps=steps, log_every=0),
                     dtype=torch.float32, device=where)
        return (tr, gaussian_batches(4, B, 8, seed=0, device=where),
                basis_states(graph, dtype=torch.float32, device=where))

    # The first steps on the card, keeping their cores; the host's loss at
    # those cores must equal the card's.  (A free-running host trajectory
    # parts from the card's: float32 Born-rule probabilities are tiny
    # differences of large terms, and two summation orders differ past 1e-4
    # after a few Stiefel steps.  It is reported, not checked.)
    tc, data_c, states_c = setup("cuda", CHECK_STEPS)
    th, data_h, states_h = setup("cpu", CHECK_STEPS)
    params = params_from_numpy(p_np, "cuda")
    opt = tc.optimizer.init(params)
    card, host_at_card = [], []
    for i in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, loss = tc.train_step(params, opt, states_c, data_c[i % 4])
        card.append(float(loss))
        with torch.no_grad():
            host_at_card.append(float(th.loss(params_from_numpy(cores, "cpu"), states_h,
                                              data_h[i % 4])))
    rel_tf = [abs(c - h) / abs(h) for c, h in zip(card, host_at_card)]
    check(max(rel_tf) <= TOL_STEP0,
          f"born_rule: card loss vs host loss at the same cores, rel {max(rel_tf)}")
    _, host_free = th.fit(params_from_numpy(p_np, "cpu"), data_h, states=states_h,
                          verbose=False)

    # the main run: the reference loop on the card
    tm, _, _ = setup("cuda", BORN_STEPS)
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    params, stats = tm.fit(params_from_numpy(p_np, "cuda"), data_c, states=states_c,
                           verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    losses = np.array(stats.losses)
    check(bool(np.isfinite(losses).all()), "born_rule: non-finite loss")
    check(losses[-4:].mean() < losses[:4].mean(),
          f"born_rule: loss did not fall: {losses[:4].mean()} -> {losses[-4:].mean()}")
    per_step = 2  # one sweep forward, one d_env sweep backward
    check(counts["transfer_step"] == per_step * BORN_STEPS
          and counts["transfer_step_complex"] == 0,
          f"born_rule launch counts {counts}, expected B3 = {per_step * BORN_STEPS}, B4 = 0")
    box = {"p": params, "o": tm.optimizer.init(params), "i": 0}

    def one_step():
        box["p"], box["o"], _ = tm.train_step(box["p"], box["o"], states_c,
                                              data_c[box["i"] % 4])
        box["i"] += 1

    prof = _profile_steps(one_step, dt / BORN_STEPS * 1e3)
    rec = {
        "phase": "born_rule",
        "program": "Trainer on mps_graph(8, 8, phys=4), float32, TrainingConfig() "
                   "(sgdg lr 1e-2 momentum 0.9), gaussian_batches(4, 512, 8, seed=0)",
        "strategy": tm.strategy,
        "steps": BORN_STEPS,
        "steps_per_s": BORN_STEPS / dt,
        "ms_per_step": dt / BORN_STEPS * 1e3,
        "loss_first4_mean": float(losses[:4].mean()),
        "loss_last4_mean": float(losses[-4:].mean()),
        "losses_every_20": [float(x) for x in losses[::20]],
        "first_losses_card": card,
        "host_loss_at_card_cores_rel_err_max": max(rel_tf),
        "free_running_host_rel_err": [abs(c - h) / abs(h)
                                      for c, h in zip(card, host_free.losses)],
        "launches": counts,
        "launches_per_step": {k: v / BORN_STEPS for k, v in counts.items()},
        "profile": prof,
        "card": smi,
    }
    emit(rec)
    return rec


def phase_cli(smi: str) -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.train_single_node import main as cli_main
    from tneq_tpu_torch.ops import transfer_step as ts

    ts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        stats = cli_main(["--steps", str(CLI_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        host = cli_main(["--steps", str(CHECK_STEPS), "--device", "cpu"])
    losses = np.array(stats.losses)
    check(bool(np.isfinite(losses).all()), "cli: non-finite loss")
    per_step = 2  # one sweep forward, one d_env sweep backward
    check(counts["transfer_step_complex"] == per_step * CLI_STEPS
          and counts["transfer_step"] == 0,
          f"cli launch counts {counts}, expected B4 = {per_step * CLI_STEPS}, B3 = 0")
    rel = [abs(c - h) / abs(h) for c, h in zip(stats.losses, host.losses)]
    check(max(rel) <= TOL_STEP0, f"cli: first {CHECK_STEPS} losses card vs host, rel {max(rel)}")
    # --dim 32: complex64 cores of 256 KiB, which B4's plan reads from global
    # memory (its sweeps are held against the plain version in the
    # transfer_kernels phase)
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        wide = cli_main(["--dim", "32", "--steps", str(WIDE_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    dt_wide = time.perf_counter() - t0
    wide_counts = ts.launch_counts()
    check(bool(np.isfinite(wide.losses).all()), "cli --dim 32: non-finite loss")
    check(wide_counts == {"transfer_step": 0, "transfer_step_complex": per_step * WIDE_STEPS},
          f"cli --dim 32 launch counts {wide_counts}, expected B4 = {per_step * WIDE_STEPS}")
    clip = float(-np.log(np.float32(1e-10)))
    rec = {
        "phase": "cli",
        "program": "apps.train_single_node.main defaults: mps 8 qubits, dim 3, "
                   "complex64, batch 32 x 4 batches, sgdg lr 1e-2 momentum 0.9",
        "steps": CLI_STEPS,
        "seconds": dt,
        "steps_per_s": CLI_STEPS / dt,
        "losses_every_10": [float(x) for x in losses[::10]],
        "loss_last": float(losses[-1]),
        "share_at_clip": float(np.isclose(losses, clip, rtol=1e-6).mean()),
        "host_rel_err_max": max(rel),
        "launches": counts,
        "launches_per_step": {k: v / CLI_STEPS for k, v in counts.items()},
        "wide": {"argv": ["--dim", "32", "--steps", str(WIDE_STEPS)], "seconds": dt_wide,
                 "losses": [float(x) for x in wide.losses], "launches": wide_counts},
        "card": smi,
    }
    emit(rec)
    return rec


def phase_brick(smi: str) -> dict:
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig, make_experiment, symmetry_breaking, target_tensor_init,
        validate_target_tensor,
    )
    from tneq_tpu_torch.model.qctn import params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import chain_overlap, transfer_step
    from tneq_tpu_torch.train.fit import identity_cores, masked_cores

    cfg = SymmetryBreakingConfig(device="cuda", max_outer_iterations=1,
                                 prune_steps=BRICK_PRUNE_STEPS)
    exp = make_experiment(cfg)
    host = make_experiment(replace(cfg, device="cpu"))
    check(exp.graph.ncores == 35 and cfg.dtype == torch.complex64,
          f"brick: {exp.graph.ncores} cores in {cfg.dtype}")
    chain_overlap.reset_launch_counts()
    transfer_step.reset_launch_counts()
    t_start = time.perf_counter()

    # the dense target from the same cores (drawn on the host), then the
    # validation's fresh cores from the same generator, as the CLI draws them
    gen = torch.Generator().manual_seed(0)
    target = target_tensor_init(exp, BRICK_MASK, gen)
    torch.cuda.synchronize()
    target_h = target_tensor_init(host, BRICK_MASK, 0)
    check(tuple(target.shape) == (2,) * 16 and bool(torch.isfinite(target).all()),
          f"brick: target of shape {tuple(target.shape)}")
    target_err = rel_err(target.cpu(), target_h)
    check(target_err <= TOL_TARGET, f"brick: target card vs host, rel {target_err}")

    # validation at the default budget
    t0 = time.perf_counter()
    ok, fid, vsteps, fitted = validate_target_tensor(exp, target, gen, return_params=True)
    torch.cuda.synchronize()
    dt_val = time.perf_counter() - t0
    check(ok and 1.0 - fid < 1e-3, f"brick: validation 1 - F = {1.0 - fid} in {vsteps} steps")

    # the first validation steps on the card, keeping their cores; the
    # host's 1 - F at those cores must equal the card's
    dc, dh = exp.validate_fit.drivers, host.validate_fit.drivers
    params = exp.init_params(2)
    opt = dc.optimizer.init(params)
    mask_c, mask_h = exp.mask_vector([]), host.mask_vector([])
    card, host_at_card = [], []
    for _ in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, infid = dc.step(params, opt, mask_c, target)
        card.append(float(infid))
        p_h = params_from_numpy(cores, "cpu")
        host_at_card.append(float(dh.step(p_h, dh.optimizer.init(p_h), mask_h, target_h)[2]))
    rel_first = [abs(c - h) / abs(h) for c, h in zip(card, host_at_card)]
    check(max(rel_first) <= TOL_STEP0,
          f"brick: card 1 - F vs host 1 - F at the same cores, rel {max(rel_first)}")
    # from a random start F ~ 4^-8, so 1 - F sits near 1 for those steps;
    # at the validated cores 1 - F ~ 1e-3 and the two must agree in absolute
    infid_fit = float(dc.step(fitted, dc.optimizer.init(fitted), mask_c, target)[2])
    p_h = params_from_numpy(params_to_numpy(fitted), "cpu")
    infid_fit_h = float(dh.step(p_h, dh.optimizer.init(p_h), mask_h, target_h)[2])
    check(abs(infid_fit - infid_fit_h) <= TOL_FIT_INFID,
          f"brick: 1 - F at the validated cores, card {infid_fit} vs host {infid_fit_h}")

    # one pass of the prune loop, warm-started at the planted network: the
    # target's own cores (drawn again from seed 0) with identities in the
    # planted places.  It must return the planted set, in the host's order.
    def planted(e):
        idents = {k: torch.as_tensor(v).to(device=e.device, dtype=cfg.dtype)
                  for k, v in identity_cores(e.graph, cfg.dtype).items()}
        return masked_cores(e.init_params(0), e.mask_vector(BRICK_MASK), idents,
                            e.graph.core_names, cfg.dtype)

    t0 = time.perf_counter()
    pruned, attempts = symmetry_breaking(exp, target, shuffle_seed=0, warm_params=planted(exp),
                                         verbose=False)
    torch.cuda.synchronize()
    dt_prune = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    kernel_launches = {**chain_overlap.launch_counts(), **transfer_step.launch_counts()}
    t0 = time.perf_counter()
    pruned_h, attempts_h = symmetry_breaking(host, target_h, shuffle_seed=0,
                                             warm_params=planted(host), verbose=False)
    dt_prune_h = time.perf_counter() - t0
    check(sorted(pruned) == BRICK_MASK and (pruned, attempts) == (pruned_h, attempts_h),
          f"brick: the prune pass pruned {pruned} in {attempts} attempts on the card, "
          f"{pruned_h} in {attempts_h} on the host; planted {BRICK_MASK}")

    box = {"p": fitted, "o": dc.optimizer.init(fitted)}

    def one_step():
        box["p"], box["o"], m = dc.step(box["p"], box["o"], mask_c, target)
        float(m)  # the exit test's host sync, as in the fit loop

    prof = _profile_steps(one_step, dt_val / vsteps * 1e3)

    # the experiment's CLI, in a process of its own, on the card and on the
    # host: the same best pruned set (at 100 prune steps every candidate
    # stays far above tol: 1 - F >= 0.2 on the host)
    cli = [sys.executable, "-m", "tneq_tpu_torch.apps.symmetry_breaking", "--n-qubits", "4",
           "--n-cells", "2", "--restarts", "1", "--prune-steps", str(BRICK_CLI_PRUNE_STEPS)]
    best = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = subprocess.run(cli + ["--device", where], capture_output=True, text=True,
                             timeout=400)
        if where == "cuda":
            dt_cli = time.perf_counter() - t0
        print(out.stdout, out.stderr, sep="\n", file=sys.stderr, flush=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("best: pruned ")]
        check(out.returncode == 0 and len(lines) == 1,
              f"brick: the CLI on {where} exited {out.returncode}")
        best[where] = lines[0]
    check(best["cuda"] == best["cpu"],
          f"brick: the CLI's result on the card, {best['cuda']!r}, is not the host's, "
          f"{best['cpu']!r}")
    rec = {
        "phase": "brick",
        "program": "apps.symmetry_breaking defaults: brick wall 8 qubits x 5 cells, rank 2, "
                   "complex64, sgdg (validate lr 1, <= 4000 steps; prune lr 1e-2), dense "
                   "fidelity, tol 1e-3, planted mask of the reference CLI",
        "reduced": {"prune_steps": BRICK_PRUNE_STEPS, "max_outer_iterations": 1,
                    "cli": {"prune_steps": BRICK_CLI_PRUNE_STEPS, "restarts": 1}},
        "target_rel_err": target_err,
        "validated": ok,
        "validate_infidelity": 1.0 - fid,
        "validate_steps": vsteps,
        "validate_seconds": dt_val,
        "fit_steps_per_s": vsteps / dt_val,
        "first_infidelities_card": card,
        "host_at_card_rel_err_max": max(rel_first),
        "validated_infidelity_card_host": [infid_fit, infid_fit_h],
        "prune_warm_start": "the planted network",
        "pruned": sorted(pruned),
        "attempts": attempts,
        "prune_seconds": dt_prune,
        "host_prune_seconds": dt_prune_h,
        "seconds": seconds,
        "port_kernel_launches": kernel_launches,
        "profile": prof,
        "cli_seconds": dt_cli,
        "cli_best": best["cuda"],
        "card": smi,
    }
    emit(rec)
    return rec


def kernels_line(kern: dict, bench: dict, transfer: dict, born: dict, cli: dict) -> dict:
    main_case = next(c for c in kern["cases"] if c["S"] == 256)
    rows = []
    for name in ("chain_sweep_fwd", "chain_sweep_bwd"):
        meta = _KERNELS[name]
        rows.append({
            "name": name,
            "id": meta["id"],
            "route": "cuda",
            "source": "tneq_tpu_torch/csrc/chain_sweep.cu",
            "replaces": meta["replaces"],
            "launches": bench["launches"][name],
            "launches_per_step": bench["launches_per_step"][name],
            "max_abs_err": main_case["max_abs_err"][name],
            "ms": main_case["times"][name]["ms"],
            "plain_ms": main_case["times"][name]["plain_ms"],
            "bound_ms": main_case["bounds"][name]["bound_ms"],
            "bound_by": main_case["bounds"][name]["bound_by"],
            "library_ms": None,
            "device_ms": main_case["times"][name]["device_ms"],
            "plain_device_ms": main_case["times"][name]["plain_device_ms"],
            "cluster": main_case["plans"][name]["cluster"],
            "shape": {"n": main_case["n"], "S": main_case["S"]},
        })
    for name, run, shape in (("transfer_step", born, BORN_SHAPE),
                             ("transfer_step_complex", cli, CLI_SHAPE)):
        meta = _KERNELS[name]
        # the sweep as the main path launches it, and its one-site case
        case, one = (next(c for c in transfer["cases"]
                          if c["kernel"] == name and c["n"] == n
                          and (c["B"], c["D"], c["K"]) == shape)
                     for n in (MIDDLE_STEPS, 1))
        rows.append({
            "name": name,
            "id": meta["id"],
            "route": "cuda",
            "source": "tneq_tpu_torch/csrc/transfer_step.cu",
            "replaces": meta["replaces"],
            "launches": run["launches"][name],
            "launches_per_step": run["launches_per_step"][name],
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            # no one PyTorch call computes a sweep of n > 1 sites; one step
            # is one torch.einsum, timed at n = 1
            "library_ms": None,
            "device_ms": case["device_ms"],
            "bwd_ms": case["bwd_ms"],
            "bwd_device_ms": case["bwd_device_ms"],
            "per_site_device_us": case["per_site_device_us"],
            "plain_device_ms": case["plain_device_ms"],
            "one_site": {k: one[k] for k in ("ms", "device_ms", "library_ms",
                                             "library_device_ms", "bound_ms")},
            "plan": case["plan"],
            "shape": {"n": MIDDLE_STEPS, "B": shape[0], "D": shape[1], "K": shape[2]},
        })
    return {"kernels": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on the card", file=sys.stderr)
        return 2
    try:
        import tneq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    try:
        setup = phase_setup()
        kern = phase_kernels()
        bench = phase_bench(setup["nvidia_smi"])
        phase_experiment()
        transfer = phase_transfer_kernels()
        born = phase_born_rule(setup["nvidia_smi"])
        cli = phase_cli(setup["nvidia_smi"])
        phase_brick(setup["nvidia_smi"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    emit(kernels_line(kern, bench, transfer, born, cli))
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
