"""Utilization operating point: a REAL training step at large bond dim.

Counterpart of ``tneq_tpu/bench/util_peak.py::measure``: the network-
fidelity gradient step (``train/network_fit.py``, the headline bench's
loss) on a phys-2 MPS chain across a bond-dimension sweep, with the
achieved TFLOP/s, its share of the H100's peak for the dtype
(``flops.mxu_utilization``) and of the card's measured bf16 matmul
ceiling (``flops.practical_utilization``).  Plain SGD (lr 1e-3) steps run
eagerly; a point's ``compile_s`` is its first step's seconds (kernel
builds, contraction plans, allocator), and the timed steps end in a host
read of the loss, which waits for the card.

Not ported: the reference package's alarm, child process and first fetch,
which are its TPU channel protocol.

Usage: ``python -m tneq_tpu_torch.bench.util_peak [--device cpu] [--dims 64,256,512]``
prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["measure", "main"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sweep_problem(graph, dtype: torch.dtype, device, seed: int = 0):
    """``(params, target)`` on ``device`` in ``dtype``: the target drawn by
    ``init_params`` on the host, the params the target plus 0.01 of numpy
    normal noise (the headline bench's problem, ``bench/headline.py``)."""
    from ..model.qctn import init_params, params_from_numpy, params_to_numpy

    target = params_to_numpy(init_params(graph, seed, torch.float32, device="cpu"))
    rng = np.random.default_rng(seed + 1)
    params = {n: (t + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
              for n, t in sorted(target.items())}
    return (params_from_numpy(params, device, dtype=dtype),
            params_from_numpy(target, device, dtype=dtype))


def measure(dims, n_qubits: int, dtype_name: str, flop_budget: float,
            phys: int = 2, device: DeviceLike = "cuda") -> List[dict]:
    """One record per bond dimension in ``dims`` (a failed point records
    its ``error`` and the sweep goes on)."""
    from ..graph import mps_graph, parse_graph
    from .flops import mxu_utilization, network_fidelity_step_flops, practical_utilization
    from .headline import sgd_step

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    results = []
    for dim in dims:
        # physical legs stay small (default 2); only the BOND grows — the
        # canonical MPS whose transfer steps are [D,D]x[D,phys^2·D]
        # matmuls (a dim-coupled boundary grows cores as dim^4)
        g = parse_graph(mps_graph(n_qubits, dim=dim, phys=min(phys, dim)))
        fl = network_fidelity_step_flops(g, dtype_name, gradient=True)
        # fixed FLOP budget per sweep point -> every point times a
        # comparable chunk of device work regardless of D
        steps_n = int(max(3, min(2000, flop_budget / fl)))
        try:
            params, target = sweep_problem(g, dtype, dev)
            t0 = time.time()
            params, loss = sgd_step(g, params, target)
            float(loss)
            compile_s = time.time() - t0
            t0 = time.time()
            for _ in range(steps_n):
                params, loss = sgd_step(g, params, target)
            out = float(loss)  # the host read waits for the card
            dt = time.time() - t0
        except Exception as e:
            # one dim failing (e.g. out of memory) must not sink the sweep;
            # record and continue with the next point
            log(f"D={dim} failed: {type(e).__name__}: {str(e)[:120]}")
            results.append({"bond_dim": dim, "error": f"{type(e).__name__}: {str(e)[:200]}"})
            continue
        sps = steps_n / dt
        tflops = sps * fl / 1e12
        rec = {
            "bond_dim": dim,
            "steps": steps_n,
            "steps_per_sec": round(sps, 3),
            "flops_per_step": fl,
            "tflops": round(tflops, 3),
            "mxu_util": round(mxu_utilization(tflops, dtype_name), 4),
            "practical_util": round(practical_utilization(tflops), 4),
            "compile_s": round(compile_s, 1),
            "wall_s": round(dt, 2),
            "final_loss": out,
        }
        log(f"D={dim}: {rec['tflops']} TFLOP/s "
            f"({100 * rec['mxu_util']:.1f}% of the H100 {dtype_name} peak, "
            f"{100 * rec['practical_util']:.1f}% of the measured bf16 matmul "
            f"ceiling), {rec['steps_per_sec']} steps/s, first step {compile_s:.1f}s")
        results.append(rec)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=str, default="16,64,256,512,1024")
    p.add_argument("--n-qubits", type=int, default=16)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--phys", type=int, default=2,
                   help="physical (boundary) leg rank; bonds carry --dims")
    p.add_argument("--flop-budget", type=float, default=4e13,
                   help="timed FLOPs per sweep point (sets the step count)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    dims = [int(d) for d in args.dims.split(",")]
    results = measure(dims, args.n_qubits, args.dtype, args.flop_budget,
                      phys=args.phys, device=dev)
    measured = [r for r in results if "mxu_util" in r]
    if not measured:
        print(json.dumps({"ok": False, "sweep": results}))
        return 1
    best = max(measured, key=lambda r: r["mxu_util"])
    print(json.dumps({
        "bench": "util_peak",
        "workload": f"network_fidelity_grad_step_{args.n_qubits}q_mps_phys{args.phys}",
        "dtype": args.dtype,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "sweep": results,
        "peak_tflops": best["tflops"],
        "peak_mxu_util": best["mxu_util"],
        "peak_practical_util": best["practical_util"],
        "peak_bond_dim": best["bond_dim"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
