"""Four-process ``torch.distributed`` dry run of the parallel layer.

Counterpart of ``tneq_tpu/bench/multiproc_dryrun.py``.  Exercises
``parallel/multihost.py`` start-up end to end (not just the parsing of the
environment): the parent spawns 4 worker processes with the launcher
variables (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``); each
calls ``initialize_multihost()``, builds the global ``{"data": 2,
"model": 2}`` mesh, one rank per position, and runs one sliced siamese
training step: the batch split over ``data``, the contraction bond-sliced
over ``model``, the gradient summed over both (``parallel/mp.py``).

A torch rank holds one mesh position, where a JAX process held four
devices: JAX's run is 2 processes × 4 virtual CPU devices on a
``{"data": 4, "model": 2}`` mesh, this one 4 ranks on ``{"data": 2,
"model": 2}``.  Every rank draws the same global batch from seed 0 and
contracts its rows (JAX's processes each contribute their half).

Run: ``python -m tneq_tpu_torch.bench.multiproc_dryrun [--device cpu]
[--backend gloo]`` (parent mode); prints one JSON line ``{"ok": true,
"n_processes": 4, "n_devices": 4, "mesh": ..., "loss": ...}``.  The ranks
share ``--device`` (default ``cuda``, the current card), so the backend is
``gloo`` by default: NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

__all__ = ["main", "worker"]

N_PROCESSES = 4
MESH = {"data": 2, "model": 2}
GLOBAL_BATCH = 8
TIMEOUT_S = 420


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(device: str, backend: str) -> int:
    """Child-process entry (the launcher variables set by the parent)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..graph import parse_graph, wall_graph
    from ..model.qctn import init_params
    from ..ops import measurement_matrices
    from ..ops.contract import abs_square
    from ..optim import sgdg
    from ..parallel import make_mesh, make_sliced_siamese_fn, shard_batch
    from ..parallel.multihost import initialize_multihost, is_main_process
    from ..train.losses import nll_loss
    from ..train.trainer import basis_states

    torch.set_num_threads(1)
    if not initialize_multihost(backend=backend):
        raise RuntimeError("initialize_multihost() found no launcher settings")
    try:
        mesh = make_mesh(MESH, devices=[device] * N_PROCESSES)
        dev = mesh.device()
        graph = parse_graph(wall_graph(4, layers=2, dim=2))
        params = init_params(graph, 0, torch.complex64, device=dev)
        states = basis_states(graph, dtype=torch.complex64, device=dev)
        optimizer = sgdg(0.05, momentum=0.9, stiefel=True)
        contraction = make_sliced_siamese_fn(graph, mesh, model_axis="model", data_axis="data")

        x = np.random.default_rng(0).normal(size=(GLOBAL_BATCH, graph.nqubits))
        x = shard_batch(torch.as_tensor(x, dtype=torch.float32), mesh)
        mx = measurement_matrices(x, 2).to(torch.complex64)
        measures = [mx[:, q] for q in range(graph.nqubits)]
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = nll_loss(abs_square(contraction(leaves, states, measures)))
        grads = contraction.reduce_gradients(
            dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
        with torch.no_grad():
            updates, _ = optimizer.update(grads, optimizer.init(params), params)
            new_params = {k: p + updates[k] for k, p in params.items()}
        val = float(loss.detach())
        if not (np.isfinite(val) and all(bool(torch.isfinite(v).all())
                                         for v in new_params.values())):
            raise RuntimeError(f"non-finite step: loss {val}")
        if is_main_process():
            print("RESULT " + json.dumps({
                "ok": True, "n_processes": dist.get_world_size(), "n_devices": mesh.size,
                "mesh": dict(mesh.shape), "loss": val, "device": str(dev),
                "backend": dist.get_backend(),
            }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="four-rank torch.distributed dry run")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--backend", default="gloo")
    args = p.parse_args(argv)
    port = _free_port()
    procs = []
    for rank in range(N_PROCESSES):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(N_PROCESSES), "RANK": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tneq_tpu_torch.bench.multiproc_dryrun", "--worker",
             "--device", args.device, "--backend", args.backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    result = None
    rc = 0
    for i, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            rc = 1
        if proc.returncode != 0:
            rc = 1
            sys.stderr.write(f"--- worker {i} rc={proc.returncode} ---\n{err}\n")
        for line in out.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
    if result is None:
        result = {"ok": False, "n_processes": N_PROCESSES}
        rc = rc or 1
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    if "--worker" in sys.argv:
        argv = [a for a in sys.argv[1:] if a != "--worker"]
        ns = argparse.ArgumentParser()
        ns.add_argument("--device", default="cuda")
        ns.add_argument("--backend", default="gloo")
        a = ns.parse_args(argv)
        sys.exit(worker(a.device, a.backend))
    sys.exit(main())
