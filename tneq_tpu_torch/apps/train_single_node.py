"""Single-node likelihood training CLI.

Counterpart of ``tneq_tpu/apps/train_single_node.py``: generate a Gaussian
dataset, build Hermite measurement operators, and train the QCTN cores with
Stiefel SGD to maximise the data likelihood.  Same arguments and prints,
plus ``--device`` (default ``cuda``)::

    python -m tneq_tpu_torch.apps.train_single_node --device cpu --steps 20

``--save`` waits for the checkpoint I/O (ROADMAP A, item 2) and
``--profile`` for ``utils/profiling.py`` (item 12); both raise.  MPS chains
take the transfer sweep, the other graph types the pairwise einsum path
(``ops/compiler.compile_siamese``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph.generators import example_graph
from ..model.qctn import QCTN
from ..train.trainer import Trainer, TrainingConfig, basis_states

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Single-node QCTN likelihood training")
    p.add_argument("--graph-type", default="mps",
                   choices=["mps", "tree", "wall", "wall_col"])
    p.add_argument("--num-qubits", type=int, default=8)
    p.add_argument("--dim", type=int, default=3, help="bond/physical rank")
    p.add_argument("--K", type=int, default=None,
                   help="Hermite order (default: = dim)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-batches", type=int, default=4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--method", default="sgdg")
    p.add_argument("--dtype", default="complex64",
                   choices=["complex64", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", type=str, default=None,
                   help="safetensors path for the trained cores")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a profiler trace of the run")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    if args.profile:
        raise NotImplementedError(
            "--profile waits for the port's utils/profiling.py (ROADMAP A, item 12)"
        )

    dtype = torch.complex64 if args.dtype == "complex64" else torch.float32
    src = example_graph(args.num_qubits, args.graph_type, args.dim)
    model = QCTN(src, seed=args.seed, dtype=dtype, device=args.device)
    if args.save:
        model.save_cores(args.save)  # raises: no checkpoint I/O yet
    print(f"graph ({args.graph_type}, {model.nqubits} qubits, "
          f"{model.ncores} cores)")

    cfg = TrainingConfig(
        method=args.method,
        learning_rate=args.lr,
        momentum=args.momentum,
        max_steps=args.steps,
        log_every=max(1, args.steps // 10),
        seed=args.seed,
    )
    trainer = Trainer(model.graph, config=cfg, K=args.K, dtype=dtype, device=model.device)

    rng = np.random.default_rng(args.seed)
    data_list = [
        torch.as_tensor(
            rng.normal(size=(args.batch_size, model.nqubits)).astype(np.float32),
            device=model.device,
        )
        for _ in range(args.num_batches)
    ]
    states = basis_states(model.graph, dtype=dtype, device=model.device)

    t0 = time.time()
    params, stats = trainer.fit(model.params, data_list, states=states)
    dt = time.time() - t0
    print(f"trained {stats.steps} steps in {dt:.1f}s "
          f"({stats.steps / max(dt, 1e-9):.1f} steps/s); "
          f"loss {stats.losses[0]:.4f} -> {stats.final_loss:.4f}")
    model.params = params
    return stats


if __name__ == "__main__":
    main()
