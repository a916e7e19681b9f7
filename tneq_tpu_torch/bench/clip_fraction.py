"""How much of a Born-rule batch sits below the NLL clip at step 0.

``nll_loss`` clamps probabilities at 1e-10; a clamped sample adds
-log(1e-10) to the loss and nothing to the gradient.  This prints, for the
Born-rule trainer's chains at initialisation, the share of the batch below
the clamp and the median probability::

    python -m tneq_tpu_torch.bench.clip_fraction --device cpu

Rows: ``mps_graph(n, 8, phys=4)`` in float32 with N(0, 1) data, batch 512
(the ``born_rule`` configuration of ``chip_smoke.py`` at n = 8), and the
single-node CLI's default (8 qubits, dim 3, complex64, batch 32).  Cores
come from ``init_params`` with seed 0, data from numpy with seed 0.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph.dsl import parse_graph
from ..graph.generators import mps_graph
from ..model.qctn import init_params
from ..train.losses import PROB_CLIP
from ..train.trainer import Trainer, basis_states

__all__ = ["clip_fraction", "main"]


def clip_fraction(n: int, dim: int, phys: int, batch: int, dtype: torch.dtype,
                  device: str = "cuda") -> dict:
    """Step-0 share of probabilities below the clip, and their median."""
    graph = parse_graph(mps_graph(n, dim, phys=phys))
    trainer = Trainer(graph, dtype=dtype, device=device)
    params = init_params(graph, 0, dtype, device=device)
    x = np.random.default_rng(0).normal(size=(batch, n)).astype(np.float32)
    with torch.no_grad():
        p = trainer.probability(params, basis_states(graph, dtype=dtype, device=device),
                                torch.as_tensor(x, device=device)).cpu().numpy()
    return {"qubits": n, "bond": dim, "K": phys, "batch": batch,
            "dtype": str(dtype).split(".")[-1],
            "below_clip": float((p < PROB_CLIP).mean()),
            "median_probability": float(np.median(p))}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for n in (8, 12, 16, 32):
        print(json.dumps(clip_fraction(n, 8, 4, 512, torch.float32, args.device)))
    print(json.dumps(clip_fraction(8, 3, 3, 32, torch.complex64, args.device)))


if __name__ == "__main__":
    main()
