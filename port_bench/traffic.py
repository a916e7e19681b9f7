"""The one generator of inputs: reads a traffic file's parameters and makes
the inputs of a run from its seed, on the device.  The same seed gives the
same inputs; every seed gives the same sizes.

Kinds (the ``kind`` key of a traffic file):

- ``batches``: ``n_batches`` data batches ``[batch_size, n_qubits]`` drawn
  from ``distribution`` (``normal``: mean 0, standard deviation ``scale``),
  cycled in order by a closed-loop trainer.
- ``prune_round``: one accept round of the batched prune.  The target is a
  network of the configuration's graph with ``planted`` cores, drawn from
  the seed, replaced by identities; its other cores are Haar-random.  Every
  core not structurally barred is a candidate; the candidates run in pieces
  of the configuration's ``lane_chunk`` lanes, each piece ``chunk_steps``
  fit steps from the warm start ``warm_start`` (``planted``: the target's
  own network).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .weights import haar_cores

__all__ = ["batches", "prune_round"]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def batches(traffic: dict, seed: int, n_qubits: int, device: torch.device):
    """The ``batches`` kind: a list of float32 tensors on ``device``."""
    if traffic["kind"] != "batches" or traffic["distribution"] != "normal":
        raise ValueError(f"not a normal-batches traffic file: {traffic}")
    gen = _generator(seed, device)
    size = (int(traffic["n_batches"]), int(traffic["batch_size"]), int(n_qubits))
    x = torch.randn(size, generator=gen, dtype=torch.float32, device=device)
    x = x * float(traffic["scale"])
    return [x[i].contiguous() for i in range(size[0])]


def prune_round(traffic: dict, seed: int, shapes: Dict[str, Tuple[int, ...]],
                dtype: torch.dtype, device: torch.device):
    """The ``prune_round`` kind: ``(planted, target_cores)``: the sorted
    indices (in ``shapes``' order) of the planted cores and the target's
    cores before they are masked."""
    if traffic["kind"] != "prune_round" or traffic["round"] != 1:
        raise ValueError(f"not a first-round prune traffic file: {traffic}")
    gen = _generator(seed, device)
    n = len(shapes)
    order = torch.randperm(n, generator=gen, device=device).cpu().tolist()
    planted = sorted(order[: int(traffic["planted"])])
    return planted, haar_cores(shapes, dtype, gen, device)
