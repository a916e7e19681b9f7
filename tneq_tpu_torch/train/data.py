"""Data utilities for likelihood training.  Counterpart of
``tneq_tpu/train/data.py``: seeded Gaussian batches (numpy draws, as JAX
makes them, then moved to ``device``), an epoch shuffler, and a cycling
batch iterator."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["gaussian_batches", "shuffled_epochs", "cycle_batches"]


def gaussian_batches(
    n_batches: int,
    batch_size: int,
    n_qubits: int,
    seed: int = 0,
    scale: float = 1.0,
    device: DeviceLike = "cuda",
) -> List[torch.Tensor]:
    """Deterministic float32 Gaussian batches ``[B, nqubits]`` (the same
    numbers as JAX's for the same seed)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [
        torch.as_tensor(
            rng.normal(scale=scale, size=(batch_size, n_qubits)).astype(np.float32),
            device=dev,
        )
        for _ in range(n_batches)
    ]


def shuffled_epochs(data_list: Sequence, seed: int = 0) -> Iterator:
    """Yield batches forever, reshuffling the batch order each epoch with a
    deterministic seed."""
    rng = np.random.default_rng(seed)
    n = len(data_list)
    while True:
        order = rng.permutation(n)
        for i in order:
            yield data_list[int(i)]


def cycle_batches(data_list: Sequence) -> Iterator:
    """Plain cycling without shuffling."""
    i = 0
    n = len(data_list)
    while True:
        yield data_list[i % n]
        i += 1
