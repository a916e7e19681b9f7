"""Learning-rate schedules.  Counterpart of ``tneq_tpu/optim/schedules.py``:
a piecewise-constant ``[(step, lr), ...]`` table as a host function of the
optimizer's step count."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["step_table_schedule"]


def step_table_schedule(table: Sequence[Tuple[int, float]], init_lr: float = None):
    """lr(count): the lr of the largest table step <= count; before the first
    table entry, ``init_lr`` (default: the first table lr).  Values are
    float32, as in the JAX schedule."""
    if not table:
        raise ValueError("schedule table must be non-empty")
    table = sorted(table)
    steps = np.asarray([s for s, _ in table], np.int32)
    lrs = np.asarray([l for _, l in table], np.float32)
    first = np.float32(init_lr if init_lr is not None else table[0][1])

    def schedule(count) -> np.float32:
        idx = int(np.sum(steps <= int(count))) - 1
        return first if idx < 0 else lrs[min(idx, len(table) - 1)]

    return schedule
