"""Scalar metrics logging (the reference's optional TensorBoard hook).

Counterpart of ``tneq_tpu/utils/metrics.py`` (pure Python, copied).
The reference writes scalars through an optional ``summary_writer`` on the
Optimizer (``optim/optimizer.py:92-98``).  Here: a JSONL scalar writer (one
record per step, trivially plottable) with an optional TensorBoard backend
when ``tensorboardX``/``torch.utils.tensorboard`` is importable.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["MetricsWriter"]


class MetricsWriter:
    def __init__(self, directory, use_tensorboard: bool = False):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.directory / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.directory / "tb"))
            except ImportError:
                pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
