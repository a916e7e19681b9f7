"""Fit-loop drivers for the masked fidelity fits.

Counterpart of ``tneq_tpu/train/_fit_driver.py`` (``fit_while``,
``fit_chunked``, ``fit_host``).  PyTorch runs eagerly, so every scope is a
host loop over one ``step(params, opt_state, mask, *shared) -> (params,
opt_state, metric)``; the scopes differ only in how often the exit test
reads the metric, and keep the JAX conventions:

- ``fit_while`` (JAX: one ``lax.while_loop``): the exit is tested before
  every step;
- ``fit_host`` (scope 'step'): ``sync_every`` steps between tests, never
  past ``max_steps``;
- ``fit_chunked`` (scope 'chunk'): whole chunks of ``sync_every`` steps,
  so ``max_steps`` rounds UP to a whole chunk.

The reported metric is the one that triggered the exit, measured before the
final update, and ``steps`` counts the updates applied.  ``running(metric)``
is True while not converged; it is given the metric as a float32 numpy
scalar, so the test is taken in float32 as on the device in JAX.  The
vmapped ``batched`` lanes wait for a later slice; JAX's ``coop.poll`` yield
hook has no GPU role and is dropped.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.device import matmul_precision

__all__ = ["FitDrivers"]


class FitDrivers:
    """All drivers return ``(params, opt_state, steps, metric)``."""

    def __init__(
        self,
        step: Callable,
        optimizer,
        max_steps: int,
        sync_every: int,
        running: Callable,
        init_metric: float,
        matmul_precision: str = "highest",
    ):
        self.step = step
        self.optimizer = optimizer
        self.max_steps = int(max_steps)
        self.sync_every = max(1, int(sync_every))
        self.running = running
        self.init_metric = float(init_metric)
        self.matmul_precision = matmul_precision

    def _loop(self, params, mask, shared, steps_per_test: Callable[[int], int]):
        with matmul_precision(self.matmul_precision):
            opt_state = self.optimizer.init(params)
            metric = torch.tensor(self.init_metric, dtype=torch.float32)
            steps = 0
            while steps < self.max_steps and bool(
                self.running(np.float32(metric.item()))
            ):
                for _ in range(steps_per_test(steps)):
                    params, opt_state, metric = self.step(
                        params, opt_state, mask, *shared
                    )
                    steps += 1
        return params, opt_state, steps, metric

    def fit_while(self, params, mask, *shared):
        """Exit tested before every step."""
        return self._loop(params, mask, shared, lambda steps: 1)

    def fit_chunked(self, params, mask, *shared):
        """Whole chunks of ``sync_every`` steps (``max_steps`` rounds up)."""
        return self._loop(params, mask, shared, lambda steps: self.sync_every)

    def fit_host(self, params, mask, *shared):
        """``sync_every`` steps per exit test, clipped at ``max_steps``."""
        return self._loop(
            params, mask, shared,
            lambda steps: min(self.sync_every, self.max_steps - steps),
        )
