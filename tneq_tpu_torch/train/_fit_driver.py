"""Fit-loop drivers for the masked fidelity fits.

Counterpart of ``tneq_tpu/train/_fit_driver.py`` (``fit_while``,
``fit_chunked``, ``fit_host``, ``batched``).  PyTorch runs eagerly, so every
scope is a host loop over one functional ``step(params, opt_state, mask,
*shared) -> (params, opt_state, metric)``; the scopes differ only in how
often the exit test reads the metric, and keep the JAX conventions:

- ``fit_while`` (JAX: one ``lax.while_loop``): the exit is tested before
  every step;
- ``fit_host`` (scope 'step'): ``sync_every`` steps between tests, never
  past ``max_steps``;
- ``fit_chunked`` (scope 'chunk'): whole chunks of ``sync_every`` steps,
  so ``max_steps`` rounds UP to a whole chunk;
- ``batched`` (``fit.batched`` of every scope): lockstep lanes over mask
  rows from one start, ``torch.func.vmap`` of a ``k``-step chunk per exit
  test, run while ANY lane is still running (``max_steps`` rounds up to a
  whole chunk).

The reported metric is the one that triggered the exit, measured before the
final update, and ``steps`` counts the updates applied.  ``running(metric)``
is True while not converged; it is given the metric as float32 numpy, so
the test is taken in float32 as on the device in JAX.  JAX's ``coop.poll``
yield hook has no GPU role and is dropped.

The step must be vmap-safe: no host read of a lane-batched tensor inside
it.  The optimizer state's ``torch.Generator`` is shared by the lanes, not
broadcast, and the chunk runs under ``randomness="same"``: one retraction
draw per shape group per step for all lanes, as JAX gives by broadcasting
one key, so a lane whose mask equals a sequential fit's repeats that fit
draw for draw.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from ..utils.device import matmul_precision

__all__ = ["FitDrivers"]


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


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

    def batched_chunk(self, k: int, opt_state, n_shared: int) -> Callable:
        """The k-step chunk vmapped over lanes: params, the tensor leaves of
        the optimizer state and the mask batched on axis 0, its other
        leaves (step count, generator) and the ``n_shared`` trailing
        arguments shared."""
        step = self.step

        def chunk(params, opt_state, mask, *shared):
            for _ in range(k):
                params, opt_state, metric = step(params, opt_state, mask, *shared)
            return params, opt_state, metric

        state_dims = tree_map(lambda x: 0 if _is_tensor(x) else None, opt_state)
        return vmap(chunk, in_dims=(0, state_dims, 0) + (None,) * n_shared,
                    out_dims=(0, state_dims, 0), randomness="same")

    def batched(self, params, masks, *shared, chunk_steps: int = 0):
        """Lockstep lanes over the rows of ``masks``, all from ``params``:
        one vmapped chunk of ``chunk_steps`` (default ``sync_every``) steps
        per exit test, while any lane is running.  Returns lane-batched
        params, optimizer state and metrics (the metric of each lane is the
        one its last chunk took before its final update)."""
        b = int(masks.shape[0])
        k = int(chunk_steps) if chunk_steps else self.sync_every

        def lanes(x):
            return x.expand((b,) + tuple(x.shape)).contiguous() if _is_tensor(x) else x

        with matmul_precision(self.matmul_precision):
            opt_state = self.optimizer.init(params)
            run = self.batched_chunk(k, opt_state, len(shared))
            params_b = {n: lanes(v) for n, v in params.items()}
            opt_state_b = tree_map(lanes, opt_state)
            metric_b = torch.full((b,), self.init_metric, dtype=torch.float32)
            steps = 0
            while steps < self.max_steps and bool(np.asarray(
                self.running(metric_b.detach().cpu().numpy().astype(np.float32))
            ).any()):
                params_b, opt_state_b, metric_b = run(params_b, opt_state_b, masks, *shared)
                steps += k
        return params_b, opt_state_b, steps, metric_b
