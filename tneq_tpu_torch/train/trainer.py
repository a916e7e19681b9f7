"""Likelihood training: the NLL train step and the host-side training loop.

Counterpart of ``tneq_tpu/train/trainer.py``.  A step runs the Hermite
feature map, the siamese Born-rule contraction, the NLL loss, its gradient
(``torch.autograd.grad``) and the optimizer update; the Python loop feeds
batches and handles the tol exit and the eval/checkpoint hooks.  JAX's
``jax.jit`` has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..graph.dsl import CircuitGraph
from ..ops.compiler import compile_siamese
from ..ops.contract import abs_square
from ..ops.features import measurement_matrices
from ..optim.factory import make_optimizer
from ..optim.stiefel import GradientTransformation
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import annotate
from .losses import nll_loss

__all__ = ["TrainingConfig", "TrainingStats", "Trainer", "basis_states"]


@dataclass
class TrainingConfig:
    """Knobs of the training loop (the JAX ``TrainingConfig``)."""

    method: str = "sgdg"
    learning_rate: float = 1e-2
    momentum: float = 0.9
    stiefel: bool = True
    max_steps: int = 1000
    tol: float = 0.0  # stop when |loss - prev| < tol (0 disables)
    log_every: int = 50
    eval_every: int = 0
    save_every: int = 0
    lr_schedule: Optional[Sequence[Tuple[int, float]]] = None
    seed: int = 0


@dataclass
class TrainingStats:
    losses: List[float] = field(default_factory=list)
    steps: int = 0
    wall_time: float = 0.0
    converged: bool = False

    @property
    def final_loss(self) -> Optional[float]:
        return self.losses[-1] if self.losses else None


def basis_states(
    graph: CircuitGraph,
    index: int = -1,
    dtype: torch.dtype = torch.complex64,
    device: DeviceLike = "cuda",
) -> List[torch.Tensor]:
    """Per-qubit computational-basis state vectors; ``index=-1`` puts the 1
    in the last slot."""
    dev = resolve_device(device)
    states = []
    for rank in graph.input_ranks:
        v = torch.zeros(rank, dtype=dtype, device=dev)
        v[index] = 1.0
        states.append(v)
    return states


class Trainer:
    """The NLL train step for a circuit and an optimizer, on ``device``."""

    def __init__(
        self,
        graph: CircuitGraph,
        optimizer: Optional[GradientTransformation] = None,
        config: Optional[TrainingConfig] = None,
        K: Optional[int] = None,
        dtype: torch.dtype = torch.complex64,
        device: DeviceLike = "cuda",
        mesh=None,
    ):
        self.graph = graph
        self.config = config or TrainingConfig()
        self.dtype = dtype
        self.device = resolve_device(device)
        # K (Hermite order) must equal the per-qubit output rank
        ranks = set(graph.output_ranks)
        if K is None:
            if len(ranks) != 1:
                raise ValueError("circuit has mixed output ranks; pass K explicitly")
            K = next(iter(ranks))
        self.K = K
        if optimizer is None:
            cfg = self.config
            lr: Any = cfg.learning_rate
            if cfg.lr_schedule:
                from ..optim.schedules import step_table_schedule

                lr = step_table_schedule(cfg.lr_schedule, cfg.learning_rate)
            kwargs: Dict[str, Any] = {"lr": lr}
            if cfg.method in ("sgdg", "adamg"):
                kwargs.update(momentum=cfg.momentum, stiefel=cfg.stiefel, seed=cfg.seed)
            elif cfg.method in ("momentum", "nesterov"):
                kwargs.update(momentum=cfg.momentum)
            optimizer = make_optimizer(cfg.method, **kwargs)
        self.optimizer = optimizer
        # The JAX Trainer contracts with make_siamese_fn
        # (tneq_tpu/train/trainer.py:113), which never reaches the Pallas
        # transfer step.  Here the contraction comes from compile_siamese, so
        # chains take the sweep: through kernels B3/B4 ("mps_sweep_cuda")
        # where the gate ops/mps_sweep.chain_takes_kernel takes the chain in
        # this dtype (float32 or complex64, bonds up to 256, physical ranks
        # up to 64), else one torch.einsum per step ("mps_sweep"); both are
        # the same function on chains, and the parity tests hold the two
        # Trainers against each other (ROADMAP C).  Other graphs (tree, wall, wall_col) take
        # make_siamese_fn, as in JAX.  A ``mesh`` (``parallel.make_mesh``)
        # whose ``model`` axis is > 1 bond-slices the contraction over it
        # (``parallel/mp.py``; its batch rows over ``data`` in the rank
        # form), and the step sums the gradients over the ranks.
        self._siamese, self.strategy = compile_siamese(graph, mesh=mesh, dtype=dtype)
        self._reduce_gradients = getattr(self._siamese, "reduce_gradients", None)

    # -- forward ----------------------------------------------------------

    def probability(self, params, states, x) -> torch.Tensor:
        """Born-rule probability of the data batch ``x [B, nqubits]``."""
        mx = measurement_matrices(torch.as_tensor(x, device=self.device), self.K).to(self.dtype)
        measures = [mx[:, q] for q in range(self.graph.nqubits)]
        raw = self._siamese(params, states, measures)
        return abs_square(raw) if raw.is_complex() else raw

    def loss(self, params, states, x) -> torch.Tensor:
        return nll_loss(self.probability(params, states, x))

    def _step(self, params, opt_state, states, x, reduce: Optional[Callable] = None):
        """One update; ``reduce(loss, grads) -> (loss, grads)`` maps the
        loss and gradients before it (the data-parallel mean,
        ``parallel/dp.py``)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = self.loss(leaves, states, x)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        if self._reduce_gradients is not None:
            grads = self._reduce_gradients(grads)
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        with torch.no_grad():
            params = {k: v.detach() for k, v in leaves.items()}
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = {k: p + updates[k] for k, p in params.items()}
        return params, opt_state, loss

    @property
    def train_step(self) -> Callable:
        """``(params, opt_state, states, x) -> (params, opt_state, loss)``."""
        return self._step

    def make_chunked_step(self, n_steps: int) -> Callable:
        """``(params, opt_state, states, xs[n_steps, B, nq]) -> (params,
        opt_state, losses[n_steps])``: ``n_steps`` updates with no host sync
        between them (the losses stay on the device)."""

        def chunk(params, opt_state, states, xs):
            losses = []
            for i in range(n_steps):
                params, opt_state, loss = self._step(params, opt_state, states, xs[i])
                losses.append(loss)
            return params, opt_state, torch.stack(losses)

        return chunk

    # -- loop -------------------------------------------------------------

    def fit(
        self,
        params,
        data_list: Sequence,
        states: Optional[Sequence[torch.Tensor]] = None,
        eval_fn: Optional[Callable] = None,
        checkpoint_fn: Optional[Callable] = None,
        verbose: bool = True,
    ) -> Tuple[dict, TrainingStats]:
        """Cycle the batches: one update per step, optional eval/checkpoint
        hooks, tol-based convergence (the JAX ``fit`` loop)."""
        cfg = self.config
        if states is None:
            states = basis_states(self.graph, dtype=self.dtype, device=self.device)
        opt_state = self.optimizer.init(params)
        stats = TrainingStats()
        prev_loss = None
        t0 = time.time()
        for step_idx in range(cfg.max_steps):
            x = data_list[step_idx % len(data_list)]
            # the step's span in a profiler trace (JAX's trace names the
            # jitted step by its program)
            with annotate("train_step"):
                params, opt_state, loss_val = self._step(params, opt_state, states, x)
            loss_f = float(loss_val)
            stats.losses.append(loss_f)
            stats.steps = step_idx + 1
            if verbose and cfg.log_every and step_idx % cfg.log_every == 0:
                print(f"step {step_idx}: loss={loss_f:.6f}")
            if eval_fn and cfg.eval_every and step_idx % cfg.eval_every == 0:
                eval_fn(params, step_idx)
            if checkpoint_fn and cfg.save_every and step_idx and step_idx % cfg.save_every == 0:
                checkpoint_fn(params, step_idx)
            if cfg.tol and prev_loss is not None and abs(loss_f - prev_loss) < cfg.tol:
                stats.converged = True
                break
            prev_loss = loss_f
        stats.wall_time = time.time() - t0
        return params, stats
