"""Candidate evaluator: trains a candidate circuit against a goal circuit.

Counterpart of ``tneq_tpu/genetic/evaluator.py`` (the ``MPI_Agent``
evaluation core of the reference, ``tneq_qc/distributed/mpi_agent.py:125-290``,
without the message passing): the candidate is fit to the goal by
``loss='overlap_mse'``, ``|⟨goal|cand⟩ − 1|²`` (the legacy contractor's MSE
loss, ``copteinsum.py:560-614``), or by ``loss='log_fidelity'``, −log F from
three rescaled log-overlaps.  The fit runs in chunks of ``n_iter`` steps
with one host sync per chunk, so the host can apply the reference's timeout
policy between chunks.

The ``repeats`` restarts of one candidate are lanes: one
``torch.func.vmap`` of an ``n_iter``-step chunk of
:func:`~tneq_tpu_torch.train.fit.functional_step`, as
``FitDrivers.batched`` runs the prune's lanes; JAX vmaps them into one
compiled program.  One chunk is cached per graph signature, as JAX caches
one jitted program, and clones share that cache: a chunk captures no
tensor (the goal cores and the goal's self-overlap are arguments).

Random streams.  JAX draws the restarts' cores with
``jax.vmap(init_params)(split(key, repeats))``; the port draws them with
:func:`~tneq_tpu_torch.model.qctn.init_params` from one host
``torch.Generator`` seeded with the evaluation's seed, restart by restart,
then moves them to the goal's device, so the card and the host start from
the same cores.  The streams differ between the packages: tests hand both
the same cores through :meth:`CandidateEvaluator._evaluate_from`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from ..graph.dsl import CircuitGraph, parse_graph
from ..model.qctn import init_params
from ..ops.contract import make_two_network_fn
from ..ops.pairwise import make_log_abs_two_network_fn
from ..optim.factory import make_optimizer
from ..train.fit import functional_step
from ..utils.device import DeviceLike
from .codes import REASONS

__all__ = ["CandidateEvaluator"]


def _lanes(x, n: int):
    """``x`` broadcast to ``n`` lanes on a new leading axis (tensors only)."""
    if isinstance(x, torch.Tensor):
        return x.expand((n,) + tuple(x.shape)).contiguous()
    return x


class CandidateEvaluator:
    def __init__(
        self,
        goal_graph: CircuitGraph,
        goal_params: Mapping[str, torch.Tensor],
        n_iter: int = 10,
        max_iterations: int = 200,
        tol: float = 1e-6,
        timeout: float = 1800.0,
        method: str = "adam",
        learning_rate: float = 1e-2,
        dtype: torch.dtype = torch.float32,
        loss: str = "overlap_mse",
    ):
        """``n_iter``: steps per chunk (one host sync, timeout checked
        between chunks); ``max_iterations``: total optimization budget per
        evaluation; ``timeout``: wall-clock limit per evaluation, read after
        each chunk's sync.  The fits run on the device of ``goal_params``.

        ``loss``: ``'overlap_mse'`` is the reference agent objective — fine
        at 3–5 qubits, float32-degenerate beyond ~24 (the raw overlap
        under/overflows, so every candidate scores the same).
        ``'log_fidelity'`` is −log F from per-step rescaled log-overlaps
        (``ops/pairwise.make_log_abs_two_network_fn``), finite and
        discriminative at 30+ qubits.
        """
        if loss not in ("overlap_mse", "log_fidelity"):
            raise ValueError(f"unknown loss {loss!r}")
        self.goal_graph = goal_graph
        self.goal_params = dict(goal_params)
        self.device = next(iter(self.goal_params.values())).device
        self.n_iter = n_iter
        self.max_iterations = max_iterations
        self.tol = tol
        self.timeout = timeout
        self.method = method
        self.learning_rate = learning_rate
        self.dtype = dtype
        self.loss = loss
        self._cache: Dict[str, Tuple[Callable, object]] = {}
        self._log_gg: Optional[torch.Tensor] = None

    def clone(self, device: Optional[DeviceLike] = None) -> "CandidateEvaluator":
        """Evaluator with the same config and the same chunk cache; with
        ``device`` set, the goal cores are committed to that device.  Used by
        :class:`~tneq_tpu_torch.genetic.farm.DeviceFarm` to give each worker
        its own evaluator."""
        goal_params = self.goal_params
        if device is not None:
            goal_params = {k: v.to(device) for k, v in goal_params.items()}
        ev = CandidateEvaluator(
            self.goal_graph,
            goal_params,
            n_iter=self.n_iter,
            max_iterations=self.max_iterations,
            tol=self.tol,
            timeout=self.timeout,
            method=self.method,
            learning_rate=self.learning_rate,
            dtype=self.dtype,
            loss=self.loss,
        )
        ev._cache = self._cache
        return ev

    def _loss_fn(self, graph: CircuitGraph) -> Callable:
        """``loss_fn(params, goal) -> (loss, loss)`` of one restart, with
        ``goal = (goal_params, log⟨goal|goal⟩ or None)``."""
        if self.loss == "log_fidelity":
            log_cg = make_log_abs_two_network_fn(graph, self.goal_graph)
            log_cc = make_log_abs_two_network_fn(graph, graph)

            def loss_fn(params, goal):
                goal_params, log_gg = goal
                loss = -(2.0 * log_cg(params, goal_params)
                         - log_cc(params, params) - log_gg)
                return loss, loss

        else:
            overlap_fn = make_two_network_fn(graph, self.goal_graph)

            def loss_fn(params, goal):
                d = overlap_fn(params, goal[0]) - 1.0
                loss = d.real ** 2 + d.imag ** 2 if d.is_complex() else d * d
                return loss, loss

        return loss_fn

    def _goal(self) -> tuple:
        """The ``goal`` argument of the loss: the goal cores and, for −log F,
        log⟨goal|goal⟩, its loop-invariant term, computed once per evaluator
        (XLA hoists it out of JAX's scan)."""
        if self.loss == "log_fidelity" and self._log_gg is None:
            with torch.no_grad():
                self._log_gg = make_log_abs_two_network_fn(
                    self.goal_graph, self.goal_graph
                )(self.goal_params, self.goal_params)
        return self.goal_params, self._log_gg

    def _chunk_fn(self, graph: CircuitGraph) -> Tuple[Callable, object]:
        """``(chunk, optimizer)``: ``chunk(params_b, opt_state_b, goal)``
        runs ``n_iter`` steps of every restart (lanes on axis 0) and returns
        the updated lanes and each lane's loss before its last update."""
        hit = self._cache.get(graph.signature)
        if hit is not None:
            return hit

        optimizer = make_optimizer(self.method, lr=self.learning_rate)
        step = functional_step(self._loss_fn(graph), optimizer)
        n_iter = self.n_iter

        def chunk(params, opt_state, goal):
            for _ in range(n_iter):
                params, opt_state, loss = step(params, opt_state, goal)
            return params, opt_state, loss

        # the optimizer state's tensor leaves are lanes, its other leaves
        # (step count, generator) shared
        state = optimizer.init({c.name: torch.zeros(c.shape, dtype=self.dtype)
                                for c in graph.cores})
        dims = tree_map(lambda x: 0 if isinstance(x, torch.Tensor) else None, state)
        run = vmap(chunk, in_dims=(0, dims, None), out_dims=(0, dims, 0),
                   randomness="same")
        return self._cache.setdefault(graph.signature, (run, optimizer))

    def _candidate(self, graph_string: str) -> CircuitGraph:
        graph = parse_graph(graph_string)
        if (
            graph.input_ranks != self.goal_graph.input_ranks
            or graph.output_ranks != self.goal_graph.output_ranks
        ):
            raise ValueError("candidate boundary ranks do not match the goal circuit")
        return graph

    def evaluate(
        self, graph_string: str, seed: int, repeats: int = 1
    ) -> Tuple[np.ndarray, int, int]:
        """Fit ``repeats`` random restarts of the candidate to the goal,
        their cores drawn from a host generator seeded with ``seed``.

        Returns ``(losses [repeats], iterations, reason)``.
        """
        graph = self._candidate(graph_string)
        gen = torch.Generator().manual_seed(int(seed))
        starts = [init_params(graph, gen, self.dtype, device="cpu")
                  for _ in range(repeats)]
        params_b = {k: torch.stack([s[k] for s in starts]) for k in graph.core_names}
        return self._evaluate_from(graph_string, params_b)

    def _evaluate_from(
        self, graph_string: str, params_b: Mapping[str, object]
    ) -> Tuple[np.ndarray, int, int]:
        """:meth:`evaluate` from given starting cores ``{name: [repeats,
        *shape]}`` (tensors or numpy arrays)."""
        return self._fit(graph_string, params_b)[1:]

    def _fit(self, graph_string: str, params_b: Mapping[str, object]):
        """The fit of :meth:`_evaluate_from`; returns ``(params_b, losses,
        iterations, reason)`` with the lanes' cores after the last update."""
        graph = self._candidate(graph_string)
        run, optimizer = self._chunk_fn(graph)
        params_b = {k: torch.as_tensor(v).to(device=self.device, dtype=self.dtype)
                    for k, v in params_b.items()}
        repeats = int(next(iter(params_b.values())).shape[0])
        opt_state_b = tree_map(lambda x: _lanes(x, repeats),
                               optimizer.init({k: v[0] for k, v in params_b.items()}))
        goal = self._goal()

        t0 = time.time()
        it = 0
        reason = REASONS.REACH_MAX_ITER
        losses = np.full(repeats, np.inf)
        while it < self.max_iterations:
            params_b, opt_state_b, loss_b = run(params_b, opt_state_b, goal)
            it += self.n_iter
            losses = loss_b.detach().cpu().numpy()  # the chunk's one sync
            if np.min(losses) < self.tol:
                break
            if time.time() - t0 > self.timeout:
                reason = REASONS.HARD_TIMEOUT
                break
        return params_b, losses, it, reason
