"""EvolutionSearch: the structure-search loop.

Counterpart of ``tneq_tpu/genetic/search.py`` (the reference's
``MPI_Overlord``, ``tneq_qc/distributed/mpi_overlord.py``, as an in-process
work queue): spans generations up to ``max_generation``, feeds the
evaluator, collects results with per-individual ``evaluate_repeat``,
applies the abnormal-result accounting, and evolves finished generations.
The restarts of one candidate are lanes of one vmapped chunk (see
``CandidateEvaluator``).

With ``devices=`` set, candidates fan out across devices through a
:class:`~tneq_tpu_torch.genetic.farm.DeviceFarm`: submission order — and
therefore the seed each evaluation gets — stays deterministic, only
completion order varies, so farmed results equal serial results for the
same seed.

Random streams.  JAX's ``jax.random.PRNGKey(seed)``, split once per
evaluation, becomes a host ``torch.Generator`` seeded with ``seed``, from
which one evaluation seed is drawn per submission.  The structure draws
(the numpy generator, Python's ``random`` for society names) are the same
as in JAX.  The checkpoint stores the generator's state where JAX stores
its key, so the checkpoints of the two packages cannot be read by each
other.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops import contract, einsum_spec, pairwise

from .codes import REASONS, AgentStatus
from .evaluator import CandidateEvaluator
from .generation import Generation
from .individual import Individual

__all__ = ["EvolutionSearch"]


def _clear_caches(evaluator: CandidateEvaluator) -> None:
    """Drop the evaluator's chunk cache (shared with its farm clones) and
    the port's contraction-plan caches, and on the card the allocator's
    cached blocks: the counterpart of ``jax.clear_caches()``."""
    evaluator._cache.clear()
    for fn in (contract._schedule, pairwise.choose_path, pairwise._lettered,
               einsum_spec.core_only_spec, einsum_spec.with_inputs_spec,
               einsum_spec._siamese_build, einsum_spec.siamese_env_spec,
               einsum_spec._two_network_build):
        fn.cache_clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class EvolutionSearch:
    def __init__(
        self,
        evaluator: CandidateEvaluator,
        generation_property: Optional[Dict[str, Any]] = None,
        evolution_property: Optional[Dict[str, Any]] = None,
        max_generation: int = 5,
        max_abnormal: int = 10,
        seed: int = 0,
        verbose: bool = True,
        devices: Optional[list] = None,
        checkpoint_path: Optional[str] = None,
        clear_caches_every: int = 8,
        **individual_kwds,
    ):
        self.evaluator = evaluator
        self.farm = None
        if devices is not None:
            from .farm import DeviceFarm

            self.farm = DeviceFarm(evaluator, devices)
        self.generation_property = generation_property or {}
        self.evolution_property = evolution_property or {}
        self.max_generation = max_generation
        self.max_abnormal = max_abnormal
        self.verbose = verbose
        self.individual_kwds = individual_kwds
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.status = AgentStatus()
        self.history: List[dict] = []
        self.checkpoint_path = checkpoint_path
        # Every novel candidate topology adds a chunk and contraction plans
        # to caches that live as long as the process.  Dropping them every
        # few generations only re-pays planning for repeated topologies
        # (elites carry their results and are not re-fit).  0 = never.
        self.clear_caches_every = clear_caches_every
        self._resume_state: Optional[dict] = None

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    # -- checkpoint / resume ----------------------------------------------

    def _save_checkpoint(
        self,
        generation: Generation,
        generation_index: int,
        best: Optional[Individual],
    ) -> None:
        """Atomic JSON snapshot: population + RNG streams + history.

        Saved at the start of every generation (and after the final one),
        so a killed search resumes at the last generation boundary.  The
        reference's overlord keeps no state — any crash loses the whole
        search.
        """
        import json
        import os
        import tempfile

        state = {
            "generation_index": generation_index,
            "generation": generation.state_dict(),
            "history": self.history,
            "abnormal": self.status.abnormal_counter,
            "rng_state": self.rng.bit_generator.state,
            "generator": self.generator.get_state().tolist(),
            "best": None
            if best is None
            else {
                "scope": best.scope,
                "graph": best.graph.to_dsl(),
                "parents": list(best.parents),
                "losses": best.report_loss,
                "iters": best.report_loss_iter,
                "reasons": best.report_loss_reason,
            },
        }
        d = os.path.dirname(os.path.abspath(self.checkpoint_path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, self.checkpoint_path)

    @classmethod
    def resume(
        cls, checkpoint_path: str, evaluator: CandidateEvaluator, **kwargs
    ) -> "EvolutionSearch":
        """Rebuild a search from a checkpoint written by a previous run.

        ``kwargs`` must carry the same ``generation_property`` /
        ``evolution_property`` / ``max_generation`` / individual kwargs as
        the original run (fitness functions are not serializable).
        """
        import json

        with open(checkpoint_path) as f:
            state = json.load(f)
        search = cls(evaluator, checkpoint_path=checkpoint_path, **kwargs)
        search.rng.bit_generator.state = state["rng_state"]
        search.generator.set_state(torch.tensor(state["generator"], dtype=torch.uint8))
        search.history = state["history"]
        search.status.abnormal_counter = state["abnormal"]
        search._resume_state = state
        return search

    def _restore_individual(self, info: dict) -> Individual:
        indv = Individual(
            info["scope"],
            info["graph"],
            tuple(info["parents"]),
            rng=self.rng,
            **self.individual_kwds,
        )
        indv.report_loss = [float(x) for x in info["losses"]]
        indv.report_loss_iter = [int(x) for x in info["iters"]]
        indv.report_loss_reason = [int(x) for x in info["reasons"]]
        if indv.report_loss:
            indv.calculate_fitness()
        return indv

    def _abnormal(self, generation: Generation, indv: Individual, e: Exception):
        """Reference INFO_ABNORMAL accounting (``mpi_overlord.py``)."""
        self.status.abnormal_counter += 1
        self._log(f"abnormal evaluation for {indv.scope}: {e}")
        generation.collect_result(indv, 1e9, -1, REASONS.FAKE_RESULT)
        if self.status.abnormal_counter > self.max_abnormal:
            raise RuntimeError(
                "too many abnormal evaluations; aborting search"
            ) from e

    def _next_seed(self) -> int:
        """The next evaluation's seed (submission order)."""
        return int(torch.randint(2 ** 62, (), generator=self.generator))

    def _drain_serial(self, generation: Generation) -> int:
        n_evals = 0
        while not generation.is_finished():
            indv = generation.next_to_evaluate()
            if indv is None:
                break
            sub = self._next_seed()
            # the remaining repeats of this candidate run as lanes of one
            # vmapped chunk (the reference farms each repeat out to a
            # separate MPI worker)
            remaining = max(1, generation.evaluate_repeat - indv.status.repeated)
            try:
                losses, iters, reason = self.evaluator.evaluate(
                    indv.graph.to_dsl(), sub, repeats=remaining
                )
                for loss in np.asarray(losses):
                    generation.collect_result(indv, float(loss), iters, reason)
                n_evals += remaining
            except Exception as e:  # abnormal job (reference INFO_ABNORMAL)
                self._abnormal(generation, indv, e)
        return n_evals

    def _drain_farmed(self, generation: Generation) -> int:
        """Submit every pending candidate to the device farm, collect as
        futures resolve.  Seeds are drawn in (deterministic) submission
        order, so farmed and serial runs see identical randomness."""
        from concurrent.futures import FIRST_COMPLETED, wait

        n_evals = 0
        pending = {}
        while True:
            while True:
                indv = generation.next_to_evaluate()
                if indv is None:
                    break
                sub = self._next_seed()
                remaining = max(
                    1, generation.evaluate_repeat - indv.status.repeated
                )
                fut = self.farm.submit(indv.graph.to_dsl(), sub, remaining)
                pending[fut] = (indv, remaining)
            if not pending:
                break
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                indv, remaining = pending.pop(fut)
                try:
                    losses, iters, reason = fut.result()
                    for loss in np.asarray(losses):
                        generation.collect_result(
                            indv, float(loss), iters, reason
                        )
                    n_evals += remaining
                except Exception as e:
                    self._abnormal(generation, indv, e)
        return n_evals

    def run(self) -> Individual:
        """Run the full search; returns the best individual found."""
        best_overall: Optional[Individual] = None
        g0 = 0
        if self._resume_state is not None:
            state = self._resume_state
            g0 = int(state["generation_index"])
            generation = Generation.restore(
                state["generation"],
                generation_property=self.generation_property,
                evolution_property=self.evolution_property,
                rng=self.rng,
                **self.individual_kwds,
            )
            if state.get("best"):
                best_overall = self._restore_individual(state["best"])
            self._resume_state = None
            self._log(f"resumed at generation {g0} ({generation.name})")
        else:
            generation = Generation(
                name="G000",
                generation_property=self.generation_property,
                evolution_property=self.evolution_property,
                rng=self.rng,
                **self.individual_kwds,
            )

        for g in range(g0, self.max_generation):
            t0 = time.time()
            if self.checkpoint_path:
                self._save_checkpoint(generation, g, best_overall)
            if self.farm is not None:
                n_evals = self._drain_farmed(generation)
            else:
                n_evals = self._drain_serial(generation)

            generation.evaluate()
            best = generation.best()
            if best is not None and (
                best_overall is None
                or best.fitness_score < best_overall.fitness_score
            ):
                best_overall = best
            self.history.append(
                {
                    "generation": generation.name,
                    "evaluations": n_evals,
                    "best_fitness": best.fitness_score if best else None,
                    "best_scope": best.scope if best else None,
                    "wall_time": time.time() - t0,
                }
            )
            self._log(
                f"[{generation.name}] {n_evals} evals in "
                f"{time.time() - t0:.1f}s; best fitness "
                f"{best.fitness_score if best else float('nan'):.5f}"
            )

            if self.clear_caches_every and (
                (g + 1) % self.clear_caches_every == 0
            ):
                _clear_caches(self.evaluator)
                self._log(f"[{generation.name}] cleared the chunk and "
                          f"contraction-plan caches")

            if g + 1 < self.max_generation:
                generation.evolve()
                next_gen = Generation(
                    parent=generation,
                    name=f"G{g + 1:03d}",
                    generation_property=self.generation_property,
                    evolution_property=self.evolution_property,
                    rng=self.rng,
                    **self.individual_kwds,
                )
                generation = next_gen

        if best_overall is None:
            raise RuntimeError("search produced no evaluated individuals")
        if self.checkpoint_path:
            self._save_checkpoint(generation, self.max_generation, best_overall)
        return best_overall
