"""Generation / Society: population bookkeeping and evolution.

The port's own copy of ``tneq_tpu/genetic/generation.py`` (pure Python
and numpy, same semantics).  Society names are drawn from Python's global
``random``, not the seeded numpy generator, as in JAX: seed ``random`` to
reproduce them (ROADMAP C, parity quirks).

Rebuild of the reference ``Generation`` (``tneq_qc/genetic/mpi_generation.py:417-1003``):
societies of individuals, distribute/collect queues with per-individual
``evaluate_repeat``, ranking, and top-k × n_copy + mutate evolution.
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .codes import REASONS, default_fitness
from .individual import Individual

__all__ = ["Society", "Generation"]


@dataclass
class Society:
    name: str
    individuals: List[Individual] = field(default_factory=list)
    indv_ranking: List[int] = field(default_factory=list)
    score_total: List[float] = field(default_factory=list)
    finished: bool = False
    fitness_func: Callable = default_fitness

    def __iter__(self):
        for i in self.individuals:
            yield i.scope, i

    def __len__(self):
        return len(self.individuals)

    @property
    def best(self) -> Optional[Individual]:
        if not self.indv_ranking:
            return None
        return self.individuals[self.indv_ranking[0]]


def _society_params(gp: Dict[str, Any]) -> List[Dict[str, Any]]:
    society_property = gp.get("society_property", {})
    n_societies = gp.get("n_societies", 1)
    params_list = society_property.get(
        "society",
        [dict(n_individuals_span=20, fitness_func=default_fitness)],
    )
    if len(params_list) == 1 and n_societies > 1:
        params_list = params_list * n_societies
    elif len(params_list) != n_societies:
        raise ValueError("society params count does not match n_societies")
    return params_list


class Generation:
    """One generation of the search.

    ``generation_property`` keys (reference defaults,
    ``mpi_generation.py:547-575``): ``n_societies`` (1), ``evaluate_repeat``
    (2), ``sparsity_threshold`` (10.0), ``society_property.society`` — a list
    of per-society dicts with ``n_individuals_span`` (20),
    ``graph_string_template``, ``fitness_func``.
    ``evolution_property``: ``top_k`` (5), ``n_copy`` (4), ``mutation_prob``,
    ``elitism`` (0) — number of top parents carried over UNMUTATED each
    generation, with their evaluation results intact (no retraining: fit
    results are seed-sensitive, so re-evaluating the same graph could score
    it worse).  The reference mutates every offspring
    (``mpi_generation.py:613-639``), so its best fitness can regress between
    generations; ``elitism`` defaults to 0 for behavioral parity and >0
    makes per-generation best fitness non-increasing.
    """

    def __init__(
        self,
        parent: Optional["Generation"] = None,
        name: Optional[str] = None,
        generation_property: Optional[Dict[str, Any]] = None,
        evolution_property: Optional[Dict[str, Any]] = None,
        rng: Optional[np.random.Generator] = None,
        **kwds,
    ):
        self.name = name or "G000"
        self.kwds = kwds
        self.rng = rng or np.random.default_rng()
        gp = dict(generation_property or {})
        self.generation_property = gp
        self.evaluate_repeat = gp.get("evaluate_repeat", 2)
        self.evolution_property = dict(evolution_property or {})

        self.indv_to_distribute: List[Individual] = []
        self.indv_to_collect: List[Individual] = []
        self.societies: Dict[str, Society] = {}

        self.society_params_list = _society_params(gp)

        self._init_societies(parent)

    # -- construction -----------------------------------------------------

    def _new_individual(self, scope, graph_string, parents, fitness_func):
        return Individual(
            scope=scope,
            graph_string=graph_string,
            parents=parents,
            fitness_func=fitness_func,
            rng=self.rng,
            **self.kwds,
        )

    def _init_societies(self, parent: Optional["Generation"]) -> None:
        if parent is not None:
            for name, soc in parent.societies.items():
                new = Society(name=name, fitness_func=soc.fitness_func)
                for idx, indv in enumerate(soc.individuals):
                    scope = f"{self.name}/{name}/{idx:03d}"
                    parents = (
                        (indv.scope,)
                        if not indv.parents
                        else indv.parents + (indv.scope,)
                    )
                    ni = self._new_individual(
                        scope, indv.graph.to_dsl(), parents, soc.fitness_func
                    )
                    if indv.status.finished and indv.report_loss:
                        # elite carried over with its evaluation intact
                        # (next_to_evaluate skips finished individuals)
                        ni.report_loss = list(indv.report_loss)
                        ni.report_loss_iter = list(indv.report_loss_iter)
                        ni.report_loss_reason = list(indv.report_loss_reason)
                        ni.status.repeated = indv.status.repeated
                        ni.status.finished = True
                    new.individuals.append(ni)
                self.societies[name] = new
                self.indv_to_distribute += new.individuals
            return

        for param in self.society_params_list:
            n = param.get("n_individuals_span", 20)
            fitness_func = param.get("fitness_func", default_fitness)
            soc_name = "".join(
                random.choice(string.ascii_uppercase + string.digits)
                for _ in range(5)
            )
            soc = Society(name=soc_name, fitness_func=fitness_func)
            template = param.get("graph_string_template")
            for i in range(n):
                scope = f"{self.name}/{soc_name}/{i:03d}"
                if template:
                    indv = self._new_individual(scope, template, (), fitness_func)
                else:
                    indv = Individual.create_random(
                        scope,
                        fitness_func=fitness_func,
                        rng=self.rng,
                        **self.kwds,
                    )
                soc.individuals.append(indv)
            self.societies[soc_name] = soc
            self.indv_to_distribute += soc.individuals

    # -- work queue -------------------------------------------------------

    def next_to_evaluate(self) -> Optional[Individual]:
        """Pop the next individual needing evaluation (honors the sparsity
        kill rule, reference ``mpi_overlord.py:199-247``)."""
        threshold = self.generation_property.get("sparsity_threshold", 10.0)
        while self.indv_to_distribute:
            indv = self.indv_to_distribute.pop(0)
            if indv.status.finished:
                continue
            if np.log10(max(indv.sparsity, 1e-300)) < threshold:
                self.indv_to_collect.append(indv)
                return indv
            # too dense: assign a fake (very bad) result and drop
            indv.set_training_result(1e9, -1, REASONS.FAKE_RESULT)
            indv.status.finished = True
        return None

    def collect_result(
        self, indv: Individual, loss: float, iterations: int, reason: int
    ) -> None:
        indv.set_training_result(loss, iterations, reason)
        indv.status.repeated += 1
        if indv.status.repeated >= self.evaluate_repeat:
            indv.status.finished = True
        else:
            # queue for another evaluation round
            self.indv_to_distribute.append(indv)
            if indv in self.indv_to_collect:
                self.indv_to_collect.remove(indv)

    def is_finished(self) -> bool:
        return all(
            i.status.finished
            for soc in self.societies.values()
            for i in soc.individuals
        )

    # -- ranking + evolution ----------------------------------------------

    def evaluate(self) -> None:
        """Rank every society by fitness (lower is better)."""
        for soc in self.societies.values():
            scores = []
            for indv in soc.individuals:
                if indv.report_loss:
                    indv.calculate_fitness()
                    scores.append(indv.fitness_score)
                else:
                    scores.append(float("inf"))
            soc.score_total = scores
            soc.indv_ranking = list(np.argsort(scores))
            soc.finished = True

    def evolve(self) -> None:
        """Top-k selection × n_copy; offspring are mutated copies, or —
        with probability ``evolution_property['crossover_prob']`` — pairs
        produced by single-qubit-line crossover (reference
        ``mpi_generation.py:579-647``; its crossover is a
        ``NotImplementedError`` stub, so ``crossover_prob`` defaults to 0
        for behavioral parity)."""
        top_k = self.evolution_property.get("top_k", 5)
        n_copy = self.evolution_property.get("n_copy", 4)
        cx_prob = float(self.evolution_property.get("crossover_prob", 0.0))
        elitism = int(self.evolution_property.get("elitism", 0))
        # structural mutations applied per offspring (1 = reference parity,
        # mpi_generation.py:613-639 mutates once).  Recovery searches whose
        # goal is many bond-growths away move ~n x faster at n > 1 (the
        # 30q bond-4 recovery needs 29 accepted growths; GA_recover_r03
        # managed 5 in 20 generations at n=1)
        n_mut = max(1, int(self.evolution_property.get(
            "mutations_per_child", 1)))
        mut_weights = self.evolution_property.get("mutation_weights")
        for name, soc in self.societies.items():
            ranked = sorted(
                soc.individuals,
                key=lambda x: x.fitness_score
                if x.fitness_score is not None
                else float("inf"),
            )
            parents = ranked[: min(top_k, len(ranked))]
            target = len(parents) * n_copy
            offspring: List[Individual] = []
            counter = 0

            def next_scope():
                nonlocal counter
                s = f"{self.name}/{name}/{len(ranked) + counter:03d}"
                counter += 1
                return s

            for p in parents[: min(elitism, len(parents))]:
                if len(offspring) >= target:
                    break
                # carried over UNMUTATED, with the parent's evaluation
                # results: the elite keeps its measured fitness instead of
                # being retrained from a fresh random init (fit results
                # are seed-sensitive, so a re-evaluation could score the
                # same graph worse and per-generation best would regress)
                child = self._new_individual(
                    next_scope(), p.graph.to_dsl(), (p.scope,),
                    soc.fitness_func,
                )
                if p.report_loss:
                    child.report_loss = list(p.report_loss)
                    child.report_loss_iter = list(p.report_loss_iter)
                    child.report_loss_reason = list(p.report_loss_reason)
                    child.status.repeated = p.status.repeated
                    child.status.finished = True
                offspring.append(child)
            while len(offspring) < target:
                if (
                    cx_prob > 0.0
                    and len(parents) >= 2
                    and self.rng.uniform() < cx_prob
                ):
                    i, j = self.rng.choice(
                        len(parents), size=2, replace=False
                    )
                    c1, c2 = parents[int(i)].crossover(parents[int(j)])
                    for c in (c1, c2):
                        if len(offspring) >= target:
                            break
                        c.scope = next_scope()
                        offspring.append(c)
                else:
                    p = parents[len(offspring) % len(parents)]
                    child = self._new_individual(
                        next_scope(), p.graph.to_dsl(), (p.scope,),
                        soc.fitness_func,
                    )
                    for _ in range(n_mut):
                        child.mutate(weights=mut_weights)
                    offspring.append(child)
            soc.individuals = offspring

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the population (the reference
        keeps no search state at all; a crashed overlord loses everything)."""
        return {
            "name": self.name,
            "societies": {
                name: [
                    {
                        "scope": i.scope,
                        "graph": i.graph.to_dsl(),
                        "parents": list(i.parents),
                        "losses": i.report_loss,
                        "iters": i.report_loss_iter,
                        "reasons": i.report_loss_reason,
                        "repeated": i.status.repeated,
                        "finished": i.status.finished,
                    }
                    for i in soc.individuals
                ]
                for name, soc in self.societies.items()
            },
        }

    @classmethod
    def restore(
        cls,
        state: dict,
        generation_property: Optional[Dict[str, Any]] = None,
        evolution_property: Optional[Dict[str, Any]] = None,
        rng: Optional[np.random.Generator] = None,
        **kwds,
    ) -> "Generation":
        """Rebuild a generation from :meth:`state_dict`.  Fitness functions
        are not serializable; each society takes the function configured at
        its position in ``generation_property`` (same config as the
        original run)."""
        gen = cls.__new__(cls)
        gen.name = state["name"]
        gen.kwds = kwds
        gen.rng = rng or np.random.default_rng()
        gp = dict(generation_property or {})
        gen.generation_property = gp
        gen.evaluate_repeat = gp.get("evaluate_repeat", 2)
        gen.evolution_property = dict(evolution_property or {})
        gen.indv_to_distribute = []
        gen.indv_to_collect = []
        gen.societies = {}
        gen.society_params_list = _society_params(gp)
        for i, (name, members) in enumerate(state["societies"].items()):
            param = gen.society_params_list[
                min(i, len(gen.society_params_list) - 1)
            ]
            fitness_func = param.get("fitness_func", default_fitness)
            soc = Society(name=name, fitness_func=fitness_func)
            for m in members:
                indv = gen._new_individual(
                    m["scope"], m["graph"], tuple(m["parents"]), fitness_func
                )
                indv.report_loss = [float(x) for x in m["losses"]]
                indv.report_loss_iter = [int(x) for x in m["iters"]]
                indv.report_loss_reason = [int(x) for x in m["reasons"]]
                indv.status.repeated = int(m["repeated"])
                indv.status.finished = bool(m["finished"])
                if indv.report_loss:
                    indv.calculate_fitness()
                soc.individuals.append(indv)
            gen.societies[name] = soc
            gen.indv_to_distribute += [
                i for i in soc.individuals if not i.status.finished
            ]
        return gen

    def best(self) -> Optional[Individual]:
        candidates = [
            i
            for soc in self.societies.values()
            for i in soc.individuals
            if i.fitness_score is not None
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda x: x.fitness_score)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "societies": {
                name: {
                    "n": len(soc),
                    "finished": sum(
                        int(i.status.finished) for i in soc.individuals
                    ),
                    "best_fitness": (
                        soc.best.fitness_score if soc.best is not None else None
                    ),
                }
                for name, soc in self.societies.items()
            },
        }
