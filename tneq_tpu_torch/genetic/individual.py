"""Individual: one candidate circuit structure in the genetic search.

The port's own copy of ``tneq_tpu/genetic/individual.py`` (pure Python
and numpy, same semantics): every random choice takes the individual's
``np.random.Generator``, so a seeded run gives the same structures in both
packages.

Rebuild of the reference ``Individual`` (``tneq_qc/genetic/mpi_generation.py:12-414``):
wraps a :class:`MutableGraph`, mutates by random {bond modify, tensor insert,
tensor remove} with retry (``:154-210``), and scores
``fitness = sparsity + 50·best_loss``.  Unlike the reference (which stubs
sparsity to a constant 0.5, ``:108-132``), sparsity here is computed for
real: parameter count of the candidate relative to the dense full-rank
network on the same qubits.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..graph.dsl import parse_graph
from ..graph.mutable import MutableGraph
from .codes import REASONS, IndividualStatus, default_fitness

__all__ = ["Individual"]


class Individual:
    def __init__(
        self,
        scope: str,
        graph_string: str,
        parents: Tuple[str, ...] = (),
        tn_rank: int = 2,
        fitness_func: Optional[Callable[[float, float], float]] = None,
        discard_hard_timeout_result: bool = False,
        rng: Optional[np.random.Generator] = None,
        **_unused,
    ):
        self.scope = scope
        self.parents = parents
        self.graph = MutableGraph(graph_string)
        self.dim = self.graph.n_qubits
        self.tn_rank = tn_rank
        self.fitness_func = fitness_func or default_fitness
        self.discard_hard_timeout_result = discard_hard_timeout_result
        self.rng = rng or np.random.default_rng()

        self.report_loss: List[float] = []
        self.report_loss_iter: List[int] = []
        self.report_loss_reason: List[int] = []
        self.estimate_score: Optional[float] = None
        self.fitness_score: Optional[float] = None
        self.status = IndividualStatus()
        self.sparsity = self._calculate_sparsity()

    # -- scoring ----------------------------------------------------------

    def _calculate_sparsity(self) -> float:
        """Parameters of this structure / parameters of the dense network.

        Dense reference: one core holding the full input x output boundary
        space.  (The reference returns a constant 0.5 here —
        ``mpi_generation.py:108-132`` — so relative fitness ordering under
        equal-loss is preserved while actual structure size now matters.)
        """
        try:
            g = parse_graph(self.graph.to_dsl())
        except ValueError:
            return float("inf")
        actual = sum(
            int(np.prod(c.shape, dtype=np.int64)) for c in g.cores
        )
        dense = int(
            np.prod(g.input_ranks, dtype=np.float64)
            * np.prod(g.output_ranks, dtype=np.float64)
        )
        return actual / dense if dense > 0 else 0.0

    def calculate_fitness(self) -> float:
        if not self.report_loss:
            self.fitness_score = float("inf")
        else:
            self.fitness_score = self.fitness_func(
                self.sparsity, float(np.min(self.report_loss))
            )
        return self.fitness_score

    # -- mutation (reference mpi_generation.py:154-210) -------------------

    def mutate(self, max_tries: int = 100, weights=None) -> "Individual":
        """One random structural mutation: bond flip, tensor insert, or
        tensor removal on a random qubit, retried until one succeeds.

        ``weights``: optional (bond, insert, remove) operator probabilities
        (normalized here).  The reference draws uniformly
        (``mpi_generation.py:154-210``) — that is also the default — but a
        RECOVERY search whose goal differs from the template only in bond
        ranks moves an order of magnitude faster with bond-heavy weights
        (insert mutations bloat expressivity without closing the planted
        gap; measured in the r04 recovery runs, docs/ROUND4.md).
        """
        if weights is not None:
            w = np.asarray(weights, np.float64)
            if w.shape != (3,) or (w < 0).any() or w.sum() <= 0:
                raise ValueError(
                    "weights must be 3 non-negative numbers (bond, insert, "
                    f"remove) with positive sum, got {weights!r}"
                )
            op = int(self.rng.choice(3, p=w / w.sum()))
        else:
            op = int(self.rng.integers(0, 3))
        for _ in range(max_tries):
            # re-draw the qubit every try: an invalid (qubit, op) pair —
            # e.g. removing from a single-tensor line — would otherwise
            # retry the same doomed site until the budget runs out
            qubit = int(self.rng.integers(0, self.dim))
            line = self.graph.lines[qubit]
            if not line:
                continue
            entry = line[int(self.rng.integers(0, len(line)))]
            try:
                if op == 0:
                    new_bond = int(self.rng.choice([0, self.tn_rank]))
                    self.graph.modify_bond(qubit, entry[0], new_bond)
                elif op == 1:
                    self.graph.insert_tensor_after(qubit, entry[0], rng=self.rng)
                else:
                    self.graph.remove_tensor_from_qubit(qubit, entry[0])
            except ValueError:
                continue
            break
        self.sparsity = self._calculate_sparsity()
        return self

    def crossover(
        self, other: "Individual", max_tries: int = 20
    ) -> Tuple["Individual", "Individual"]:
        """Single-qubit-line crossover: the offspring swap one randomly
        chosen qubit line, retrying until both children parse as valid
        circuits (the reference leaves this unimplemented,
        ``mpi_generation.py:212-231``).  Falls back to mutated copies when no
        valid swap exists."""
        if self.dim != other.dim:
            raise ValueError("crossover requires equal qubit counts")
        for _ in range(max_tries):
            q = int(self.rng.integers(0, self.dim))
            g1, g2 = self.graph.copy(), other.graph.copy()
            g1.lines[q] = list(other.graph.lines[q])
            g2.lines[q] = list(self.graph.lines[q])
            try:
                s1, s2 = g1.to_dsl(), g2.to_dsl()
                parse_graph(s1)
                parse_graph(s2)
            except ValueError:
                continue
            c1 = Individual(
                f"{self.scope}+x", s1,
                parents=(self.scope, other.scope),
                tn_rank=self.tn_rank, fitness_func=self.fitness_func,
                rng=self.rng,
            )
            c2 = Individual(
                f"{other.scope}+x", s2,
                parents=(self.scope, other.scope),
                tn_rank=other.tn_rank, fitness_func=other.fitness_func,
                rng=self.rng,
            )
            return c1, c2
        # no valid swap: fall back to mutation
        c1 = Individual(
            f"{self.scope}+m", self.graph.to_dsl(),
            parents=(self.scope, other.scope), tn_rank=self.tn_rank,
            fitness_func=self.fitness_func, rng=self.rng,
        ).mutate()
        c2 = Individual(
            f"{other.scope}+m", other.graph.to_dsl(),
            parents=(self.scope, other.scope), tn_rank=other.tn_rank,
            fitness_func=other.fitness_func, rng=self.rng,
        ).mutate()
        return c1, c2

    # -- evaluation protocol ----------------------------------------------

    def get_training_info(self) -> dict:
        return {
            "graph_string": self.graph.to_dsl(),
            "scope": self.scope,
            "parents": self.parents,
            "sparsity": self.sparsity,
            "dim": self.dim,
        }

    def set_training_result(
        self, loss: float, iterations: int, reason: int = REASONS.REACH_MAX_ITER
    ) -> bool:
        if self.discard_hard_timeout_result and reason == REASONS.HARD_TIMEOUT:
            return False
        self.report_loss.append(float(loss))
        self.report_loss_iter.append(int(iterations))
        self.report_loss_reason.append(int(reason))
        self.calculate_fitness()
        return True

    # -- factories (reference mpi_generation.py:346-414) ------------------

    @staticmethod
    def create_full_connection(
        scope: str,
        tn_size: int = 4,
        tn_rank: int = 2,
        presented_shape: int = 2,
        **kwds,
    ) -> "Individual":
        """Every qubit line passes through every core, all bonds tn_rank."""
        import string

        names = string.ascii_uppercase[:tn_size]
        shape = (
            presented_shape
            if isinstance(presented_shape, (list, tuple))
            else [presented_shape] * tn_size
        )
        lines = []
        for q in range(tn_size):
            parts = [f"-{shape[q]}-"]
            for j, n in enumerate(names):
                parts.append(n)
                if j < len(names) - 1:
                    parts.append(f"-{tn_rank}-")
            parts.append(f"-{shape[q]}-")
            lines.append("".join(parts))
        return Individual(scope, "\n".join(lines), tn_rank=tn_rank, **kwds)

    @staticmethod
    def create_random(
        scope: str,
        tn_size: int = 4,
        tn_rank: int = 2,
        presented_shape: int = 2,
        init_sparsity: float = 0.5,
        rng: Optional[np.random.Generator] = None,
        **kwds,
    ) -> "Individual":
        """Random subset of bonds dropped with probability ``init_sparsity``
        (negative value: draw the probability uniformly from [-v, 1])."""
        import string

        rng = rng or np.random.default_rng()
        if init_sparsity < 0:
            init_sparsity = float(rng.uniform(-init_sparsity, 1.0))
        names = string.ascii_uppercase[:tn_size]
        shape = (
            presented_shape
            if isinstance(presented_shape, (list, tuple))
            else [presented_shape] * tn_size
        )
        lines = []
        for q in range(tn_size):
            parts = [f"-{shape[q]}-"]
            for j, n in enumerate(names):
                parts.append(n)
                if j < len(names) - 1:
                    keep = rng.uniform() >= init_sparsity
                    parts.append(f"-{tn_rank}-" if keep else "-----")
            parts.append(f"-{shape[q]}-")
            lines.append("".join(parts))
        return Individual(scope, "\n".join(lines), tn_rank=tn_rank, rng=rng, **kwds)

    # -- display ----------------------------------------------------------

    def __repr__(self) -> str:
        return (
            f"Individual(scope={self.scope}, fitness={self.fitness_score}, "
            f"sparsity={self.sparsity:.3f}, evaluated={len(self.report_loss)})"
        )
