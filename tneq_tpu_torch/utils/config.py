"""Configuration objects.

Counterpart of ``tneq_tpu/utils/config.py`` (pure Python, copied so that
the port imports nothing of the reference package).  Typed dataclass
equivalents of the reference's config module
(``tneq_qc/config.py``): global knobs (``Configuration``), the GA farm's
behavior/experiment/population settings, plus a dotted-path function loader
(``mpi_core.py:85-92``) used to reference fitness/optimizer functions from
YAML/JSON configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from importlib import import_module
from typing import Any, Callable, Dict, List

__all__ = [
    "Configuration",
    "AgentBehavior",
    "GenerationProperty",
    "EvolutionProperty",
    "OverlordProperty",
    "Experiment",
    "load_func",
]


class Configuration:
    """Global defaults (reference ``config.py:1-4``)."""

    initialize_variance: float = 1e-1
    einsum_optimize: str = "auto"  # path strategy, kept for the reference's configs
    default_dtype: str = "complex64"


def load_func(dotpath: str) -> Callable:
    """Resolve ``package.module.function`` (reference ``load_func``)."""
    module_path, func = dotpath.rsplit(".", maxsplit=1)
    return getattr(import_module(module_path), func)


@dataclass
class AgentBehavior:
    """Evaluation-worker knobs (reference ``AgentBehavier``, config.py:6-16)."""

    n_iter: int = 10
    estimation_iter: int = 100
    timeout: float = 1800.0
    allow_waiting_after_timeout_rate: float = 0.5
    max_abnormal_before_block: int = 10


@dataclass
class GenerationProperty:
    n_societies: int = 1
    evaluate_repeat: int = 2
    sparsity_threshold: float = 10.0
    society: List[Dict[str, Any]] = field(
        default_factory=lambda: [dict(n_individuals_span=20)]
    )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "n_societies": self.n_societies,
            "evaluate_repeat": self.evaluate_repeat,
            "sparsity_threshold": self.sparsity_threshold,
            "society_property": {"society": self.society},
        }


@dataclass
class EvolutionProperty:
    top_k: int = 5
    n_copy: int = 4
    mutation_prob: float = 0.2
    elimination_threshold: float = 0.8

    def as_dict(self) -> Dict[str, Any]:
        return {
            "top_k": self.top_k,
            "n_copy": self.n_copy,
            "mutation_prob": self.mutation_prob,
            "elimination_threshold": self.elimination_threshold,
        }


@dataclass
class OverlordProperty:
    max_generation: int = 5
    report_every: float = 30.0


@dataclass
class Experiment:
    """Top-level experiment description (reference ``Experiment``)."""

    name: str = "experiment"
    seed: int = 0
    agent: AgentBehavior = field(default_factory=AgentBehavior)
    generation: GenerationProperty = field(default_factory=GenerationProperty)
    evolution: EvolutionProperty = field(default_factory=EvolutionProperty)
    overlord: OverlordProperty = field(default_factory=OverlordProperty)
    extra: Dict[str, Any] = field(default_factory=dict)
