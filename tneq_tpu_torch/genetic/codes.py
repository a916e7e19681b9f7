"""Status codes and bookkeeping records for the structure search.

The port's own copy of ``tneq_tpu/genetic/codes.py`` (pure Python).

Functional equivalents of the reference's MPI message/status vocabulary
(``tneq_qc/distributed/mpi_core.py:6-92``) — kept so reports and result
protocols read the same, minus the MPI tags (there is no message passing in
this runtime; the work queue is in-process).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

__all__ = ["REASONS", "SURVIVAL", "AgentStatus", "IndividualStatus",
           "default_fitness", "reason_name"]


class REASONS:
    REACH_MAX_ITER = 0
    HARD_TIMEOUT = 1
    FAKE_RESULT = 2


class SURVIVAL:
    HOST_RUNNING = 0
    HOST_NORMAL_FINISHED = 1
    HOST_ABNORMAL_SHUTDOWN = 2


_REASON_NAMES = {v: k for k, v in vars(REASONS).items() if not k.startswith("_")}


def reason_name(code: int) -> str:
    return _REASON_NAMES.get(code, f"UNKNOWN({code})")


def default_fitness(sparsity: float, best_loss: float) -> float:
    """fitness = sparsity + 50·best_loss (reference ``evolve.py:5-8``);
    lower is better."""
    return sparsity + 50.0 * best_loss


@dataclass
class AgentStatus:
    """Per-worker bookkeeping (reference ``AGENT_STATUS``)."""

    assigned_job: Any = None
    estimation_time: float | None = None
    current_iter: int | None = None
    up_time: float = 0.0
    abnormal_counter: int = 0


@dataclass
class IndividualStatus:
    """Per-individual evaluation bookkeeping (reference ``INDIVIDUAL_STATUS``)."""

    assigned: List[int] = field(default_factory=list)
    repeated: int = 0
    finished: bool = False
    minimal_estimation_time: float = 1e9
