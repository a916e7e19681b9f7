from .codes import REASONS, SURVIVAL, AgentStatus, IndividualStatus, default_fitness
from .individual import Individual
from .generation import Generation, Society
from .evaluator import CandidateEvaluator
from .farm import DeviceFarm
from .search import EvolutionSearch

__all__ = [
    "REASONS",
    "SURVIVAL",
    "AgentStatus",
    "IndividualStatus",
    "default_fitness",
    "Individual",
    "Generation",
    "Society",
    "CandidateEvaluator",
    "DeviceFarm",
    "EvolutionSearch",
]
