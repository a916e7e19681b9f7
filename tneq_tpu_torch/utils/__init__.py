from .config import (
    Configuration,
    AgentBehavior,
    GenerationProperty,
    EvolutionProperty,
    OverlordProperty,
    Experiment,
)
from .logging import setup_logger, setup_colored_logger, Colors
from .checkpoint import CheckpointManager
from .callbacks import CallbackList, ExperimentRecorder
from .profiling import StepTimer, trace, annotate, spans, clear_spans
from .device import matmul_precision, resolve_device

__all__ = [
    "Configuration",
    "AgentBehavior",
    "GenerationProperty",
    "EvolutionProperty",
    "OverlordProperty",
    "Experiment",
    "setup_logger",
    "setup_colored_logger",
    "Colors",
    "CheckpointManager",
    "CallbackList",
    "ExperimentRecorder",
    "StepTimer",
    "trace",
    "annotate",
    "spans",
    "clear_spans",
    "matmul_precision",
    "resolve_device",
]
