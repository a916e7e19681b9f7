from .data import cycle_batches, gaussian_batches, shuffled_epochs
from .fit import FitResult, identity_cores, make_masked_fidelity_fit, transparent_cores
from .losses import fidelity, fidelity_loss, nll_loss
from .network_fit import (
    make_masked_network_fidelity_fit,
    network_fidelity,
    network_log_fidelity,
)
from .trainer import Trainer, TrainingConfig, TrainingStats, basis_states

__all__ = [
    "cycle_batches",
    "gaussian_batches",
    "shuffled_epochs",
    "fidelity",
    "fidelity_loss",
    "nll_loss",
    "Trainer",
    "TrainingConfig",
    "TrainingStats",
    "basis_states",
    "FitResult",
    "identity_cores",
    "transparent_cores",
    "make_masked_fidelity_fit",
    "make_masked_network_fidelity_fit",
    "network_fidelity",
    "network_log_fidelity",
]
