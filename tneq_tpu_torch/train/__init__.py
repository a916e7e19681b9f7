from .fit import FitResult, identity_cores, transparent_cores
from .network_fit import (
    make_masked_network_fidelity_fit,
    network_fidelity,
    network_log_fidelity,
)

__all__ = [
    "FitResult",
    "identity_cores",
    "transparent_cores",
    "make_masked_network_fidelity_fit",
    "network_fidelity",
    "network_log_fidelity",
]
