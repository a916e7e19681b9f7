from .checkpoint import CheckpointManager
from .device import matmul_precision, resolve_device

__all__ = ["CheckpointManager", "matmul_precision", "resolve_device"]
