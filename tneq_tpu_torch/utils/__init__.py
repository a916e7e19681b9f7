from .device import matmul_precision, resolve_device

__all__ = ["matmul_precision", "resolve_device"]
