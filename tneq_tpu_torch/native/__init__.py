"""Native (C++) runtime components, loaded through ctypes.

Counterpart of ``tneq_tpu/native``: the contraction-path finder, built with
``g++`` at its first use (``native/build.py``).
"""

from .build import load_library
from .path import find_path, parse_equation, path_cost

__all__ = ["load_library", "find_path", "parse_equation", "path_cost"]
