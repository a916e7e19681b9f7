"""What a run must hold to before and after its window.

- Build and kernel caches at fixed paths inside the checkout, set before
  torch is imported: the port builds its CUDA kernels and path finder into
  ``tneq_tpu_torch/_build/`` itself; ``TORCH_EXTENSIONS_DIR`` and
  ``TRITON_CACHE_DIR`` are pinned to ``.bench_cache/`` for any library
  that would build there.
- No JAX: once the window has closed, the process may hold none of the
  modules named in ``FORBIDDEN`` (compared by whole top-level names: the
  port's name begins with the JAX package's).
"""

from __future__ import annotations

import os
import sys
from typing import List

from .spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "tneq_tpu")


def pin_caches() -> None:
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
