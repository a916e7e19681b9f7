"""PyTorch/CUDA port of ``tneq_tpu`` for NVIDIA Hopper (H100).

The JAX package ``tneq_tpu`` stays the reference; this package mirrors its
layout module by module (``tneq_tpu_torch/train/network_fit.py`` is the
counterpart of ``tneq_tpu/train/network_fit.py``) and never imports JAX or
anything of ``tneq_tpu``.  Parameters are plain ``{core_name: Tensor}``
dicts with the JAX package's axis order, so weights cross between the two
packages through numpy (``model.qctn.params_from_numpy``).

Entry points take ``device=`` and default to ``"cuda"``; on a machine
without a card they raise unless the caller passes ``device="cpu"``.  The
hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/cuda_build.py``); the contraction-path finder in
``native/`` is built with ``g++`` at first use (``native/build.py``).
"""

__version__ = "0.1.0"

from .graph import CircuitGraph, CoreSpec, Edge, parse_graph
from .model import QCTN

__all__ = ["CircuitGraph", "CoreSpec", "Edge", "parse_graph", "QCTN"]
