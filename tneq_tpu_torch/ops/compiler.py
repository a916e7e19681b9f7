"""Strategy compiler: pick the contraction for a circuit.

Counterpart of ``tneq_tpu/ops/compiler.py`` (``compile_siamese``).  So far
only the chain strategy is ported: an MPS chain with unbatched states and
one batch axis on the measures takes the transfer sweep
(``ops/mps_sweep.py``), through the B3/B4 kernels when ``use_kernel``.  The
general einsum path and non-chain graphs wait for ``ops/einsum_spec.py``
(ROADMAP A, item 7), the index-sliced strategy for the parallel layer
(item 11), and ``estimate_cost`` for the native path finder (item 10).
"""

from __future__ import annotations

from typing import Callable, Tuple

from ..graph.dsl import CircuitGraph
from .mps_sweep import is_mps_chain, mps_sweep_siamese_fn

__all__ = ["compile_siamese"]


def compile_siamese(
    graph: CircuitGraph,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
    mode: str = "auto",
    use_kernel: bool = True,
) -> Tuple[Callable, str]:
    """``(compute_fn, strategy_name)`` for the siamese contraction;
    ``compute_fn(params, states, measures)`` as ``make_siamese_fn``'s.

    ``mode``: 'auto' (structural dispatch), 'mps_sweep', 'einsum',
    'sliced'.  The sweep is named ``"mps_sweep_cuda"`` with the kernels
    and ``"mps_sweep"`` without them.
    """
    if mode not in ("auto", "einsum", "mps_sweep", "sliced"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "sliced":
        raise NotImplementedError(
            "the index-sliced strategy waits for the parallel layer (ROADMAP A, item 11)"
        )
    if mode == "mps_sweep" or (
        mode == "auto"
        and is_mps_chain(graph)
        and not states_batched
        and measure_extra_dims == 1
    ):
        if not is_mps_chain(graph):
            raise ValueError("graph is not an MPS chain")
        name = "mps_sweep_cuda" if use_kernel else "mps_sweep"
        return mps_sweep_siamese_fn(graph, use_kernel=use_kernel), name
    raise NotImplementedError(
        "the general einsum contraction (non-chain graphs, batched states, "
        "extra measure axes) waits for ops/einsum_spec.py (ROADMAP A, item 7)"
    )
