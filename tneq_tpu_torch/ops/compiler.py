"""Strategy compiler: pick the contraction for a circuit.

Counterpart of ``tneq_tpu/ops/compiler.py`` (``compile_siamese``,
``estimate_cost``).  Dispatch is structural:

- an MPS chain with unbatched states and one batch axis on the measures
  takes the transfer sweep (``ops/mps_sweep.py``), through the B3/B4
  kernels when ``use_kernel`` (float32 and complex64 only: a caller in
  another dtype passes ``use_kernel=False``, as ``Trainer`` does);
- a mesh whose ``model`` axis is > 1 (or ``mode='sliced'``) takes the
  bond-sliced contraction over that axis (``parallel/mp.py``);
- everything else takes the general einsum path (``ops/contract.py``:
  pairwise ``torch.einsum`` steps along the native path).
"""

from __future__ import annotations

from typing import Callable, Tuple

from ..graph.dsl import CircuitGraph
from ..native.path import path_cost
from .contract import make_siamese_fn
from .einsum_spec import siamese_spec
from .mps_sweep import is_mps_chain, mps_sweep_siamese_fn

__all__ = ["compile_siamese", "estimate_cost"]


def estimate_cost(graph: CircuitGraph, batch: int = 1) -> float:
    """Estimated element-ops of the siamese contraction (the native greedy
    path's cost model)."""
    spec = siamese_spec(graph, with_states=True, states_batched=False)
    shapes = []
    for kind, key in spec.operands:
        if kind in ("core", "core_conj"):
            shapes.append(graph.shapes[key])
        elif kind in ("state", "state_conj"):
            shapes.append((graph.input_ranks[key],))
        else:
            shapes.append((batch, graph.output_ranks[key], graph.output_ranks[key]))
    return path_cost(spec.equation, shapes)


def compile_siamese(
    graph: CircuitGraph,
    mesh=None,
    states_batched: bool = False,
    measure_extra_dims: int = 1,
    mode: str = "auto",
    use_kernel: bool = True,
) -> Tuple[Callable, str]:
    """``(compute_fn, strategy_name)`` for the siamese contraction;
    ``compute_fn(params, states, measures)`` as ``make_siamese_fn``'s.

    ``mode``: 'auto' (structural dispatch), 'mps_sweep', 'einsum',
    'sliced' (needs ``mesh``, a ``parallel.make_mesh``).  The sweep is
    named ``"mps_sweep_cuda"`` with the kernels and ``"mps_sweep"`` without
    them; the einsum path ``"einsum_pairwise"`` (JAX's ``"einsum_xla"``);
    the sliced contraction ``"sliced_shard_map"``, JAX's name.
    """
    if mode not in ("auto", "einsum", "mps_sweep", "sliced"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "sliced" or (
        mode == "auto" and mesh is not None and mesh.shape.get("model", 1) > 1
    ):
        # imported here: parallel/mp imports this package's modules
        from ..parallel.mp import make_sliced_siamese_fn

        if mesh is None:
            raise ValueError("sliced strategy needs a mesh")
        return (
            make_sliced_siamese_fn(graph, mesh, states_batched=states_batched,
                                   measure_extra_dims=measure_extra_dims),
            "sliced_shard_map",
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
    return (
        make_siamese_fn(
            graph,
            with_states=True,
            states_batched=states_batched,
            measure_extra_dims=measure_extra_dims,
        ),
        "einsum_pairwise",
    )
