"""Exact FLOP accounting for contraction workloads, against the H100's peaks.

Counterpart of ``tneq_tpu/bench/flops.py``.  The counters are the reference
package's, on the port's path finder and pairwise executor, and return the
same numbers for the same graph:

- one real multiply-add = 2 FLOPs;
- a complex multiply-add = 8 real FLOPs (4 mult + 4 add);
- a pairwise einsum step costs ``2 * prod(union-of-index sizes)``;
- a gradient step costs ``3x`` the forward contraction (each pairwise
  product's VJP is two products of the same size).

The peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense rates
at the 700 W power limit): 989 TFLOP/s bf16 (tensor cores), 495 TF32, 67
float32 outside the tensor cores, 3.35 TB/s HBM.  The port pins float32
matmuls to 'highest' (TF32 off), so float32 and complex64 divide by 67 at
its default and at 'highest', by 495 at 'high' (TF32); bfloat16 by 989.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "einsum_flops",
    "overlap_flops",
    "network_fidelity_step_flops",
    "PEAK_TFLOPS",
    "mxu_utilization",
]

# H100 SXM peaks per dtype at the port's default matmul precision ('highest':
# float32 and complex64 run on the CUDA cores), and at 'high' (TF32 tensor
# cores).  The keys keep the reference package's names.
PEAK_TFLOPS: Dict[str, float] = {
    "bfloat16": 989.0,
    "float32": 67.0,
    "complex64": 67.0,
}
PEAK_TFLOPS_HIGHEST: Dict[str, float] = dict(PEAK_TFLOPS)
PEAK_TFLOPS_HIGH: Dict[str, float] = {
    "bfloat16": 989.0,
    "float32": 495.0,
    "complex64": 495.0,
}
PEAK_HBM_TBPS = 3.35
# the card's own ceiling: one bf16 8192 x 8192 x 8192 matmul per timed call
# (stage 2, ``stage_matmul_peak(sizes=(8192,), dtypes=("bfloat16",))``),
# the median of three calls (810.8, 827.9, 870.5 TFLOP/s) on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit (0.84 of the 989 TFLOP/s peak)
MEASURED_MATMUL_TFLOPS = 827.9


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _complex_factor(dtype) -> float:
    return 4.0 if _dtype_name(dtype).startswith("complex") else 1.0


def einsum_flops(
    equation: str,
    shapes: Sequence[Tuple[int, ...]],
    path: Optional[Sequence[Tuple[int, int]]] = None,
    dtype=np.float32,
) -> float:
    """Exact FLOPs of executing ``equation`` along ``path`` (default: the
    same memory-guarded path the runtime uses, so the count matches what
    actually runs)."""
    from ..ops.pairwise import choose_path, path_flops

    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    if path is None:
        path = choose_path(equation, shapes)
    return path_flops(equation, shapes, list(path)) * _complex_factor(dtype)


def overlap_flops(graph, dtype=np.float32) -> float:
    """Forward FLOPs of one two-network overlap ⟨A, B⟩ of ``graph`` with
    itself, counted along the reference package's path: the linear sweep
    for uniform MPS chains, else the pairwise executor's chosen path
    (``ops/pairwise.make_log_abs_overlap_fn``)."""
    from ..ops.einsum_spec import two_network_spec
    from ..ops.mps_sweep import is_mps_chain
    from ..ops.pairwise import _linear_path, row_major_core_order

    spec = two_network_spec(graph, graph)
    lhs, rhs = spec.equation.split("->")
    subs = lhs.split(",")
    n = graph.ncores
    order = row_major_core_order(graph)
    perm = []
    for k in order:
        perm.extend((k, n + k))
    equation = ",".join(subs[p] for p in perm) + "->" + rhs
    shapes = []
    for k in order:
        s = graph.cores[k].shape
        shapes.extend((s, s))
    path = _linear_path(len(shapes)) if is_mps_chain(graph) else None
    return einsum_flops(equation, shapes, path=path, dtype=dtype)


def network_fidelity_step_flops(
    graph, dtype=np.float32, gradient: bool = True
) -> float:
    """FLOPs of one network-fidelity training step.

    Forward = 3 overlaps (⟨p,t⟩, ⟨p,p⟩, ⟨t,t⟩).  The gradient step counts
    fwd = 2 overlaps and bwd = 2·2 overlaps (⟨t,t⟩ needs no gradient): the
    6x model of the reference package.
    """
    ov = overlap_flops(graph, dtype)
    if not gradient:
        return 3.0 * ov
    return 6.0 * ov


def siamese_flops(
    graph, batch: int, dtype=np.float32, gradient: bool = False
) -> float:
    """Forward FLOPs of the batched siamese Born-rule contraction."""
    from ..ops.einsum_spec import siamese_spec

    spec = siamese_spec(graph, with_states=True, states_batched=False)
    shapes = []
    for kind, key in spec.operands:
        if kind in ("core", "core_conj"):
            shapes.append(graph.shapes[key])
        elif kind in ("state", "state_conj"):
            shapes.append((graph.input_ranks[key],))
        else:
            r = graph.output_ranks[key]
            shapes.append((batch, r, r))
    fwd = einsum_flops(spec.equation, shapes, dtype=dtype)
    return fwd * (3.0 if gradient else 1.0)


def mxu_utilization(
    tflops_achieved: float, dtype=np.float32, precision: str = "default"
) -> float:
    """Share of one H100's peak for this dtype and matmul precision (the
    name is the reference package's).

    ``'default'`` and ``'highest'`` (the port's pinned setting: float32 and
    complex64 on the CUDA cores) divide float32/complex64 by 67 TFLOP/s,
    ``'high'`` (TF32) by 495; bfloat16 always by 989.
    """
    key = _dtype_name(dtype)
    table = {
        "highest": PEAK_TFLOPS_HIGHEST,
        "high": PEAK_TFLOPS_HIGH,
    }.get(precision, PEAK_TFLOPS)
    peak = table.get(key, table["float32"])
    return tflops_achieved / peak


def practical_utilization(tflops_achieved: float) -> float:
    """Share of the card's MEASURED bf16 matmul throughput
    (``MEASURED_MATMUL_TFLOPS``): what it demonstrably delivers on large
    matmuls."""
    return tflops_achieved / MEASURED_MATMUL_TFLOPS
