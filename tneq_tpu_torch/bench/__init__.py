"""Benchmark suite — the analogue of the reference's ``tools/`` stages.

Counterpart of ``tneq_tpu/bench/__init__.py``: each stage is a function
returning a JSON record with the reference package's keys, measured on the
card (``device="cuda"``) against one H100's published peaks: matmul peak,
HBM bandwidth, transpose cost, collectives across ``torch.distributed``
ranks, checkpoint IO, and end-to-end QCTN contraction throughput.

Run: ``python -m tneq_tpu_torch.bench.run_all [--stages 1,2,...] [--out DIR] [--device cuda]``.
"""

from .microbench import (
    stage_env_audit,
    stage_matmul_peak,
    stage_dtype_policy,
    stage_memory_bandwidth,
    stage_transpose_cost,
    stage_collectives,
    stage_checkpoint_io,
    stage_tn_workload,
    stage_large_network,
    ALL_STAGES,
)

__all__ = [
    "stage_env_audit",
    "stage_matmul_peak",
    "stage_dtype_policy",
    "stage_memory_bandwidth",
    "stage_transpose_cost",
    "stage_collectives",
    "stage_checkpoint_io",
    "stage_tn_workload",
    "stage_large_network",
    "ALL_STAGES",
]
