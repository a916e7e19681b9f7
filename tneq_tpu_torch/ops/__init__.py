from .chain_overlap import (
    chain_pair_to_mv,
    fused_chain_log_overlap,
    fused_chain_supported,
    mv_chain_log_overlap,
    mv_chain_log_overlap_cuda,
)
from .mps_sweep import is_mps_chain
from .scaling import Scaled, auto_scale

__all__ = [
    "chain_pair_to_mv",
    "fused_chain_log_overlap",
    "fused_chain_supported",
    "mv_chain_log_overlap",
    "mv_chain_log_overlap_cuda",
    "is_mps_chain",
    "Scaled",
    "auto_scale",
]
