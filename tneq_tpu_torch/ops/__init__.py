from .chain_overlap import (
    chain_pair_to_mv,
    fused_chain_log_overlap,
    fused_chain_supported,
    mv_chain_log_overlap,
    mv_chain_log_overlap_cuda,
)
from .compiler import compile_siamese, estimate_cost
from .complex_pair import (
    from_pair,
    make_pair_siamese_fn,
    pair_abs2,
    pair_tree,
    to_pair,
    unpair_tree,
)
from .contract import (
    abs_square,
    contract_cores,
    make_core_only_fn,
    make_siamese_env_fn,
    make_siamese_fn,
    make_two_network_fn,
    make_with_inputs_fn,
    siamese_probability,
)
from .features import generate_data, hermite_phi, hermite_weights, measurement_matrices
from .mps_sweep import is_mps_chain, mps_sweep_siamese_fn
from .scaling import Scaled, auto_scale, scaled_siamese_fn

__all__ = [
    "chain_pair_to_mv",
    "fused_chain_log_overlap",
    "fused_chain_supported",
    "mv_chain_log_overlap",
    "mv_chain_log_overlap_cuda",
    "compile_siamese",
    "estimate_cost",
    "from_pair",
    "make_pair_siamese_fn",
    "pair_abs2",
    "pair_tree",
    "to_pair",
    "unpair_tree",
    "abs_square",
    "contract_cores",
    "make_core_only_fn",
    "make_siamese_env_fn",
    "make_siamese_fn",
    "make_two_network_fn",
    "make_with_inputs_fn",
    "siamese_probability",
    "generate_data",
    "hermite_phi",
    "hermite_weights",
    "measurement_matrices",
    "is_mps_chain",
    "mps_sweep_siamese_fn",
    "Scaled",
    "auto_scale",
    "scaled_siamese_fn",
]
