from .qctn import init_params, orthogonal_core, params_from_numpy, params_to_numpy

__all__ = ["init_params", "orthogonal_core", "params_from_numpy", "params_to_numpy"]
