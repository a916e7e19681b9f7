from .qctn import QCTN, init_params, orthogonal_core, params_from_numpy, params_to_numpy

__all__ = ["QCTN", "init_params", "orthogonal_core", "params_from_numpy", "params_to_numpy"]
