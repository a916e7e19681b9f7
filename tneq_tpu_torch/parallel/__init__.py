"""The parallel layer: a named device mesh, data parallelism, bond-sliced
contractions over its ``model`` axis, model-state sharding, the
distributed trainer, health checks and multi-process start-up.

Counterpart of ``tneq_tpu/parallel``, with every name of its ``__all__``.
Each function runs in one of two forms (``parallel/mesh.py``): one
process holding every position of the mesh on one device (the one-card
form), or one ``torch.distributed`` rank per position.  ``dryrun.
dryrun_multichip`` runs JAX's four multi-device sub-checks, and
``fsdp`` holds the stacked, split model state.
"""

from .dp import make_dp_train_step, shard_batch
from .health import check_mesh_health
from .mesh import Mesh, data_sharding, make_mesh, replicated
from .mp import choose_slice_bonds, make_sliced_siamese_fn, sliced_nll_loss
from .multihost import detect_multihost, initialize_multihost, is_main_process
from .trainer import DistributedConfig, DistributedTrainer

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "make_dp_train_step",
    "shard_batch",
    "choose_slice_bonds",
    "make_sliced_siamese_fn",
    "sliced_nll_loss",
    "DistributedConfig",
    "DistributedTrainer",
    "check_mesh_health",
    "detect_multihost",
    "initialize_multihost",
    "is_main_process",
]
