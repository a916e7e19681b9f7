"""The parallel layer: a named device mesh and bond-sliced contractions over
its ``model`` axis.

Counterpart of ``tneq_tpu/parallel``.  Ported: ``mesh.make_mesh`` and
``mp`` (ROADMAP A, item 11a).  The data-parallel step, the distributed
trainer, health checks and multi-host start-up (item 11b) and FSDP (item
11c) are still to come.
"""

from .mesh import Mesh, make_mesh
from .mp import choose_slice_bonds, make_sliced_siamese_fn, sliced_nll_loss

__all__ = [
    "make_mesh",
    "choose_slice_bonds",
    "make_sliced_siamese_fn",
    "sliced_nll_loss",
]
