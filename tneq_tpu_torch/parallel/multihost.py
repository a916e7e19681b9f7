"""Multi-process start-up: the coordinator settings from the environment,
and ``torch.distributed``'s process group.

Counterpart of ``tneq_tpu/parallel/multihost.py``.  JAX starts
``jax.distributed`` from a coordinator address; here the same settings
start ``torch.distributed.init_process_group`` over TCP.  A one-process run
starts nothing: one process holding every position of a mesh is the
one-process form of ``parallel/mesh.py``.

Backend.  ``"nccl"`` by default, the backend for one rank per card.  NCCL
refuses two ranks on one card, so runs that put several ranks on one card
(the one-card machine, ``chip_smoke.py``) pass ``backend="gloo"``; the
host (``cpu`` meshes) needs ``"gloo"`` too.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

__all__ = ["detect_multihost", "initialize_multihost", "is_main_process"]


def detect_multihost() -> Optional[dict]:
    """Coordinator settings from the environment, or None for one process.

    Read in order: JAX's variables (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), then the launcher variables
    ``MASTER_ADDR``/``MASTER_PORT`` with ``WORLD_SIZE``/``RANK`` (a world of
    more than one).  The keys are JAX's.
    """
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return {
            "coordinator_address": os.environ["JAX_COORDINATOR_ADDRESS"],
            "num_processes": int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            "process_id": int(os.environ.get("JAX_PROCESS_ID", "0")),
        }
    if os.environ.get("MASTER_ADDR") and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        addr = os.environ["MASTER_ADDR"]
        port = os.environ.get("MASTER_PORT", "8476")
        return {
            "coordinator_address": f"{addr}:{port}",
            "num_processes": int(os.environ["WORLD_SIZE"]),
            "process_id": int(os.environ.get("RANK", "0")),
        }
    return None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> bool:
    """Start the process group when multi-process settings are present.

    Explicit arguments win; otherwise the environment is read.  Returns
    True when the group was started, False for one process.
    """
    if coordinator_address is None:
        detected = detect_multihost()
        if detected is None:
            return False
        coordinator_address = detected["coordinator_address"]
        num_processes = detected["num_processes"]
        process_id = detected["process_id"]
    if num_processes is None or num_processes <= 1:
        return False
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_main_process() -> bool:
    """Rank 0, or no process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
