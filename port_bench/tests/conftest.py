"""Shared pieces of the harness's CPU tests: the toy fixture (a 4 × 2 brick
wall and a 5-qubit bond-3 float32 Born-rule chain, with their own limits) and a
run of one of its cells on the host.

    python -m pytest -p no:cacheprovider port_bench/tests
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from port_bench import spec
from port_bench.run import run_cell

FIXTURE = Path(__file__).resolve().parent / "fixture"
BRICK = "brick4x2_c64.prune_network"
BORN = "born5_d3_f32.b16"


def toy_cell(workload: str) -> spec.Cell:
    return spec.load_cell(workload, root=FIXTURE, traffic_dir=FIXTURE / "traffic")


def toy_run(workload: str, seed: int = 2 ** 31 + 7, trace: bool = False,
            seconds: float = 0.5) -> dict:
    """The result object of one run of a fixture cell on the host."""
    return run_cell(toy_cell(workload), seed, seconds, trace, torch.device("cpu"),
                    time.time())[0]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
