"""The one generator of inputs at toy sizes: the same seed gives the same
inputs, every seed the same sizes, and seeds past 32 bits work."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import traffic
from port_bench.tests.conftest import FIXTURE
from port_bench.weights import haar_cores, weights_generator

CPU = torch.device("cpu")
SEEDS = (0, 2 ** 31 + 3, 2 ** 33 + 11)


def _load(name):
    return json.loads((FIXTURE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_batches_are_fixed_by_the_seed(seed):
    t = _load("b16")
    a = traffic.batches(t, seed, 5, CPU)
    b = traffic.batches(t, seed, 5, CPU)
    assert len(a) == t["n_batches"]
    assert all(x.shape == (t["batch_size"], 5) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = traffic.batches(t, seed + 1, 5, CPU)
    assert not torch.equal(a[0], other[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_prune_round_plants_the_traffic_count(seed):
    t = _load("prune_network")
    shapes = {n: (2, 2, 2, 2) for n in "abcdef"}
    planted, cores = traffic.prune_round(t, seed, shapes, torch.complex64, CPU)
    again, cores2 = traffic.prune_round(t, seed, shapes, torch.complex64, CPU)
    assert planted == again and len(planted) == t["planted"]
    assert all(0 <= i < len(shapes) for i in planted)
    assert all(torch.equal(cores[n], cores2[n]) for n in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_haar_cores_are_isometries(dtype):
    shapes = {"a": (2, 4, 4, 8), "b": (8, 4, 4, 8), "c": (8, 4, 4, 2)}
    cores = haar_cores(shapes, dtype, weights_generator(5, CPU), CPU)
    for name, shape in shapes.items():
        c = cores[name]
        assert tuple(c.shape) == shape and c.dtype == dtype
        m = c.reshape(shape[0] * shape[1], -1)
        gram = m @ m.conj().T if m.shape[0] <= m.shape[1] else m.conj().T @ m
        assert torch.allclose(gram, torch.eye(gram.shape[0], dtype=dtype), atol=1e-5)


def test_unknown_traffic_kind_raises():
    with pytest.raises(ValueError):
        traffic.batches({"kind": "poisson"}, 0, 4, CPU)
