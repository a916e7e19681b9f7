"""The port stands alone: it imports neither JAX nor ``tneq_tpu``, and its
entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tneq_tpu_torch.graph import mps_graph, parse_graph
from tneq_tpu_torch.model.qctn import (
    init_params,
    orthogonal_core,
    params_from_numpy,
    params_to_numpy,
)
from tneq_tpu_torch.utils.device import matmul_precision, resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import tneq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tneq_tpu_torch.__path__, "tneq_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "optax", "tneq_tpu")
             or m.startswith(("jax.", "jaxlib.", "optax.", "tneq_tpu.")))
print(len(names), bad)
assert not bad, bad
assert "tneq_tpu_torch.ops.row_scan" in names and "tneq_tpu_torch.ops.pairwise" in names
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every module of the slice was imported


def test_entry_points_default_to_the_card():
    g = parse_graph(mps_graph(4, dim=2))
    if torch.cuda.is_available():
        p = init_params(g, 0, torch.float32)
        assert all(v.is_cuda for v in p.values())
        from tneq_tpu_torch.model.qctn import QCTN
        from tneq_tpu_torch.train.trainer import Trainer

        assert Trainer(g).device.type == "cuda"
        from tneq_tpu_torch.apps.symmetry_breaking import make_experiment

        assert make_experiment().device.type == "cuda"
        from tneq_tpu_torch.apps.symmetry_breaking import SymmetryBreakingConfig

        assert make_experiment(SymmetryBreakingConfig(fidelity_mode="network")).device.type \
            == "cuda"
        assert all(v.is_cuda for v in QCTN(mps_graph(4, dim=2)).params.values())
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(g, 0, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig,
        make_experiment,
    )

    with pytest.raises(RuntimeError):
        make_experiment(SymmetryBreakingConfig(topology="mps", fidelity_mode="network"))
    # the brick-wall default, through the app and its CLI
    from tneq_tpu_torch.apps.symmetry_breaking import main as brick_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_experiment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brick_main(["--n-qubits", "4", "--n-cells", "2", "--restarts", "1"])
    # the brick wall in network mode, through the app and its CLI
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_experiment(SymmetryBreakingConfig(fidelity_mode="network"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brick_main(["--n-qubits", "4", "--n-cells", "2", "--restarts", "1",
                    "--fidelity-mode", "network"])
    from tneq_tpu_torch.apps.train_single_node import main
    from tneq_tpu_torch.model.qctn import QCTN
    from tneq_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QCTN(mps_graph(4, dim=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    g = parse_graph(mps_graph(4, dim=2))
    p = init_params(g, 0, torch.float32, device="cpu")
    assert all(v.device.type == "cpu" for v in p.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2, 2, 2), (2, 2, 2, 4), (4, 2, 2, 2)])
def test_orthogonal_core_is_an_isometry(dtype, shape):
    c = orthogonal_core(0, shape, dtype, device="cpu")
    assert c.shape == shape and c.dtype == dtype
    rows = int(np.prod(shape[:2]))
    m = c.reshape(rows, -1)
    gram = m @ m.conj().T if m.shape[0] <= m.shape[1] else m.conj().T @ m
    eye = torch.eye(gram.shape[0], dtype=dtype)
    torch.testing.assert_close(gram, eye, atol=1e-5, rtol=0)


def test_init_params_seeded_and_numpy_roundtrip():
    g = parse_graph(mps_graph(5, dim=3, phys=2))
    a = init_params(g, 7, torch.complex64, device="cpu")
    b = init_params(g, 7, torch.complex64, device="cpu")
    assert list(a) == list(g.core_names)
    for k in a:
        assert a[k].shape == g.shapes[k]
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    back = params_from_numpy(params_to_numpy(a), "cpu")
    for k in a:
        torch.testing.assert_close(back[k], a[k], rtol=0, atol=0)
    cast = params_from_numpy(params_to_numpy(a), "cpu", dtype=torch.complex128)
    assert all(v.dtype == torch.complex128 for v in cast.values())


def test_matmul_precision_scoped():
    before = torch.get_float32_matmul_precision()
    with matmul_precision("default"):
        assert torch.get_float32_matmul_precision() == "medium"
    with matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError):
        with matmul_precision("bogus"):
            pass
