"""The port stands alone: it imports neither JAX, ``tneq_tpu`` nor the
``safetensors`` package (the machine with the card lacks it), and its
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
             if m in ("jax", "jaxlib", "optax", "tneq_tpu", "safetensors")
             or m.startswith(("jax.", "jaxlib.", "optax.", "tneq_tpu.", "safetensors.")))
print(len(names), bad)
assert not bad, bad
assert "tneq_tpu_torch.ops.row_scan" in names and "tneq_tpu_torch.ops.pairwise" in names
assert "tneq_tpu_torch.ops.complex_pair" in names
assert "tneq_tpu_torch.optim.pair_stiefel" in names
for m in ("infer", "infer.probability", "infer.sampling", "infer.chain_sampling", "engine",
          "bench.sample_probe", "bench.large_n_probe"):
    assert "tneq_tpu_torch." + m in names, m
for m in ("graph.mutable", "graph.surgery", "genetic", "genetic.codes", "genetic.individual",
          "genetic.generation", "genetic.evaluator", "genetic.farm", "genetic.search",
          "apps.structure_search", "apps.merge_split_demo"):
    assert "tneq_tpu_torch." + m in names, m
for m in ("parallel", "parallel.mesh", "parallel.mp", "utils.checkpoint", "utils._safetensors"):
    assert "tneq_tpu_torch." + m in names, m
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
        from tneq_tpu_torch.engine import EngineSiamese
        from tneq_tpu_torch.infer import sample

        assert EngineSiamese().device.type == "cuda"
        gen = torch.Generator(device="cuda").manual_seed(0)
        states = [torch.eye(2, device="cuda")[0]] * 4
        assert sample(g, p, states, 4, 2, gen, dtype=torch.float32).is_cuda
        from tneq_tpu_torch.genetic import CandidateEvaluator, DeviceFarm

        farm = DeviceFarm(CandidateEvaluator(g, p))
        assert [d.type for d in farm.devices] == ["cuda"] * torch.cuda.device_count()
        farm.shutdown()
        from tneq_tpu_torch.parallel import make_mesh

        assert [d.type for d in make_mesh().devices.flat] == ["cuda"] * torch.cuda.device_count()
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
    # inference: the sampler draws on the params' device, from a generator
    # there; the facade and the two probes default to the card
    from tneq_tpu_torch.bench import large_n_probe, sample_probe
    from tneq_tpu_torch.engine import EngineSiamese
    from tneq_tpu_torch.infer import sample

    p = init_params(g, 0, torch.float32, device="cpu")
    states = [torch.eye(2)[0]] * 4
    with pytest.raises(RuntimeError):
        sample(g, p, states, 4, 2, torch.Generator(device="cuda"), dtype=torch.float32)
    assert sample(g, p, states, 4, 2, torch.Generator(), dtype=torch.float32).shape == (4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineSiamese()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        large_n_probe.fit_and_sample(4, 2, steps=1, samples=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        large_n_probe.main(["--qubits", "4", "--dim", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_probe.main(["--qubits", "4"])
    # the structure search: the farm's default devices, the CLI and the
    # merge/split demo
    from tneq_tpu_torch.apps import merge_split_demo, structure_search
    from tneq_tpu_torch.genetic import CandidateEvaluator, DeviceFarm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFarm(CandidateEvaluator(g, p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        structure_search.main(["--tn-size", "3", "--generations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merge_split_demo.main([])
    # the mesh of the bond-sliced overlaps, and the CLI that builds one
    from tneq_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"model": 2}, devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brick_main(["--n-qubits", "4", "--n-cells", "2", "--restarts", "1",
                    "--fidelity-mode", "network", "--slice-devices", "2"])
    assert make_mesh({"model": 2}, devices=["cpu"] * 2).shape == {"model": 2}


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


# names of JAX's subpackage __all__ lists that the port does not export yet,
# each with the ROADMAP item that ports it
_NOT_YET = {
    "bench": ({"ALL_STAGES", "stage_checkpoint_io", "stage_collectives",
               "stage_dtype_policy", "stage_env_audit", "stage_large_network",
               "stage_matmul_peak", "stage_memory_bandwidth", "stage_tn_workload",
               "stage_transpose_cost"}, "13a"),
    "utils": ({"AgentBehavior", "CallbackList", "Colors", "Configuration",
               "EvolutionProperty", "Experiment", "ExperimentRecorder",
               "GenerationProperty", "OverlordProperty", "StepTimer", "annotate",
               "setup_colored_logger", "setup_logger", "trace"}, "12b"),
}


def _exported(path):
    """A package's ``__all__``, or without one the public names its
    ``__init__`` imports from its own modules (``ast``: no import runs)."""
    import ast

    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level >= 1
            for a in node.names if not (a.asname or a.name).startswith("_")}


def test_port_exports_the_reference_public_names():
    """Every name of each ``tneq_tpu`` package's ``__all__`` (the top level's
    imports) is in the port's, less ``_NOT_YET``; the names listed there are
    missing still (and nothing else is)."""
    import pathlib

    root = pathlib.Path(REPO)
    checked = 0
    for init in sorted((root / "tneq_tpu").rglob("__init__.py")):
        rel = init.relative_to(root / "tneq_tpu")
        ours = root / "tneq_tpu_torch" / rel
        assert ours.exists(), f"tneq_tpu_torch/{rel.parent} is missing"
        missing = _exported(init) - _exported(ours)
        pending, _ = _NOT_YET.get(str(rel.parent), (set(), None))
        assert missing == pending, (str(rel.parent), sorted(missing ^ pending))
        checked += 1
    assert checked >= 12
    from tneq_tpu_torch import QCTN, CircuitGraph, CoreSpec, Edge, parse_graph  # noqa: F401
    from tneq_tpu_torch.native import native_available

    assert native_available()


@pytest.mark.parametrize("module", ["dp", "fsdp", "health", "mesh", "mp", "multihost",
                                    "trainer"])
def test_parallel_modules_export_the_reference_names(module):
    """Each module of ``tneq_tpu/parallel`` has its counterpart in the port
    with every name of its ``__all__`` (``fsdp`` included, which the
    package does not re-export)."""
    import pathlib

    root = pathlib.Path(REPO)
    ref = _exported(root / "tneq_tpu" / "parallel" / f"{module}.py")
    ours = _exported(root / "tneq_tpu_torch" / "parallel" / f"{module}.py")
    assert ref <= ours, sorted(ref - ours)
