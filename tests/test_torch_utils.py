"""The port's utilities (``tneq_tpu_torch/utils``, ``backend.py``) against
the reference package's: configs, logging, callbacks, profiling, metrics,
dtype policy, plots and the backend shim, mirroring
``tests/test_utils_distributed.py::TestConfig``/``::TestLogging``,
``tests/test_aux.py::TestCallbacks``/``::TestProfiling``,
``tests/test_plots.py`` and ``tests/test_backend_shim.py``.  The marginal
grid is held against JAX's at the same numpy cores within rtol 1e-5
(float32 sums of a 4 x 2 wall in another order).
"""

import dataclasses
import glob
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tneq_tpu.utils import config as jconfig
from tneq_tpu.utils.plots import marginal_grid as j_marginal_grid
from tneq_tpu_torch.backend import (
    TorchBackend,
    create_backend,
    get_default_backend,
    set_default_backend,
)
from tneq_tpu_torch.graph import parse_graph, wall_graph
from tneq_tpu_torch.infer import sample
from tneq_tpu_torch.model.qctn import init_params, params_to_numpy
from tneq_tpu_torch.train.trainer import basis_states
from tneq_tpu_torch.utils import (
    AgentBehavior,
    CallbackList,
    ExperimentRecorder,
    StepTimer,
    annotate,
    setup_colored_logger,
    setup_logger,
    trace,
)
from tneq_tpu_torch.utils import config as tconfig
from tneq_tpu_torch.utils.config import load_func
from tneq_tpu_torch.utils.dtypes import BF16_COMPUTE, DEFAULT, Policy
from tneq_tpu_torch.utils.metrics import MetricsWriter
from tneq_tpu_torch.utils.plots import (
    marginal_grid,
    marginal_heatmap_png,
    sampling_scatter_png,
)

torch.set_num_threads(1)

EDGE = 12  # tiny grid: the reference uses 100, semantics are identical


class TestConfig:
    def test_defaults(self):
        a = AgentBehavior()
        assert a.n_iter == 10 and a.timeout == 1800.0

    def test_load_func(self):
        f = load_func("numpy.mean")
        assert f([1, 2, 3]) == 2.0

    @pytest.mark.parametrize("name", ["AgentBehavior", "GenerationProperty",
                                      "EvolutionProperty", "OverlordProperty", "Experiment"])
    def test_dataclasses_match_the_reference(self, name):
        ours, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        if hasattr(ref, "as_dict"):
            assert ours.as_dict() == ref.as_dict()
        assert tconfig.Configuration.default_dtype == jconfig.Configuration.default_dtype


class TestLogging:
    def test_colored_logger(self, capsys):
        log = setup_colored_logger("tneq_tpu_torch_testlog", rank=3)
        log.info("hello")
        err = capsys.readouterr().err
        assert "[Rank 3]" in err and "hello" in err

    def test_rank_defaults_to_zero_without_a_process_group(self, capsys):
        log = setup_colored_logger("tneq_tpu_torch_testlog_default")
        log.warning("hi")
        assert "[Rank 0]" in capsys.readouterr().err

    def test_plain_logger(self):
        log = setup_logger("tneq_tpu_torch_testlog_plain", level=logging.DEBUG)
        assert log.level == logging.DEBUG and log.handlers


class TestCallbacks:
    def test_fire_order_and_error_isolation(self):
        events = []
        cbs = CallbackList()
        cbs.on("step", lambda **k: events.append(("a", k["n"])))
        cbs.on("step", lambda **k: 1 / 0)
        cbs.on("step", lambda **k: events.append(("b", k["n"])))
        cbs.fire("step", n=1)
        assert events == [("a", 1), ("b", 1)]
        assert len(cbs.errors) == 1

    def test_recorder_json_and_pickle(self, tmp_path):
        rec = ExperimentRecorder(tmp_path)
        p1 = rec.record("exp", {"a": 1})
        assert p1.suffix == ".json" and rec.load(p1) == {"a": 1}
        p2 = rec.record("exp", {"s": {1, 2}})  # set: picklable, not JSON
        assert p2.suffix == ".pkl"
        assert rec.load(p2) == {"s": {1, 2}}


class TestProfiling:
    def test_step_timer(self):
        t = StepTimer()
        with t.span("forward"):
            pass
        with t.span("forward"):
            pass
        s = t.summary()
        assert s["forward"]["count"] == 2
        assert "forward" in str(t)

    def test_trace_writes_a_chrome_trace_with_the_span(self, tmp_path):
        x = torch.ones(8, 8)
        with trace(str(tmp_path)):
            with annotate("my_span"):
                (x @ x).sum()
        files = glob.glob(str(tmp_path / "*.json"))
        assert len(files) == 1
        names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
        assert "my_span" in names and "aten::mm" in names

    def test_train_single_node_profile(self, tmp_path, capsys):
        from tneq_tpu_torch.apps.train_single_node import main

        stats = main(["--device", "cpu", "--steps", "3", "--profile", str(tmp_path)])
        assert stats.steps == 3
        files = glob.glob(str(tmp_path / "*.json"))
        assert len(files) == 1
        events = json.load(open(files[0]))["traceEvents"]
        assert sum(e.get("name") == "train_step" for e in events) == 3
        # the transfer sweep's autograd function (its plain version runs here)
        assert any(e.get("name") == "_TransferSweep" for e in events)

    def test_train_single_node_profile_needs_the_card_by_default(self, tmp_path,
                                                                 monkeypatch):
        from tneq_tpu_torch.apps.train_single_node import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "3", "--profile", str(tmp_path)])
        assert not glob.glob(str(tmp_path / "*.json"))


class TestMetrics:
    def test_jsonl_writer(self, tmp_path):
        with MetricsWriter(tmp_path) as w:
            w.scalar("loss", 1.5, 0)
            w.scalars({"loss": 1.2, "fid": 0.3}, 1)
        lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
        assert len(lines) == 3
        rec = json.loads(lines[-1])
        assert rec["tag"] == "fid" and rec["step"] == 1


class TestDtypes:
    def test_policies(self):
        assert DEFAULT.is_complex and not BF16_COMPUTE.is_complex
        p = {"a": torch.ones(2, 2)}
        assert BF16_COMPUTE.cast_params(p)["a"].dtype == torch.bfloat16
        assert BF16_COMPUTE.cast_output(torch.ones(2, dtype=torch.bfloat16)).dtype == torch.float32
        assert Policy(param_dtype=torch.float64).is_complex is False


def _wall(nq=4, layers=2):
    return parse_graph(wall_graph(nq, layers=layers, dim=2))


class TestMarginalHeatmap:
    def test_grid_is_probability_surface(self):
        graph = _wall()
        params = init_params(graph, 0, torch.complex64, device="cpu")
        grid = marginal_grid(graph, params, edge_size=EDGE, device="cpu")
        assert grid.shape == (EDGE, EDGE) and grid.dtype == np.float64
        assert np.all(np.isfinite(grid))
        assert np.all(grid >= -1e-9)
        assert grid.max() > grid.min()  # not a constant field

    @pytest.mark.parametrize("qubits", [(0, 1), (2, 3)])
    def test_grid_matches_jax(self, qubits):
        """The 4 x 2 wall at the same numpy cores through both packages."""
        from tneq_tpu.graph import parse_graph as j_parse
        from tneq_tpu.graph import wall_graph as j_wall

        graph = _wall()
        params = init_params(graph, 0, torch.complex64, device="cpu")
        ref = j_marginal_grid(j_parse(j_wall(4, layers=2, dim=2)),
                              {k: jnp.asarray(v) for k, v in params_to_numpy(params).items()},
                              qubits=qubits, edge_size=EDGE)
        got = marginal_grid(graph, params, qubits=qubits, edge_size=EDGE, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7 * float(np.abs(ref).max()))

    def test_grid_runs_on_the_card_by_default(self, monkeypatch):
        graph = _wall()
        params = init_params(graph, 0, torch.complex64, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            marginal_grid(graph, params, edge_size=EDGE)

    def test_png_written(self, tmp_path):
        graph = _wall()
        params = init_params(graph, 0, torch.complex64, device="cpu")
        out = tmp_path / "heatmap.png"
        grid = marginal_heatmap_png(graph, params, str(out), edge_size=EDGE, device="cpu")
        assert out.exists() and out.stat().st_size > 1000
        assert grid.shape == (EDGE, EDGE)


class TestSamplingScatter:
    def test_png_written_from_sampler(self, tmp_path):
        graph = parse_graph("-2-A-2-\n-2-B-2-")
        params = init_params(graph, 0, torch.complex64, device="cpu")
        states = basis_states(graph, device="cpu")
        draws = sample(graph, params, states, 16, 2, torch.Generator().manual_seed(1),
                       grid_size=32)
        out = tmp_path / "scatter.png"
        sampling_scatter_png(draws, str(out))
        assert out.exists() and out.stat().st_size > 1000

    def test_shape_validation(self, tmp_path):
        with pytest.raises(ValueError):
            sampling_scatter_png(np.zeros((4,)), str(tmp_path / "x.png"))


class TestBackendShim:
    def test_factory_and_default(self):
        b = create_backend("pytorch", device="cpu", dtype=torch.float32)
        assert b.backend_info == {"type": "pytorch", "device": "cpu", "dtype": "float32"}
        assert create_backend("torch", device="cpu").dtype == torch.complex64
        set_default_backend(b)
        try:
            assert get_default_backend() is get_default_backend() is b
        finally:
            set_default_backend(None)

    def test_default_backend_needs_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_default_backend()

    @pytest.mark.parametrize("kind", ["jax", "tpu"])
    def test_jax_backend_request_errors(self, kind):
        with pytest.raises(ValueError):
            create_backend(kind, device="cpu")

    def test_ops_surface(self):
        b = TorchBackend(dtype=torch.float32, device="cpu")
        x = b.convert_to_tensor([[1.0, 2.0], [3.0, 4.0]])
        assert b.einsum("ij,jk->ik", x, b.eye(2)).shape == (2, 2)
        y = b.einsum("ij,jk,kl->il", x, x, b.eye(2))
        np.testing.assert_allclose(b.tensor_to_numpy(y), [[7.0, 10.0], [15.0, 22.0]])
        assert float(b.mean(x)) == 2.5
        assert not b.is_complex(x)
        assert b.abs_square(b.convert_to_tensor([3.0]))[0] == 9.0
        assert b.zeros((2, 3)).shape == (2, 3) and b.ones((1,)).dtype == torch.float32
        assert float(b.clamp(b.convert_to_tensor([5.0]), max=1.0)[0]) == 1.0
        assert b.reshape(x, [4]).shape == (4,)
        assert not b.detach(x).requires_grad

    def test_init_random_core_orthogonal(self):
        b = TorchBackend(dtype=torch.complex64, device="cpu")
        q = b.init_random_core([2, 2, 2, 2])
        m = q.numpy().reshape(4, 4)
        np.testing.assert_allclose(m.conj().T @ m, np.eye(4), atol=1e-5)
        b.set_random_seed(0)
        a1 = b.init_random_core([2, 2, 2, 2])
        b.set_random_seed(0)
        torch.testing.assert_close(b.init_random_core([2, 2, 2, 2]), a1, rtol=0, atol=0)

    def test_value_and_grad(self):
        b = TorchBackend(dtype=torch.float32, device="cpu")
        f = b.compute_value_and_grad(lambda x: torch.sum(x**2))
        v, g = f(torch.tensor([1.0, 2.0]))
        assert float(v) == 5.0
        np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
        assert b.jit_compile(f) is f
        assert b.execute_expression(lambda a, c: a + c, 1, 2) == 3

    def test_make_optimizer(self):
        b = TorchBackend(dtype=torch.float32, device="cpu")
        opt = b.make_optimizer("adam", lr=1e-2)
        state = opt.init({"a": torch.ones(2)})
        assert state is not None
