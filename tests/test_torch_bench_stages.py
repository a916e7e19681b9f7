"""The port's benchmark stages (``tneq_tpu_torch/bench``) at small sizes on
the host, held against the reference package's stages: every record has
the reference record's keys (the port's own additions, listed per stage
below, on top), the flop counters give the same integers, the FSDP
memory curve the same bytes, and the dtype-policy losses agree (float32
within rtol 1e-5; bfloat16 within rtol 2e-2, the rounding of a bf16
contraction of a few dozen steps).  Timings on the host say nothing about
the card and are only checked to be positive.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tneq_tpu.bench import flops as jflops
from tneq_tpu.bench import microbench as jmb
from tneq_tpu.graph import build_brick_wall_incidence as j_brick
from tneq_tpu.graph import incidence_to_graph as j_inc
from tneq_tpu.graph import mps_graph as j_mps
from tneq_tpu.graph import parse_graph as j_parse
from tneq_tpu_torch.bench import ALL_STAGES
from tneq_tpu_torch.bench import flops as tflops
from tneq_tpu_torch.bench import microbench as tmb
from tneq_tpu_torch.bench.run_all import _run_stage, main as run_all_main
from tneq_tpu_torch.graph import build_brick_wall_incidence as t_brick
from tneq_tpu_torch.graph import incidence_to_graph as t_inc
from tneq_tpu_torch.graph import mps_graph as t_mps
from tneq_tpu_torch.graph import parse_graph as t_parse

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (stage, small keyword arguments shared by both packages, the port's added
# record keys, the port's added keys of each entry of its list or dict of
# results, the reference keys the port renames {reference: port})
STAGE_CASES = [
    ("env_audit", {}, {"nvidia_smi"}, None,
     {"jax_version": "torch_version", "jaxlib_version": "cuda_version"}),
    ("matmul_peak", dict(sizes=(64,), dtypes=("float32", "bfloat16", "complex64")),
     {"precision", "platform"}, {"peak_share"}, {}),
    ("memory_bandwidth", dict(sizes_mb=(2,)), {"platform"}, {"hbm_share"}, {}),
    ("transpose_cost", dict(n=128), set(), None, {}),
    ("checkpoint_io", dict(size_mb=1), set(), None, {}),
    ("dtype_policy", dict(n_qubits=4, n_cells=2, batch=8), {"precision"}, {"loss"}, {}),
    ("tn_workload", dict(n_qubits=4, n_cells=2, batch=8), set(), None, {}),
    ("large_network", dict(n_qubits=4, n_cells=2), set(), None, {}),
    ("bond_sweep", dict(n_qubits=4, bond_dims=(2, 4), bench_steps=2), set(),
     {"route", "launches_per_step"}, {}),
    ("util_peak", dict(dims=(4,), n_qubits=4, flop_budget=1e5), set(), set(), {}),
    ("fsdp_memory", dict(n_qubits=4, bond_dim=4, model_sizes=(1, 2)), {"positions_share"},
     {"launches"}, {}),
]


def _entries(rec):
    """The entries of a record's results (list or dict of dicts)."""
    for key in ("results", "sweep", "curve"):
        if key in rec:
            res = rec[key]
            vals = res.values() if isinstance(res, dict) else res
            return [v for v in vals if isinstance(v, dict)]
    return None


def _port_record(name, kw, tmp_path):
    kw = dict(kw, tmpdir=str(tmp_path)) if name == "checkpoint_io" else kw
    return getattr(tmb, f"stage_{name}")(device="cpu", **kw)


@pytest.mark.parametrize("name,kw,added,added_entry,renamed", STAGE_CASES,
                         ids=[c[0] for c in STAGE_CASES])
def test_stage_records_have_the_reference_keys(name, kw, added, added_entry, renamed,
                                               tmp_path):
    ref_kw = dict(kw, tmpdir=str(tmp_path / "ref")) if name == "checkpoint_io" else kw
    ref = getattr(jmb, f"stage_{name}")(**ref_kw)
    ours = _port_record(name, kw, tmp_path / "port")
    want = {renamed.get(k, k) for k in ref} | added
    assert set(ours) == want, sorted(set(ours) ^ want)
    assert ours["stage"] == ref["stage"]
    ref_e, our_e = _entries(ref), _entries(ours)
    assert (ref_e is None) == (our_e is None)
    if ref_e is not None:
        assert len(our_e) == len(ref_e) > 0
        for r, o in zip(ref_e, our_e):
            if isinstance(r, dict) and all(isinstance(v, dict) for v in r.values()):
                continue  # dtype_policy's per-dtype dicts are checked below
            assert set(o) == set(r) | added_entry, sorted(set(o) ^ (set(r) | added_entry))
    if name == "dtype_policy":
        for dt in ("float32", "bfloat16"):
            assert set(ours["results"][dt]) == set(ref["results"][dt]) | added_entry


def test_env_audit_names_the_host():
    rec = tmb.stage_env_audit(device="cpu")
    assert rec["platform"] == "cpu" and rec["n_devices"] == 1
    assert rec["nvidia_smi"] is None and rec["native_pathfinder"] is True


def test_stages_measure_something(tmp_path):
    assert tmb.stage_matmul_peak(sizes=(128,), dtypes=("float32",),
                                 device="cpu")["results"][0]["gflops"] > 0
    bw = tmb.stage_memory_bandwidth(sizes_mb=(2, 64), device="cpu")["results"]
    # 2 MB read plus written fits the H100's L2: no HBM share; 64 MB does not
    assert bw[0]["hbm_share"] is None and bw[1]["hbm_share"] > 0
    assert tmb.stage_transpose_cost(n=128, device="cpu")["transpose_ms"] > 0
    io = tmb.stage_checkpoint_io(tmpdir=str(tmp_path), size_mb=1, device="cpu")
    assert io["dtype"] == "complex64" and io["save_mbps"] > 0 and io["load_mbps"] > 0
    assert tmb.stage_tn_workload(n_qubits=4, n_cells=2, batch=8,
                                 device="cpu")["grad_steps_per_sec"] > 0


def test_stages_take_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmb.stage_transpose_cost(n=8)


def _jax_dtype_policy_losses(graph_t, n_qubits, batch):
    """The reference stage's loss in float32 and bfloat16, at the port's
    stage cores (``init_params(graph, 0, float32)``) carried over in numpy."""
    from tneq_tpu.ops.contract import make_siamese_fn
    from tneq_tpu.ops.features import measurement_matrices
    from tneq_tpu.train.losses import nll_loss
    from tneq_tpu.train.trainer import basis_states
    from tneq_tpu_torch.model.qctn import init_params, params_to_numpy

    graph = j_parse(j_inc(j_brick(n_qubits, 2, 2)))
    params32 = {k: jnp.asarray(v) for k, v in
                params_to_numpy(init_params(graph_t, 0, torch.float32, device="cpu")).items()}
    states = basis_states(graph, dtype=jnp.float32)
    fn = make_siamese_fn(graph)
    x = jnp.zeros((batch, n_qubits), jnp.float32)
    out = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        params = {k: v.astype(dtype) for k, v in params32.items()}
        st = [jnp.asarray(s).astype(dtype) for s in states]
        mx = measurement_matrices(x, 2).astype(dtype)
        raw = fn(params, st, [mx[:, q] for q in range(graph.nqubits)])
        out[name] = float(nll_loss(raw.astype(jnp.float32)))
    return out


def test_dtype_policy_losses_match_jax():
    nq, batch = 4, 8
    rec = tmb.stage_dtype_policy(n_qubits=nq, n_cells=2, batch=batch, device="cpu")
    ref = _jax_dtype_policy_losses(t_parse(t_inc(t_brick(nq, 2, 2))), nq, batch)
    got = {k: rec["results"][k]["loss"] for k in ("float32", "bfloat16")}
    np.testing.assert_allclose(got["float32"], ref["float32"], rtol=1e-5)
    np.testing.assert_allclose(got["bfloat16"], ref["bfloat16"], rtol=2e-2)
    assert rec["results"]["bf16_speedup"] > 0


def _graphs():
    return {
        "brick": (j_parse(j_inc(j_brick(6, 3, 2))), t_parse(t_inc(t_brick(6, 3, 2)))),
        "mps": (j_parse(j_mps(8, dim=4, phys=2)), t_parse(t_mps(8, dim=4, phys=2))),
    }


@pytest.mark.parametrize("kind", ["brick", "mps"])
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_flop_counts_equal_jax(kind, dtype):
    jg, tg = _graphs()[kind]
    assert tflops.overlap_flops(tg, dtype) == jflops.overlap_flops(jg, dtype)
    for grad in (True, False):
        assert (tflops.network_fidelity_step_flops(tg, dtype, gradient=grad)
                == jflops.network_fidelity_step_flops(jg, dtype, gradient=grad))
        assert (tflops.siamese_flops(tg, 16, dtype, gradient=grad)
                == jflops.siamese_flops(jg, 16, dtype, gradient=grad))
    eq, shapes = "ab,bc,cd->ad", ((3, 4), (4, 5), (5, 6))
    assert tflops.einsum_flops(eq, shapes, dtype=dtype) == jflops.einsum_flops(
        eq, shapes, dtype=dtype)
    # torch dtypes name the same counts
    assert tflops.overlap_flops(tg, getattr(torch, dtype)) == tflops.overlap_flops(tg, dtype)


def test_peaks_are_the_h100s(monkeypatch):
    assert tflops.mxu_utilization(67.0, "float32") == 1.0
    assert tflops.mxu_utilization(67.0, torch.complex64, "highest") == 1.0
    assert tflops.mxu_utilization(495.0, "float32", "high") == 1.0
    assert tflops.mxu_utilization(989.0, torch.bfloat16, "high") == 1.0
    assert tflops.PEAK_HBM_TBPS == 3.35
    # the card's bf16 ceiling, measured on an H100, not a TPU number
    assert 0.5 * 989.0 < tflops.MEASURED_MATMUL_TFLOPS <= 989.0
    monkeypatch.setattr(tflops, "MEASURED_MATMUL_TFLOPS", 500.0)
    assert tflops.practical_utilization(250.0) == 0.5


def test_bond_sweep_routes_by_the_sweep_kernels_cap():
    """S = D² up to 1024 takes B1/B2 (their plain versions here: no launch
    is counted off the card); D = 64 takes the per-site scan."""
    rec = tmb.stage_bond_sweep(n_qubits=4, bond_dims=(2, 32, 33), bench_steps=1, device="cpu")
    assert [r["route"] for r in rec["sweep"]] == ["chain_sweep", "chain_sweep", "chain_scan"]
    for r in rec["sweep"]:
        assert r["launches_per_step"] == {"chain_sweep_fwd": 0.0, "chain_sweep_bwd": 0.0}
        assert np.isfinite(r["final_loss"])


def test_fsdp_memory_bytes_per_position_equal_jax():
    kw = dict(n_qubits=4, bond_dim=4, model_sizes=(1, 2, 4))
    ref = jmb.stage_fsdp_memory(**kw)
    ours = tmb.stage_fsdp_memory(device="cpu", **kw)
    assert ([c["model_state_bytes_per_device"] for c in ours["curve"]]
            == [c["model_state_bytes_per_device"] for c in ref["curve"]])
    assert ours["replicated_param_bytes"] == ref["replicated_param_bytes"]
    assert ours["scaling"] == ref["scaling"]


def test_collectives_skip_in_one_process():
    ref_skip = {"stage", "skipped"}
    rec = tmb.stage_collectives(size_mb=1, device="cpu")
    assert set(rec) == ref_skip


_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[1],
                        world_size=2, rank=int(sys.argv[2]))
from tneq_tpu_torch.bench import stage_collectives
rec = stage_collectives(size_mb=1, device="cpu")
dist.destroy_process_group()
print(json.dumps(rec))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_collectives_on_two_gloo_ranks():
    """Under a process group the stage times the port's collectives under
    the reference's names, with the reference record's keys."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, port, str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = jmb.stage_collectives(size_mb=1)
    for rec in outs:
        assert set(rec) == set(ref) | {"backend"}
        assert rec["n_devices"] == 2 and rec["backend"] == "gloo"
        assert set(rec["results"]) == set(ref["results"])
        for name, r in rec["results"].items():
            assert set(r) == set(ref["results"][name]) | {"collective", "route"}
            assert r["ms"] > 0
        # gloo with host tensors takes every native primitive
        assert {k: r["route"] for k, r in rec["results"].items()} == {
            "psum": "all_reduce", "all_gather": "all_gather", "ppermute": "send_recv"}


def test_stage_names_are_the_references_but_the_flagship():
    assert list(ALL_STAGES) == [k for k in jmb.ALL_STAGES if k != "9_flagship_32q"]


def test_run_all_cli(tmp_path, capsys):
    rc = run_all_main(["--stages", "1,3", "--out", str(tmp_path), "--timeout", "60",
                       "--device", "cpu"])
    assert rc == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [s["stage"] for s in summary] == ["1_env_audit", "3_memory_bandwidth",
                                             "3b_transpose_cost"]
    assert all(s["ok"] for s in summary)
    rec = json.loads((tmp_path / "1_env_audit.json").read_text())
    assert rec["platform"] == "cpu" and rec["stage"] == "1_env_audit"
    # a subset run merges into the summary
    assert run_all_main(["--stages", "6", "--out", str(tmp_path), "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [s["stage"] for s in summary] == ["1_env_audit", "3_memory_bandwidth",
                                             "3b_transpose_cost", "6_checkpoint_io",
                                             "6b_tn_workload"]


def test_run_all_isolated(tmp_path):
    rc = run_all_main(["--stages", "3b", "--out", str(tmp_path), "--timeout", "120",
                       "--device", "cpu", "--isolate"])
    assert rc == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary == [{"stage": "3b_transpose_cost", "ok": True}]


def test_run_stage_respects_explicit_verdict():
    rec = _run_stage("x", lambda: {"stage": "x", "ok": False, "rc": 4}, 30)
    assert rec["ok"] is False and rec["rc"] == 4
    rec = _run_stage("y", lambda: {"stage": "y"}, 30)
    assert rec["ok"] is True
    rec = _run_stage("z", lambda: 1 / 0, 30)
    assert rec["ok"] is False and rec["error"].startswith("ZeroDivisionError")


def test_util_peak_cli_prints_one_line(capsys):
    from tneq_tpu_torch.bench.util_peak import main

    assert main(["--device", "cpu", "--dims", "2,4", "--n-qubits", "4",
                 "--flop-budget", "1e4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["device"] == "cpu" and [r["bond_dim"] for r in rec["sweep"]] == [2, 4]
    assert rec["peak_bond_dim"] in (2, 4) and not any("error" in r for r in rec["sweep"])

