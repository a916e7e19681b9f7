"""The frozen counts against the port's own FLOP functions today, and the
configurations' copies of them."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import counts, spec


def _config(name):
    return json.loads((spec.PKG / "configs" / f"{name}.json").read_text())


def test_brick_lane_step_flops_match_the_port():
    from tneq_tpu_torch.bench.flops import network_fidelity_step_flops
    from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph

    graph = parse_graph(incidence_to_graph(build_brick_wall_incidence(8, 5, 2)))
    assert network_fidelity_step_flops(graph, torch.complex64) == counts.BRICK_8X5_LANE_STEP_FLOPS
    assert _config("brick8x5_c64")["frozen_flops_per_lane_step"] == counts.BRICK_8X5_LANE_STEP_FLOPS


@pytest.mark.parametrize("B,D,K", [(512, 64, 16), (32, 8, 4), (7, 3, 5)])
def test_transfer_pass_flops_match_the_factorised_einsum(B, D, K):
    from tneq_tpu_torch.bench.flops import einsum_flops

    site = einsum_flops("zab,akc,zkl,bld->zcd", [(B, D, D), (D, K, D), (B, K, K), (D, K, D)],
                        path=[(0, 1), (0, 1), (0, 1)])
    assert counts.transfer_pass_flops(B, D, K, 5) == 5 * site
    assert counts.transfer_pass_flops(B, D, K, 5, complex_=True) == 4 * 5 * site


def test_born_step_flops():
    assert counts.born_step_flops(512, 64, 16, 8) == 144_955_146_240
    assert counts.born_step_flops(32, 3, 3, 8) == 233_280


def test_transfer_pass_bytes_follow_the_sweep_rule():
    # env0 [B, D, D], cores [n, D, K, D], operators [n, B, K, K], envs [n, B, D, D]
    assert counts.transfer_pass_bytes(512, 64, 16, 5) == 4 * (
        512 * 64 * 64 + 5 * (64 * 16 * 64 + 512 * 16 * 16 + 512 * 64 * 64))
