"""The batched prune's first accept round: ``prune_fit.batched`` pieces.

Set-up builds the experiment (``make_experiment``: the brick wall, the
configuration's optimizer and precision, ``prune_steps`` = the traffic's
``chunk_steps``, ``lane_chunk`` at ``SymmetryBreakingConfig``'s default, so
a change of that default is measured), makes the target network from the
seed (Haar-random gates, the planted ones replaced by identities) and the
warm start (the planted network itself), and splits the round's
candidates into pieces of ``lane_chunk`` lanes, the last padded by
repeating its last mask as ``symmetry_breaking_batched`` pads.  One warm
piece builds every plan and kernel.  The window runs the pieces in turn,
each ``exp.prune_fit.batched(warm, masks, target, target_mask,
chunk_steps=k)`` from the warm start with its lanes' 1 − F read to the
host, as the app reads them.  ``check`` holds every piece the window ran
against the plain reference in complex128.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import traffic as traffic_gen
from ..compare import worst_leaf_gap
from ..reference import brick as ref


MODES = ("sound", "control")


class Driver:
    """``mode`` (for ``calibrate.py``): ``sound``, the program as the
    configuration states it; ``control``, the program with its own TF32
    path on (the fit's matmul precision 'high')."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 mode: str = "sound"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.precision = "high" if mode == "control" else config["matmul_precision"]
        self.attempted = 0
        self.failed = 0
        self.outputs = []  # (piece index, lane params, lane 1 - F)

    def setup(self) -> None:
        from tneq_tpu_torch.apps.symmetry_breaking import SymmetryBreakingConfig, make_experiment

        cfg, dev = self.cfg, self.device
        self.k = int(self.traffic["chunk_steps"])
        sb = SymmetryBreakingConfig(
            n_qubits=cfg["n_qubits"], n_cells=cfg["n_cells"], rank=cfg["rank"],
            topology=cfg["topology"], fidelity_mode=self.traffic["fidelity_mode"],
            dtype=getattr(torch, cfg["dtype"]), optimizer=cfg["optimizer"],
            matmul_precision=self.precision, prune_lr=cfg["prune_lr"],
            momentum=cfg["momentum"], tol=cfg["tol"], prune_steps=self.k,
            device=str(dev))
        self.exp = make_experiment(sb)
        self.names = [c.name for c in self.exp.graph.cores]
        if self.names != ref.gate_names(cfg["n_qubits"], cfg["n_cells"]):
            raise RuntimeError(f"the program's gates {self.names} are not the reference's")
        shapes = {c.name: tuple(c.shape) for c in self.exp.graph.cores}
        self.dtype = sb.dtype
        planted, cores = traffic_gen.prune_round(self.traffic, self.seed, shapes, self.dtype, dev)
        eye = torch.eye(4, dtype=self.dtype, device=dev).reshape(2, 2, 2, 2)
        self.target = cores
        self.target_mask = torch.ones(len(self.names), dtype=torch.float32, device=dev)
        self.target_mask[planted] = 0.0
        self.warm = {n: eye.clone() if i in planted else cores[n]
                     for i, n in enumerate(self.names)}
        self.planted = planted
        cands = [c for c in self.exp.candidate_indices() if not self.exp.row_would_empty([c])]
        self.lane_chunk = int(sb.lane_chunk)
        self.pieces = []  # (masks [lane_chunk, n], candidates of its real lanes)
        for lo in range(0, len(cands), self.lane_chunk):
            part = cands[lo: lo + self.lane_chunk]
            lanes = part + [part[-1]] * (self.lane_chunk - len(part))
            masks = torch.ones(self.lane_chunk, len(self.names), dtype=torch.float32, device=dev)
            masks[torch.arange(self.lane_chunk), torch.as_tensor(lanes)] = 0.0
            self.pieces.append((masks, part))
        self._run(0)  # warm: every plan, path and kernel the window uses
        self.next = 0
        self.check_units = len(self.pieces)

    def _run(self, i: int):
        masks, part = self.pieces[i]
        res = self.exp.prune_fit.batched(self.warm, masks, self.target, self.target_mask,
                                         chunk_steps=self.k)
        infid = res.infidelity.detach().cpu()
        return res, infid, part

    def unit(self) -> int:
        i = self.next % len(self.pieces)
        self.next += 1
        res, infid, part = self._run(i)
        take = len(part)
        self.outputs.append((i, {n: v[:take].detach() for n, v in res.params.items()},
                             infid[:take]))
        self.attempted += 1
        if not bool(torch.isfinite(infid[:take]).all()):
            self.failed += 1
        return take * int(res.steps)

    def end_to_end(self, t0: float, ends) -> dict:
        done = sum(len(self.pieces[i][1]) for i, _, _ in self.outputs) * self.k
        return {"fit_lane_steps_per_s": done / (ends[-1] - t0)}

    def counters(self) -> dict:
        useful = sum(len(p) for _, p in self.pieces)
        return {"pieces": self.attempted, "steps_per_piece": self.k,
                "useful_lanes_per_round": useful,
                "lanes_per_round": self.lane_chunk * len(self.pieces),
                "useful_lane_steps": sum(len(self.pieces[i][1]) for i, _, _ in self.outputs) * self.k,
                "flops_per_lane_step": self.cfg["frozen_flops_per_lane_step"]}

    def release(self) -> None:
        del self.exp

    def check(self) -> list:
        cfg = self.cfg
        c128 = torch.complex128
        names = self.names
        lanes = [c for _, part in self.pieces for c in part]
        masks = torch.ones(len(lanes), len(names), dtype=torch.float64, device=self.device)
        masks[torch.arange(len(lanes)), torch.as_tensor(lanes)] = 0.0
        warm = {n: v.to(c128).expand(len(lanes), *v.shape) for n, v in self.warm.items()}
        gates = torch.stack([self.target[n].to(c128) for n in names])[None]
        tmask = self.target_mask.double()[None]
        pairs = ref.gate_pairs(cfg["n_qubits"], cfg["n_cells"])
        target = ref.operator(ref.masked(gates, tmask), pairs, cfg["n_qubits"])[0]
        params, nlfs, grad1 = ref.fit(warm, masks, target, cfg["n_qubits"], cfg["n_cells"],
                                      self.k, cfg["prune_lr"], cfg["momentum"],
                                      cfg["optimizer_seed"])
        ref_infid = (-torch.expm1(-nlfs[-1])).cpu().numpy()
        offset = np.cumsum([0] + [len(p) for _, p in self.pieces])
        infid_gap, prog_n, ref_n, grads = 0.0, [], [], []
        for i, lane_params, infid in self.outputs:
            lo = int(offset[i])
            for j in range(len(self.pieces[i][1])):
                infid_gap = max(infid_gap, abs(float(infid[j]) - float(ref_infid[lo + j])))
                for n in names:
                    w = self.warm[n].to(c128)
                    prog_n.append(float(torch.linalg.vector_norm(lane_params[n][j].to(c128) - w)))
                    ref_n.append(float(torch.linalg.vector_norm(params[n][lo + j] - w)))
                    grads.append(float(grad1[n][lo + j]))
        if not self.outputs:
            infid_gap = math.inf
        change_gap = worst_leaf_gap(prog_n, ref_n, grads)
        lim = cfg["limits"]
        return [("infidelity_gap", infid_gap, lim["infidelity_gap"]),
                ("change_gap", change_gap, lim["change_gap"])]
