"""The Born-rule trainer: ``Trainer.train_step`` in ``Trainer.fit``'s order.

Set-up builds one ``Trainer`` (``TrainingConfig`` from the configuration:
SGD-G, its lr, momentum and seed) on ``mps_graph(n, D, phys=K)``, makes the
cores (Haar-orthogonal or Haar-unitary, on the card, from the seed) and the
traffic's batches, and drives that trainer's first three steps on batches
0, 1, 2 (rows that all differ), each loss read to the host as ``fit``
reads it.  The window carries on from that same object: one step per unit,
batches in turn, the loss read after each.

``check`` holds against the plain reference in float64 (complex128):

- the first three steps, replayed from the same cores and batches: each
  step's loss, the optimizer's state after step 1, the cores' change after
  step 3;
- the window's first step whose retraction draw (fixed by the optimizer's
  seed) retracts, taken from the program's own state before it (its cores
  and optimizer buffers, kept as the window passes): its loss and the
  cores' change.  A replay from the start to that step would compare
  chaos, not the program: on a bond-3 chain a loss gap of 2e-8 at step 0
  grows to 12–30 % by step 84, as rows cross the probability's floor.  A
  window that stops short of that step is carried on to it once it has
  closed.
"""

from __future__ import annotations

import math

import torch

from .. import traffic as traffic_gen
from ..compare import worst_leaf_gap
from ..reference import born as ref
from ..reference.sgdg import first_retraction_step
from ..weights import haar_cores, weights_generator

FIRST_STEPS = 3  # driven in set-up
MODES = ("sound", "control", "half_batch")


def _norms(tensors: dict, names) -> list:
    return [float(torch.linalg.vector_norm(tensors[n].to(torch.complex128))) for n in names]


class Driver:
    """``mode`` (for ``calibrate.py``): ``sound``, the program; ``control``,
    the reference in its place in complex64 / float32 at TF32; ``half_batch``,
    the reference in its place with each loss over half of its batch."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 mode: str = "sound"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.mode = mode
        self.attempted = 0
        self.failed = 0

    def setup(self) -> None:
        from tneq_tpu_torch.graph import mps_graph, parse_graph
        from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig

        cfg, dev = self.cfg, self.device
        n, D, K = cfg["n_qubits"], cfg["bond_dim"], cfg["K"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.graph = parse_graph(mps_graph(n, D, phys=K))
        self.names = [c.name for c in self.graph.cores]
        if self.names != ref.core_names(n):
            raise RuntimeError(f"the program's cores {self.names} are not the reference's")
        tcfg = TrainingConfig(method=cfg["method"], learning_rate=cfg["learning_rate"],
                              momentum=cfg["momentum"], stiefel=cfg["stiefel"],
                              seed=cfg["optimizer_seed"], log_every=0)
        if torch.get_float32_matmul_precision() != self.cfg["matmul_precision"]:
            raise RuntimeError("float32 matmuls must run at the configuration's precision")
        self.trainer = Trainer(self.graph, config=tcfg, K=K, dtype=self.dtype, device=dev)
        shapes = {c.name: tuple(c.shape) for c in self.graph.cores}
        self.retract = first_retraction_step(shapes, cfg["optimizer_seed"])
        if self.retract < FIRST_STEPS:
            raise RuntimeError("the first retraction falls inside set-up's steps")
        self.params0 = haar_cores(shapes, self.dtype, weights_generator(self.seed, dev), dev)
        self.batches = traffic_gen.batches(self.traffic, self.seed, n, dev)
        state = torch.zeros(K, dtype=self.dtype, device=dev)
        state[-1] = 1.0
        self.states = [state] * n
        self.params = dict(self.params0)
        self.opt = self.trainer.optimizer.init(self.params)
        self.losses = []
        self.kept = {}  # step count -> (cores, optimizer buffers) after it
        for s in range(FIRST_STEPS):
            self._step()
            if s == 0:
                self.state1 = {k: v.clone() for k, v in self.opt.momentum.items()}
        self.check_units = self.retract + 1 - FIRST_STEPS

    def _step(self) -> float:
        from tneq_tpu_torch.utils.profiling import annotate

        x = self.batches[len(self.losses) % len(self.batches)]
        with annotate("train_step"):
            self.params, self.opt, loss = self.trainer.train_step(
                self.params, self.opt, self.states, x)
        value = float(loss)
        self.losses.append(value)
        if len(self.losses) in (FIRST_STEPS, self.retract, self.retract + 1):
            self.kept[len(self.losses)] = ({k: v.clone() for k, v in self.params.items()},
                                           {k: v.clone() for k, v in self.opt.momentum.items()})
        return value

    def unit(self) -> int:
        value = self._step()
        self.attempted += 1
        if not math.isfinite(value):
            self.failed += 1
        return int(self.traffic["batch_size"])

    def end_to_end(self, t0: float, ends) -> dict:
        return {"train_samples_per_s": self.traffic["batch_size"] * len(ends) / (ends[-1] - t0)}

    def counters(self) -> dict:
        cfg = self.cfg
        return {"steps": self.attempted, "strategy": self.trainer.strategy,
                "flops_per_step": cfg["frozen_flops_per_step"],
                "sweep": {"B": self.traffic["batch_size"], "D": cfg["bond_dim"], "K": cfg["K"],
                          "n": cfg["n_qubits"] - 3, "complex": self.dtype.is_complex,
                          "passes_per_step": 2}}

    def release(self) -> None:
        while len(self.losses) <= self.retract:  # a window that stopped short
            self._step()
        del self.trainer, self.params, self.opt
        if self.mode != "sound":
            self._reference_in_place()

    def _reference(self, dtype, **kw):
        """The reference's readings in ``dtype``: ``(cores, first steps,
        retraction step)``."""
        cfg = self.cfg
        real = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
        cores = {k: v.to(dtype) for k, v in self.params0.items()}
        first = ref.train(cores, [x.to(real) for x in self.batches[:FIRST_STEPS]], cfg["K"],
                          FIRST_STEPS, cfg["learning_rate"], cfg["momentum"],
                          cfg["optimizer_seed"], **kw)
        params, buf = self.kept[self.retract]
        x = self.batches[self.retract % len(self.batches)].to(real)
        retract = ref.step_from({k: v.to(dtype) for k, v in params.items()},
                                {k: v.to(dtype) for k, v in buf.items()}, self.retract, x,
                                cfg["K"], cfg["learning_rate"], cfg["momentum"],
                                cfg["optimizer_seed"], **kw)
        return cores, first, retract

    def _reference_in_place(self) -> None:
        """The program's readings replaced by the reference's: the control
        (TF32 in the configuration's precision) or the half-batch fault."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "control"
        try:
            if self.mode == "control":
                _, first, retract = self._reference(self.dtype, tf32=True)
            else:
                f64 = torch.complex128 if self.dtype.is_complex else torch.float64
                _, first, retract = self._reference(f64, half_batch=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        losses, self.state1, _, params3 = first
        self.losses[:FIRST_STEPS] = losses
        self.losses[self.retract] = retract[0]
        self.kept[FIRST_STEPS] = (params3, None)
        self.kept[self.retract + 1] = (retract[2], None)

    def check(self) -> list:
        f64 = torch.complex128 if self.dtype.is_complex else torch.float64
        names = self.names
        cores, (losses, state1, grad1, params3), (r_loss, r_grad, r_params) = self._reference(f64)
        steps = list(range(FIRST_STEPS)) + [self.retract]
        ref_losses = losses + [r_loss]
        loss_gap = max(abs(self.losses[s] - r) / abs(r) for s, r in zip(steps, ref_losses))

        def change(before, prog_after, ref_after, grad):
            prog = {n: prog_after[n].to(f64) - before[n].to(f64) for n in names}
            refc = {n: ref_after[n] - before[n].to(f64) for n in names}
            return worst_leaf_gap(_norms(prog, names), _norms(refc, names),
                                  [grad[n] for n in names])

        state_gap = worst_leaf_gap(_norms(self.state1, names), _norms(state1, names),
                                   [grad1[n] for n in names])
        lim = self.cfg["limits"]
        return [("first_loss_gap", abs(self.losses[0] - losses[0]) / abs(losses[0]),
                 lim["first_loss_gap"]),
                ("loss_gap", loss_gap, lim["loss_gap"]),
                ("first_state_gap", state_gap, lim["first_state_gap"]),
                ("change_gap", change(self.params0, self.kept[FIRST_STEPS][0], params3, grad1),
                 lim["change_gap"]),
                ("retraction_change_gap",
                 change(self.kept[self.retract][0], self.kept[self.retract + 1][0], r_params,
                        r_grad), lim["retraction_change_gap"])]
