"""The distributed trainer: config, mesh and the data-parallel training loop.

Counterpart of ``tneq_tpu/parallel/trainer.py``: one config object for the
mesh axes, the optimizer, the loop and the checkpoints; a trainer that
builds the ``{"data", "model"}`` mesh and the train step, runs the loop
with rank-0 logging, and saves and resumes the whole state.

The contraction: ``model_axis == 1`` contracts through ``compile_siamese``
(chains take the transfer sweep, kernels B3/B4 in float32 and complex64)
in the data-parallel step of ``parallel/dp.py``; ``model_axis > 1``
through ``make_sliced_siamese_fn`` over ``model`` with the batch rows over
``data`` (``parallel/mp.py``).  JAX's trainer contracts with
``make_siamese_fn`` when unsliced; on chains the two are the same function
(ROADMAP C).

Checkpoints (``utils/checkpoint.CheckpointManager``): in the rank form
rank 0 writes, a barrier follows, and every rank reads.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..graph.dsl import CircuitGraph, parse_graph
from ..model.qctn import init_params, params_from_numpy
from ..optim.factory import make_optimizer
from ..train.trainer import Trainer, TrainingStats, basis_states
from ..utils.checkpoint import CheckpointManager
from ..utils.device import resolve_device
from .dp import make_dp_train_step, shard_batch
from .mesh import make_mesh, rank_form
from .multihost import initialize_multihost, is_main_process

__all__ = ["DistributedConfig", "DistributedTrainer", "main"]


@dataclass
class DistributedConfig:
    """Reference ``DistributedConfig`` fields mapped to mesh language
    (``distributed_trainer.py:35-172``)."""

    graph: str = ""  # DSL string (required)
    data_axis: int = 0  # 0 = use all remaining devices
    model_axis: int = 1  # bond-slice ways (1 = no model parallelism)
    method: str = "sgdg"
    learning_rate: float = 1e-2
    momentum: float = 0.9
    stiefel: bool = True
    max_steps: int = 1000
    batch_size: int = 32
    num_batches: int = 4
    K: Optional[int] = None
    dtype: str = "complex64"
    seed: int = 0
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    tol: float = 0.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DistributedConfig":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path: str) -> "DistributedConfig":
        text = Path(path).read_text()
        if path.endswith((".yml", ".yaml")):
            try:
                import yaml

                return cls.from_dict(yaml.safe_load(text))
            except ImportError as e:
                raise ImportError("pyyaml not available; use JSON config") from e
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def _default_devices() -> List[torch.device]:
    """Every visible card in one process; in the rank form this rank's
    current card at every position (each rank computes on its own).
    Raises without a card."""
    resolve_device("cuda")
    if rank_form():
        return [torch.device("cuda", torch.cuda.current_device())] * dist.get_world_size()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DistributedTrainer:
    def __init__(self, config: DistributedConfig, devices=None):
        self.config = config
        if not config.graph:
            raise ValueError("config.graph (DSL string) is required")
        self.graph: CircuitGraph = parse_graph(config.graph)
        self.dtype = torch.complex64 if config.dtype == "complex64" else torch.float32

        devices = list(devices) if devices is not None else _default_devices()
        model = max(1, config.model_axis)
        data = config.data_axis or max(1, len(devices) // model)
        self.mesh = make_mesh({"data": data, "model": model}, devices=devices[: data * model])
        self.device = self.mesh.device()

        ranks = set(self.graph.output_ranks)
        self.K = config.K or (next(iter(ranks)) if len(ranks) == 1 else None)
        if self.K is None:
            raise ValueError("mixed output ranks; set config.K")

        opt_kwargs: Dict[str, Any] = {"lr": config.learning_rate}
        if config.method in ("sgdg", "adamg"):
            opt_kwargs.update(momentum=config.momentum, stiefel=config.stiefel, seed=config.seed)
        self.optimizer = make_optimizer(config.method, **opt_kwargs)
        self.states = basis_states(self.graph, dtype=self.dtype, device=self.device)

        self.trainer = Trainer(self.graph, self.optimizer, K=self.K, dtype=self.dtype,
                               device=self.device, mesh=self.mesh if model > 1 else None)
        self.strategy = self.trainer.strategy
        # sliced: the contraction splits the batch over 'data' itself
        self._step = (self.trainer.train_step if model > 1
                      else make_dp_train_step(self.trainer, self.mesh))

        self.ckpt = CheckpointManager(config.checkpoint_dir) if config.checkpoint_dir else None

    def _train_step(self, params, opt_state, x):
        return self._step(params, opt_state, self.states, shard_batch(x, self.mesh))

    def _log(self, msg: str) -> None:
        if is_main_process():
            print(msg, flush=True)

    def _save(self, step: int, params, opt_state) -> None:
        if is_main_process():
            self.ckpt.save(step, params, opt_state)
        if rank_form():
            dist.barrier()

    def prepare_data(self) -> List[torch.Tensor]:
        """Deterministic Gaussian batches, identical on every process
        (the reference broadcasts rank-0 batches,
        ``distributed_trainer.py:347-398``; a shared seed does the same)."""
        rng = np.random.default_rng(self.config.seed)
        return [
            torch.as_tensor(rng.normal(size=(self.config.batch_size, self.graph.nqubits)),
                            dtype=torch.float32, device=self.device)
            for _ in range(self.config.num_batches)
        ]

    def train(
        self,
        params: Optional[Dict[str, torch.Tensor]] = None,
        data_list: Optional[Sequence[torch.Tensor]] = None,
    ):
        cfg = self.config
        if params is None:
            params = init_params(self.graph, cfg.seed, self.dtype, device=self.device)
        data_list = data_list if data_list is not None else self.prepare_data()
        opt_state = self.optimizer.init(params)

        start_step = 0
        if cfg.resume and self.ckpt and self.ckpt.latest_step() is not None:
            start_step, saved_params, saved_opt, _ = self.ckpt.load(opt_state_template=opt_state)
            params = params_from_numpy(saved_params, self.device, self.dtype)
            if saved_opt is not None:
                opt_state = saved_opt
            self._log(f"resumed from step {start_step}")

        stats = TrainingStats()
        prev = None
        t0 = time.time()
        for step_idx in range(start_step, cfg.max_steps):
            x = data_list[step_idx % len(data_list)]
            params, opt_state, loss = self._train_step(params, opt_state, x)
            loss_f = float(loss)
            stats.losses.append(loss_f)
            stats.steps = step_idx + 1
            if cfg.log_every and step_idx % cfg.log_every == 0:
                self._log(f"step {step_idx}: loss={loss_f:.6f}")
            if self.ckpt and cfg.checkpoint_every and step_idx \
                    and step_idx % cfg.checkpoint_every == 0:
                self._save(step_idx, params, opt_state)
            if cfg.tol and prev is not None and abs(loss_f - prev) < cfg.tol:
                stats.converged = True
                break
            prev = loss_f
        stats.wall_time = time.time() - t0
        if self.ckpt:
            self._save(stats.steps, params, opt_state)
        return params, stats


def main(argv: Optional[Sequence[str]] = None):
    """CLI mirroring the reference's ``distributed_trainer.py main()``.
    Under a launcher (``MASTER_ADDR``/``WORLD_SIZE``/``RANK``) each process
    is a rank of one process group on ``--backend``."""
    import argparse

    p = argparse.ArgumentParser(description="Distributed QCTN training")
    p.add_argument("--config", type=str, default=None, help="JSON/YAML config")
    p.add_argument("--graph-type", default="mps")
    p.add_argument("--num-qubits", type=int, default=6)
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--backend", default="nccl",
                   help="process-group backend under a launcher ('gloo' for several "
                        "ranks on one card or on the host)")
    args = p.parse_args(argv)

    if args.config:
        cfg = DistributedConfig.from_file(args.config)
    else:
        from ..graph.generators import example_graph

        cfg = DistributedConfig(
            graph=example_graph(args.num_qubits, args.graph_type, args.dim),
            model_axis=args.model_axis,
            max_steps=args.steps,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
        )
    started = initialize_multihost(backend=args.backend)
    try:
        n = dist.get_world_size() if rank_form() \
            else (cfg.data_axis or 1) * max(1, cfg.model_axis)
        trainer = DistributedTrainer(cfg, devices=[args.device] * n)
        _, stats = trainer.train()
        trainer._log(
            f"done: {stats.steps} steps, final loss "
            f"{stats.final_loss:.6f}, {stats.wall_time:.1f}s"
        )
    finally:
        if started:
            dist.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
