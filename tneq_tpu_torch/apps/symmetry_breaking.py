"""Symmetry-breaking experiment on an MPS chain, network-fidelity mode.

Counterpart of ``tneq_tpu/apps/symmetry_breaking.py`` for
``topology='mps'``, ``fidelity_mode='network'``:

1. build the MPS chain (physical rank ``rank``, bond ``bond_dim``);
2. draw a random target network with a planted set of interior cores
   masked out (transparent cores: bond passes through, physical legs
   identity);
3. validate the target by refitting a fresh full network to 1-F < tol;
4. greedily try to prune one more core: mask it, refit (warm-started from
   the validated fit), keep it pruned if the fidelity recovers.

Pruning is a mask input to one fit, so every candidate reuses the same
code path; on the card every chain overlap of every fit runs through the
sweep kernels (``ops/chain_overlap.py``).  The brick-wall topology, the
dense-target mode, the CLI (brick-only in JAX) and the vmapped
``symmetry_breaking_batched`` wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, parse_graph
from ..graph.generators import mps_graph
from ..model.qctn import GeneratorLike, init_params
from ..optim.factory import make_optimizer
from ..optim.stiefel import sgdg
from ..train.fit import transparent_cores
from ..train.network_fit import make_masked_network_fidelity_fit
from ..utils.device import resolve_device

__all__ = [
    "SymmetryBreakingConfig",
    "Experiment",
    "make_experiment",
    "target_tensor_init",
    "validate_target_tensor",
    "symmetry_breaking",
    "main",
]

_BRICK = (
    "the brick-wall topology and the dense-target mode wait for the "
    "brick-wall slice (ROADMAP queue A, item 7)"
)


@dataclass
class SymmetryBreakingConfig:
    """Fields as in the JAX config; ``dtype`` is a torch dtype and
    ``device`` selects the card (default) or the host (``'cpu'``)."""

    n_qubits: int = 8
    rank: int = 2
    topology: str = "brick"
    bond_dim: int = 64
    # 'sgdg' (Stiefel SGD-G) or any optim.factory method; MPS fits need an
    # unconstrained optimizer (the Stiefel flow stalls on chain cores,
    # STIEFEL_STALL_r05.json)
    optimizer: str = "sgdg"
    matmul_precision: str = "highest"
    fidelity_mode: str = "dense"
    dtype: torch.dtype = torch.complex64
    complex_as_real: bool = False
    validate_lr: float = 1.0
    validate_steps: int = 4000
    fit_jit_scope: str = "fit"
    fit_sync_every: int = 1
    mesh: object = None
    prune_lr: float = 1e-2
    prune_steps: int = 5000
    momentum: float = 0.9
    tol: float = 1e-3
    max_outer_iterations: int = 500
    device: str = "cuda"


class Experiment:
    """One MPS topology with its two fits (validate, prune)."""

    def __init__(self, cfg: SymmetryBreakingConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if cfg.topology == "mps":
            if cfg.fidelity_mode != "network":
                raise ValueError(
                    "topology='mps' requires fidelity_mode='network' (a "
                    "dense 4^n target defeats the point of the chain)"
                )
            if cfg.complex_as_real:
                raise ValueError("topology='mps' has no pair-form identities")
        elif cfg.topology == "brick":
            raise NotImplementedError(_BRICK)
        else:
            raise ValueError(f"unknown topology {cfg.topology!r}")
        self.graph: CircuitGraph = parse_graph(
            mps_graph(cfg.n_qubits, cfg.bond_dim, phys=cfg.rank)
        )
        # pairing='kind': bond->bond x phys->phys at every bond_dim
        identities, unmask = transparent_cores(self.graph, cfg.dtype, pairing="kind")
        self.unmaskable: frozenset = frozenset(unmask)
        make_fit = partial(
            make_masked_network_fidelity_fit,
            jit_scope=cfg.fit_jit_scope,
            sync_every=cfg.fit_sync_every,
            mesh=cfg.mesh,
            identities=identities,
            matmul_precision=cfg.matmul_precision,
            device=self.device,
        )
        if cfg.optimizer != "sgdg":
            def make_opt(lr, momentum=0.9, stiefel=True):
                return make_optimizer(cfg.optimizer, lr=lr, momentum=momentum)
        else:
            make_opt = sgdg
        self.validate_fit = make_fit(
            self.graph,
            make_opt(cfg.validate_lr, momentum=cfg.momentum, stiefel=True),
            max_steps=cfg.validate_steps,
            tol=cfg.tol,
            dtype=cfg.dtype,
        )
        self.prune_fit = make_fit(
            self.graph,
            make_opt(cfg.prune_lr, momentum=cfg.momentum, stiefel=True),
            max_steps=cfg.prune_steps,
            tol=cfg.tol,
            dtype=cfg.dtype,
        )

    def init_params(self, generator: GeneratorLike):
        """Fresh orthogonal cores on the experiment's device."""
        return init_params(self.graph, generator, self.cfg.dtype, self.device)

    def run_fit(self, fit, params, mask, target):
        t_params, t_mask = target
        return fit(params, mask, t_params, t_mask)

    def mask_vector(self, masked: Sequence[int]) -> torch.Tensor:
        m = np.ones(self.graph.ncores, np.float32)
        m[list(masked)] = 0.0
        return torch.as_tensor(m, device=self.device)

    def row_would_empty(self, masked: Sequence[int]) -> bool:
        """True if the mask touches a core with no transparent form (the MPS
        boundary cores: masking one zeroes the network)."""
        return bool(self.unmaskable) and not self.unmaskable.isdisjoint(masked)

    def candidate_indices(self) -> List[int]:
        """Core indices the pruning loop may try (excludes unmaskable)."""
        return [i for i in range(self.graph.ncores) if i not in self.unmaskable]


def make_experiment(cfg: Optional[SymmetryBreakingConfig] = None) -> Experiment:
    return Experiment(cfg or SymmetryBreakingConfig())


def target_tensor_init(exp: Experiment, target_mask_list: Sequence[int],
                       generator: GeneratorLike):
    """Random masked network -> the target ``(params, mask)`` (network
    mode needs no dense tensor, and no contraction)."""
    if exp.cfg.fidelity_mode != "network":
        raise NotImplementedError(_BRICK)
    return exp.init_params(generator), exp.mask_vector(target_mask_list)


def validate_target_tensor(exp: Experiment, target, generator: GeneratorLike,
                           return_params: bool = False):
    """Refit a fresh full network to the target; success at 1-F < tol.
    ``return_params=True`` also returns the fitted weights (the warm start
    of the pruning loop)."""
    params = exp.init_params(generator)
    res = exp.run_fit(exp.validate_fit, params, exp.mask_vector([]), target)
    infid = float(res.infidelity)
    if return_params:
        return infid < exp.cfg.tol, 1.0 - infid, int(res.steps), res.params
    return infid < exp.cfg.tol, 1.0 - infid, int(res.steps)


def symmetry_breaking(
    exp: Experiment,
    target,
    shuffle_seed: int,
    generator: Optional[GeneratorLike] = None,
    verbose: bool = True,
    warm_params=None,
) -> Tuple[List[int], int]:
    """Greedy pruning loop.  Returns ``(pruned_list, prune_count)``.

    ``shuffle_seed`` seeds the numpy shuffle of the candidate order (JAX
    derives it from its key, ``key_data(key)[-1]``; the port takes the
    integer, so both packages can be handed the same order).
    ``warm_params``: weights to warm-start every candidate fit from; with
    ``None`` each candidate starts from fresh cores drawn from
    ``generator`` (default: seeded with ``shuffle_seed``).
    """
    cfg = exp.cfg
    rng = np.random.default_rng(shuffle_seed)
    if generator is None:
        generator = torch.Generator().manual_seed(int(shuffle_seed))
    elif not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    pruned: List[int] = []
    prune_count = 0
    candidates = exp.candidate_indices()
    current = warm_params

    for _ in range(cfg.max_outer_iterations):
        pruned_any = False
        if len(pruned) == len(candidates):
            break
        rng.shuffle(candidates)
        for idx in candidates:
            if idx in pruned:
                continue
            prune_count += 1
            trial = pruned + [idx]
            if exp.row_would_empty(trial):
                if verbose:
                    print(f"  skip core {idx}: unmaskable", flush=True)
                continue
            params = current if current is not None else exp.init_params(generator)
            res = exp.run_fit(exp.prune_fit, params, exp.mask_vector(trial), target)
            infid = float(res.infidelity)
            if infid < cfg.tol:
                pruned = trial
                pruned_any = True
                if warm_params is not None:
                    current = res.params
                if verbose:
                    print(
                        f"  pruned core {idx} (now {len(pruned)} pruned), "
                        f"fidelity={1 - infid:.6f}, steps={int(res.steps)}",
                        flush=True,
                    )
            elif verbose:
                print(f"  core {idx} not prunable (1-F={infid:.3e})", flush=True)
        if not pruned_any:
            break
    return pruned, prune_count


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The JAX CLI drives the brick-wall experiment only."""
    raise NotImplementedError(_BRICK)
