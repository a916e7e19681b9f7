"""Symmetry-breaking experiment: iterative core pruning on a QCTN.

Counterpart of ``tneq_tpu/apps/symmetry_breaking.py``:

1. build the circuit — the reference's brick wall (``topology='brick'``,
   the default: ``n_cells`` layers of two-qubit gates of bond rank
   ``rank``) or an MPS chain (``'mps'``: physical rank ``rank``, bond
   ``bond_dim``);
2. draw a random target network with a planted set of cores masked out:
   contracted to a dense target tensor (``fidelity_mode='dense'``, the
   default), or kept as the masked network itself (``'network'``, which
   the chain requires);
3. validate the target by refitting a fresh full network to 1-F < tol;
4. greedily try to prune one more core: mask it, refit (warm-started from
   the validated fit, or cold), keep it pruned if the fidelity recovers.

Pruning is a mask input to one fit, so every candidate reuses the same
code path.  The dense fit contracts the network as pairwise
``torch.einsum`` steps along the native path (``ops/contract.py``); in
network mode the brick wall's overlaps run the row sweep
(``ops/row_scan.py``) and, on the card, a float32 chain's overlaps the
sweep kernels (``ops/chain_overlap.py``).  ``complex_as_real`` runs the
brick wall's complex cores as stacked-real pairs (``ops/complex_pair.py``,
``optim/pair_stiefel.py``).  :func:`symmetry_breaking_batched` scores every
remaining candidate of an accept round in lockstep lanes (``fit.batched``,
``torch.func.vmap``), at most ``lane_chunk`` per call.  Still to come:
bond-sliced multi-device overlaps (item 11).

    python -m tneq_tpu_torch.apps.symmetry_breaking --device cpu --n-qubits 4 --n-cells 2
    python -m tneq_tpu_torch.apps.symmetry_breaking --device cpu --n-qubits 4 --n-cells 2 \
        --fidelity-mode network
    python -m tneq_tpu_torch.apps.symmetry_breaking --device cpu --n-qubits 4 --n-cells 2 \
        --dtype complex64-pair --batched
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, parse_graph
from ..graph.generators import build_brick_wall_incidence, incidence_to_graph, mps_graph
from ..model.qctn import GeneratorLike, init_params
from ..ops.complex_pair import make_pair_core_only_fn, pair_tree
from ..ops.contract import make_core_only_fn
from ..optim.factory import make_optimizer
from ..optim.pair_stiefel import pair_sgdg
from ..optim.stiefel import sgdg
from ..train.fit import (
    identity_cores,
    make_masked_fidelity_fit,
    masked_cores,
    pair_identity_cores,
    transparent_cores,
)
from ..train.network_fit import make_masked_network_fidelity_fit
from ..utils.device import matmul_precision, resolve_device

__all__ = [
    "SymmetryBreakingConfig",
    "Experiment",
    "make_experiment",
    "target_tensor_init",
    "validate_target_tensor",
    "symmetry_breaking",
    "symmetry_breaking_batched",
    "main",
]

_SLICED = (
    "bond-sliced multi-device overlaps (--slice-devices) wait for the "
    "parallel layer (ROADMAP queue A, item 11)"
)


@dataclass
class SymmetryBreakingConfig:
    """Fields and defaults as in the JAX config (the reference's 8-qubit,
    5-cell, rank-2 brick wall in complex64 with Stiefel SGD-G, dense
    fidelity); ``dtype`` is a torch dtype and ``device`` selects the card
    (default) or the host (``'cpu'``)."""

    n_qubits: int = 8
    n_cells: int = 5
    rank: int = 2
    # 'brick': n_cells layers of two-qubit gates of bond rank `rank`;
    # 'mps': a chain with physical rank `rank` and bond `bond_dim`, masked
    # with transparent cores, which requires fidelity_mode='network'
    topology: str = "brick"
    bond_dim: int = 64
    # 'sgdg' (Stiefel SGD-G) or any optim.factory method; MPS fits need an
    # unconstrained optimizer (the Stiefel flow stalls on chain cores,
    # STIEFEL_STALL_r05.json)
    optimizer: str = "sgdg"
    matmul_precision: str = "highest"
    # 'dense': fidelity against a materialised 4^n target tensor;
    # 'network': fidelity from network-network overlaps only
    fidelity_mode: str = "dense"
    dtype: torch.dtype = torch.complex64
    # complex cores as stacked-real pairs (ops/complex_pair.py), the brick
    # wall only
    complex_as_real: bool = False
    validate_lr: float = 1.0
    validate_steps: int = 4000
    # the most lanes of one fit.batched call in symmetry_breaking_batched
    lane_chunk: int = 8
    fit_jit_scope: str = "fit"
    fit_sync_every: int = 1
    mesh: object = None
    prune_lr: float = 1e-2
    prune_steps: int = 5000
    momentum: float = 0.9
    tol: float = 1e-3
    max_outer_iterations: int = 500
    seed: int = 0
    device: str = "cuda"

    @property
    def n_cores(self) -> int:
        return (self.n_qubits - 1) * self.n_cells


class Experiment:
    """One topology with its two fits (validate, prune)."""

    def __init__(self, cfg: SymmetryBreakingConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.incidence: Optional[np.ndarray] = None
        self.unmaskable: frozenset = frozenset()
        identities = None
        if cfg.topology == "mps":
            if cfg.fidelity_mode != "network":
                raise ValueError(
                    "topology='mps' requires fidelity_mode='network' (a "
                    "dense 4^n target defeats the point of the chain)"
                )
            if cfg.complex_as_real:
                raise ValueError("topology='mps' has no pair-form identities")
            self.graph: CircuitGraph = parse_graph(
                mps_graph(cfg.n_qubits, cfg.bond_dim, phys=cfg.rank)
            )
            # pairing='kind': bond->bond x phys->phys at every bond_dim
            identities, unmask = transparent_cores(self.graph, cfg.dtype, pairing="kind")
            self.unmaskable = frozenset(unmask)
        elif cfg.topology == "brick":
            self.incidence = build_brick_wall_incidence(cfg.n_qubits, cfg.n_cells, cfg.rank)
            self.graph = parse_graph(incidence_to_graph(self.incidence))
        else:
            raise ValueError(f"unknown topology {cfg.topology!r}")
        common = dict(jit_scope=cfg.fit_jit_scope, sync_every=cfg.fit_sync_every,
                      matmul_precision=cfg.matmul_precision, device=self.device)
        if cfg.fidelity_mode == "network":
            make_fit = partial(make_masked_network_fidelity_fit, mesh=cfg.mesh,
                               identities=identities, **common)
        elif cfg.fidelity_mode == "dense":
            make_fit = partial(make_masked_fidelity_fit, **common)
        else:
            raise ValueError(f"unknown fidelity_mode {cfg.fidelity_mode!r}")
        if cfg.complex_as_real:
            make_opt = pair_sgdg
        elif cfg.optimizer != "sgdg":
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
            complex_as_real=cfg.complex_as_real,
        )
        self.prune_fit = make_fit(
            self.graph,
            make_opt(cfg.prune_lr, momentum=cfg.momentum, stiefel=True),
            max_steps=cfg.prune_steps,
            tol=cfg.tol,
            dtype=cfg.dtype,
            complex_as_real=cfg.complex_as_real,
        )

    def init_params(self, generator: GeneratorLike):
        """Fresh orthogonal cores on the experiment's device; in pair mode
        complex64 cores converted to stacked-real pairs."""
        if self.cfg.complex_as_real:
            return pair_tree(init_params(self.graph, generator, torch.complex64, self.device))
        return init_params(self.graph, generator, self.cfg.dtype, self.device)

    def run_fit(self, fit, params, mask, target):
        """Invoke a fit with the mode's target: a dense tensor, or the
        ``(params, mask)`` of the target network."""
        if self.cfg.fidelity_mode == "network":
            t_params, t_mask = target
            return fit(params, mask, t_params, t_mask)
        return fit(params, mask, target)

    def mask_vector(self, masked: Sequence[int]) -> torch.Tensor:
        m = np.ones(self.graph.ncores, np.float32)
        m[list(masked)] = 0.0
        return torch.as_tensor(m, device=self.device)

    def row_would_empty(self, masked: Sequence[int]) -> bool:
        """True if this mask is structurally forbidden: a brick-wall qubit
        row left with no cores, or a core with no transparent form (the MPS
        boundary cores: masking one zeroes the network)."""
        if self.unmaskable and not self.unmaskable.isdisjoint(masked):
            return True
        if self.incidence is None:
            return False
        inc = self.incidence.copy()
        inc[:, list(masked)] = 0
        return bool(((inc > 0).sum(axis=1) == 0).any())

    def candidate_indices(self) -> List[int]:
        """Core indices the pruning loop may try (excludes unmaskable)."""
        return [i for i in range(self.graph.ncores) if i not in self.unmaskable]


def make_experiment(cfg: Optional[SymmetryBreakingConfig] = None) -> Experiment:
    return Experiment(cfg or SymmetryBreakingConfig())


def target_tensor_init(exp: Experiment, target_mask_list: Sequence[int],
                       generator: GeneratorLike):
    """Random masked network -> the target: the dense tensor of the masked
    cores, contracted at 'highest' precision, or in network mode the
    ``(params, mask)`` of the masked network itself."""
    params = exp.init_params(generator)
    mask = exp.mask_vector(target_mask_list)
    if exp.cfg.fidelity_mode == "network":
        return params, mask
    if exp.cfg.complex_as_real:
        cast, idents, core_fn = (torch.float32, pair_identity_cores(exp.graph),
                                 make_pair_core_only_fn(exp.graph))
    else:
        cast, idents, core_fn = (exp.cfg.dtype, identity_cores(exp.graph, exp.cfg.dtype),
                                 make_core_only_fn(exp.graph))
    idents = {k: torch.as_tensor(v).to(device=exp.device, dtype=cast) for k, v in idents.items()}
    eff = masked_cores(params, mask, idents, exp.graph.core_names, cast)
    with torch.no_grad(), matmul_precision("highest"):
        return core_fn(eff)


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
    forbidden = "would empty a qubit row" if exp.incidence is not None else "unmaskable"
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
                    print(f"  skip core {idx}: {forbidden}", flush=True)
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


def symmetry_breaking_batched(
    exp: Experiment,
    target,
    warm_params,
    verbose: bool = True,
) -> Tuple[List[int], int]:
    """Batched pruning: score every remaining candidate of a round in one
    lockstep fit (``prune_fit.batched``), then accept the viable candidate
    with the smallest 1 − F and start the next round from its lane's
    params.  Returns ``(pruned_list, prune_count)``.

    The candidates (those that ``row_would_empty`` does not forbid) run in
    pieces of at most ``lane_chunk`` lanes, the last piece padded by
    repeating its last mask; each lane starts from ``warm_params``.  A
    piece runs ``k = fit_sync_every`` steps per exit test where that is
    above 1, else 16, clamped to ``prune_steps``.  The accepted set matches
    the sequential greedy loop up to its order of trying candidates.
    Rounds continue until no candidate is viable (``max_outer_iterations``
    bounds the sequential loop's passes only, as in JAX).
    """
    cfg = exp.cfg
    batched_fit = exp.prune_fit.batched
    chunk = max(1, int(cfg.lane_chunk))
    k = int(cfg.fit_sync_every) if int(cfg.fit_sync_every) > 1 else 16
    k = max(1, min(k, int(cfg.prune_steps)))
    pruned: List[int] = []
    prune_count = 0
    current = warm_params

    def run_chunked(masks_np):
        infids, params_chunks = [], []
        for lo in range(0, masks_np.shape[0], chunk):
            part = masks_np[lo: lo + chunk]
            pad = chunk - part.shape[0]
            if pad:
                part = np.concatenate([part, np.repeat(part[-1:], pad, 0)])
            masks = torch.as_tensor(part, device=exp.device)
            if cfg.fidelity_mode == "network":
                t_params, t_mask = target
                res = batched_fit(current, masks, t_params, t_mask, chunk_steps=k)
            else:
                res = batched_fit(current, masks, target, chunk_steps=k)
            take = part.shape[0] - pad
            infids.append(res.infidelity[:take].detach().cpu().numpy())
            params_chunks.append({n: v[:take] for n, v in res.params.items()})
        all_params = {n: torch.cat([p[n] for p in params_chunks]) for n in params_chunks[0]}
        return np.concatenate(infids), all_params

    while len(pruned) < exp.graph.ncores:
        candidates = [c for c in exp.candidate_indices()
                      if c not in pruned and not exp.row_would_empty(pruned + [c])]
        if not candidates:
            break
        masks_np = np.stack([exp.mask_vector(pruned + [c]).cpu().numpy() for c in candidates])
        prune_count += len(candidates)
        infids, res_params = run_chunked(masks_np)
        ok = infids < cfg.tol
        if not ok.any():
            if verbose:
                print(f"  no prunable core among {len(candidates)} "
                      f"(best 1-F={float(infids.min()):.3e})", flush=True)
            break
        best = int(np.argmin(np.where(ok, infids, np.inf)))
        idx = candidates[best]
        pruned = pruned + [idx]
        current = {n: v[best] for n, v in res_params.items()}
        if verbose:
            print(f"  pruned core {idx} (now {len(pruned)} pruned, "
                  f"1-F={float(infids[best]):.3e}; "
                  f"{int(ok.sum())}/{len(candidates)} candidates viable)", flush=True)
    return pruned, prune_count


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """CLI driver of the brick-wall experiment: generate and validate a
    target, then run repeated symmetry-breaking restarts keeping the best
    pruned set.  JAX's flags and defaults, plus ``--device``.  Restart r
    shuffles with seed ``seed + r`` (JAX splits its key)."""
    p = argparse.ArgumentParser(description="QCTN symmetry-breaking experiment")
    p.add_argument("--n-qubits", type=int, default=8)
    p.add_argument("--n-cells", type=int, default=5)
    p.add_argument("--rank", type=int, default=2)
    p.add_argument("--restarts", type=int, default=20)
    p.add_argument("--validate-steps", type=int, default=4000)
    p.add_argument("--prune-steps", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-mask", type=int, nargs="*", default=None)
    p.add_argument("--save", type=str, default=None, help="save best run JSON")
    p.add_argument("--batched", action="store_true",
                   help="score all pruning candidates per round in lockstep "
                        "lanes of one vmapped fit (implies warm start)")
    p.add_argument("--lane-chunk", type=int, default=8,
                   help="max lanes per fit call in --batched mode")
    p.add_argument("--cold-start", action="store_true",
                   help="fresh random init per pruning candidate "
                        "(reference behavior; default warm-starts from the "
                        "validated fit)")
    p.add_argument("--fidelity-mode", choices=["dense", "network"],
                   default="dense",
                   help="'network' computes fidelity from network overlaps "
                        "(no dense target; required beyond ~14 qubits)")
    p.add_argument("--dtype",
                   choices=["complex64", "float32", "complex64-pair"],
                   default="complex64",
                   help="core dtype; float32 runs the real-orthogonal "
                        "variant; complex64-pair runs the complex cores as "
                        "stacked-real pairs (real tensors only)")
    p.add_argument("--jit-scope", choices=["fit", "step", "chunk"],
                   default="fit",
                   help="'fit': exit tested before every step; 'step': every "
                        "sync-every steps; 'chunk': after whole sync-every "
                        "chunks")
    p.add_argument("--sync-every", type=int, default=1,
                   help="steps per exit test for jit-scope step/chunk")
    p.add_argument("--slice-devices", type=int, default=1,
                   help="network-mode fits: shard bond-sliced overlaps over "
                        "this many devices (not ported yet: item 11)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    if args.slice_devices > 1:
        if args.fidelity_mode != "network":
            p.error("--slice-devices requires --fidelity-mode network")
        raise NotImplementedError(_SLICED)
    cfg = SymmetryBreakingConfig(
        n_qubits=args.n_qubits,
        n_cells=args.n_cells,
        rank=args.rank,
        fidelity_mode=args.fidelity_mode,
        validate_steps=args.validate_steps,
        prune_steps=args.prune_steps,
        seed=args.seed,
        dtype=torch.float32 if args.dtype == "float32" else torch.complex64,
        complex_as_real=args.dtype == "complex64-pair",
        lane_chunk=args.lane_chunk,
        fit_jit_scope=args.jit_scope,
        fit_sync_every=args.sync_every,
        device=args.device,
    )
    exp = make_experiment(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)

    if args.target_mask is None:
        # the reference 8-qubit experiment mask; a random quarter of the
        # cores for other sizes
        if cfg.n_qubits == 8 and cfg.n_cells == 5:
            target_mask = [2, 3, 5, 8, 9, 12, 13, 14, 15, 17, 18, 20, 21, 23,
                           25, 26, 29, 31, 32, 33]
        else:
            rng = np.random.default_rng(cfg.seed)
            target_mask = sorted(
                rng.choice(cfg.n_cores, size=max(1, cfg.n_cores // 4), replace=False)
                .tolist()
            )
    else:
        target_mask = args.target_mask

    print(f"brick wall: {cfg.n_qubits} qubits x {cfg.n_cells} cells "
          f"({exp.graph.ncores} cores); target mask: {target_mask}")

    t0 = time.time()
    while True:
        target = target_tensor_init(exp, target_mask, gen)
        ok, fid, steps, fitted = validate_target_tensor(exp, target, gen, return_params=True)
        print(f"target validation: fidelity={fid:.6f} in {steps} steps "
              f"({'ok' if ok else 'regenerating'})")
        if ok:
            break
    print(f"target ready in {time.time() - t0:.1f}s")

    best_pruned: List[int] = []
    total_attempts = 0
    for restart in range(args.restarts):
        print(f"=== restart {restart} ===")
        if args.batched:
            pruned, count = symmetry_breaking_batched(exp, target, warm_params=fitted)
        else:
            pruned, count = symmetry_breaking(
                exp, target, cfg.seed + restart,
                warm_params=None if args.cold_start else fitted,
            )
        total_attempts += count
        if len(pruned) > len(best_pruned):
            best_pruned = pruned

    print(incidence_to_graph(exp.incidence, mask_list=target_mask,
                             for_display=True, mask_char="#"))
    print(f"best: pruned {len(best_pruned)}/{exp.graph.ncores} cores "
          f"({total_attempts} attempts): {sorted(best_pruned)}")
    result = {
        "pruned": sorted(best_pruned),
        "attempts": total_attempts,
        "n_cores": exp.graph.ncores,
        "target_mask": list(target_mask),
    }
    if args.save:
        with open(args.save, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
