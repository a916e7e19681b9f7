"""The multi-device dry run: one step of each distributed path on a mesh.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's
entry point, which stays as it is).  Four sub-checks, each run once:

1. the data × model siamese training step: the batch over ``data``, the
   contraction bond-sliced over ``model``, an SGD-G update; then the
   sliced two-network overlap's gradient;
2. the 32-qubit × 5-cell masked network-fidelity fit (float32) bond-sliced
   over an n-position ``model`` mesh, 2 steps;
3. the FSDP stacked step (params and SGD-G momentum split over ``model``)
   on ``mps_graph(10, dim=8)``, with at least one group split;
4. a ``DistributedTrainer`` checkpoint save -> resume.

In one process the positions are ``[device] * n`` (the one-card form).
Run: ``python -m tneq_tpu_torch.parallel.dryrun [n] [--device cpu]``.
"""

from __future__ import annotations

import math
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Run the four sub-checks over ``n_devices`` positions on ``device``;
    raise on a failed check.  Returns what each sub-check measured."""
    from ..graph import build_brick_wall_incidence, incidence_to_graph, mps_graph, \
        parse_graph, wall_graph
    from ..model.qctn import init_params
    from ..ops import make_siamese_fn, measurement_matrices
    from ..ops.contract import abs_square
    from ..optim import sgdg
    from ..train.losses import nll_loss
    from ..train.network_fit import make_masked_network_fidelity_fit
    from ..train.trainer import basis_states
    from . import DistributedConfig, DistributedTrainer, make_mesh, shard_batch
    from .fsdp import group_shardings, make_fsdp_network_fit_step, stack_params
    from .mp import make_sliced_siamese_fn, make_sliced_two_network_fn

    dev = resolve_device(device)
    devices = [dev] * n_devices
    model_size = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data_size = n_devices // model_size
    mesh = make_mesh({"data": data_size, "model": model_size}, devices=devices)
    out: Dict[str, Any] = {"n_devices": n_devices, "data": data_size, "model": model_size}

    # --- 1. data x model siamese step
    graph = parse_graph(wall_graph(4, layers=2, dim=2))
    params = init_params(graph, 0, torch.complex64, device=dev)
    states = basis_states(graph, dtype=torch.complex64, device=dev)
    optimizer = sgdg(0.05, momentum=0.9, stiefel=True)
    opt_state = optimizer.init(params)
    if model_size > 1:
        contraction = make_sliced_siamese_fn(graph, mesh, model_axis="model", data_axis="data")
        reduce = contraction.reduce_gradients
    else:
        contraction = make_siamese_fn(graph)
        reduce = dict

    x = np.random.default_rng(0).normal(size=(data_size * 2, graph.nqubits))
    x = shard_batch(torch.as_tensor(x, dtype=torch.float32), mesh, "data")
    mx = measurement_matrices(x, 2).to(torch.complex64)
    measures = [mx[:, q] for q in range(graph.nqubits)]
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = nll_loss(abs_square(contraction(leaves, states, measures)))
    grads = reduce(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = {k: p + updates[k] for k, p in params.items()}
    loss = float(loss.detach())
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if model_size > 1:
        overlap = make_sliced_two_network_fn(graph, graph, mesh)
        t_params = init_params(graph, 1, torch.complex64, device=dev)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        val = abs_square(overlap(leaves, t_params))
        g = overlap.reduce_gradients(dict(zip(leaves, torch.autograd.grad(
            val, list(leaves.values())))))
        if not all(bool(torch.isfinite(v).all()) for v in g.values()):
            raise RuntimeError("non-finite sliced-overlap gradients")
    out["loss"] = loss
    print(f"  [1/4] DP x MP siamese step ok (loss={loss:.4f})", flush=True)

    # --- 2. the 32q x 5c flagship through the log-space sliced overlap
    mesh_m = make_mesh({"model": n_devices}, devices=devices)
    g32 = parse_graph(incidence_to_graph(build_brick_wall_incidence(32, 5)))
    fit32 = make_masked_network_fidelity_fit(
        g32, sgdg(1e-2, momentum=0.9, stiefel=True), max_steps=2, tol=1e-3,
        dtype=torch.float32, jit_scope="chunk", sync_every=2, mesh=mesh_m, device=dev)
    p32 = init_params(g32, 0, torch.float32, device=dev)
    mask32 = torch.ones(g32.ncores, device=dev)
    tmask32 = mask32.clone()
    tmask32[3] = 0.0
    infid32 = float(fit32(p32, mask32, p32, tmask32).infidelity)
    if not (math.isfinite(infid32) and 0.0 <= infid32 <= 1.0 + 1e-6):
        raise RuntimeError(f"32q sliced fit infidelity out of range: {infid32}")
    out["infidelity_32q"] = infid32
    print(f"  [2/4] 32q5c sliced network fit ok (2 steps, 1-F={infid32:.4f})", flush=True)

    # --- 3. the FSDP stacked step: params and momentum split over 'model'
    g_mps = parse_graph(mps_graph(10, dim=8))
    step_fsdp, prepare_fsdp, opt_fsdp = make_fsdp_network_fit_step(
        g_mps, mesh_m, learning_rate=1e-2, momentum=0.9, axis="model")
    p_mps = init_params(g_mps, 1, torch.float32, device=dev)
    arrays = prepare_fsdp(p_mps)
    t_arrays = prepare_fsdp(init_params(g_mps, 2, torch.float32, device=dev))
    sharded = sum(1 for pl in group_shardings(stack_params(g_mps, p_mps, n_devices), mesh_m)
                  if pl.spec)
    if n_devices > 1 and sharded < 1:
        raise RuntimeError("no FSDP param group is split")
    opt_state_f = opt_fsdp.init(arrays)
    arrays, opt_state_f, loss_f = step_fsdp(arrays, opt_state_f, t_arrays)
    loss_f = float(loss_f)
    if not math.isfinite(loss_f):
        raise RuntimeError(f"non-finite FSDP loss {loss_f}")
    out.update(fsdp_split_groups=sharded, fsdp_loss=loss_f)
    print(f"  [3/4] FSDP stacked step ok ({sharded} split group(s), loss={loss_f:.4f})",
          flush=True)

    # --- 4. DistributedTrainer checkpoint save -> resume under the mesh
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = dict(graph=wall_graph(4, layers=2, dim=2), data_axis=data_size,
                   model_axis=model_size, max_steps=2, batch_size=2 * data_size,
                   num_batches=2, dtype="complex64", log_every=0,
                   checkpoint_dir=ckpt_dir, checkpoint_every=1)
        _, stats1 = DistributedTrainer(DistributedConfig(**cfg), devices=devices).train()
        if stats1.steps != 2:
            raise RuntimeError(f"trainer ran {stats1.steps} steps, not 2")
        _, stats2 = DistributedTrainer(
            DistributedConfig(**{**cfg, "max_steps": 4, "resume": True}),
            devices=devices).train()
        if stats2.steps != 4 or len(stats2.losses) != 2 \
                or not math.isfinite(stats2.losses[-1]):
            raise RuntimeError(f"resume did not continue: {stats2.steps} steps, "
                               f"losses {stats2.losses}")
    out["resumed_losses"] = stats2.losses
    print("  [4/4] DistributedTrainer save->resume ok", flush=True)
    print(f"dryrun_multichip ok: {n_devices} devices (data={data_size}, "
          f"model={model_size}), loss={loss:.4f}", flush=True)
    return out


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="multi-device dry run")
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args()
    dryrun_multichip(args.n_devices, args.device)
