"""Inverse-CDF sampling of MPS-chain circuits by one left-to-right sweep.

Counterpart of ``tneq_tpu/infer/chain_sampling.py``.  For MPS chains (core i
on qubits (i, i+1), ``ops/mps_sweep.is_mps_chain``) the classic sampling
sweep replaces the generic sampler's whole-network environment per qubit:

1.  absorb the input states into the cores, giving site tensors
    ``A_0 [o_0, b]``, ``A_i [a, o_i, b]``, ``A_last [a, o_{n-2}, o_{n-1}]``;
2.  precompute the right environments ``R_i [b, b̄]`` (identity measures on
    everything right of bond i) by one right-to-left pass; they do not
    depend on the sampled values;
3.  sweep left to right: the open qubit's environment is the small
    combine ``L·A·conj(A)·R``; after drawing ``y_q``, absorb ``Mx(y_q)``
    into the per-sample left environment ``L``.

Every step renormalises (per sample for ``L``), so the CDFs are
scale-invariant and float32-safe at any depth.  Each multi-operand step
runs as pairwise ``torch.einsum`` steps along the native path
(``ops/contract.execute``).

Random draws: JAX splits one key per qubit and draws ``uniform(subkey,
(S, 1))`` in the step.  Here every uniform of a call is drawn first, ``us
[nq, S, 1]`` float32, from an explicit ``torch.Generator`` on the params'
device, in qubit order; :func:`_chain_sample_from_uniforms` does the rest,
so the same ``us`` can be fed to the card and to the host, or replayed from
JAX's key schedule.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph
from ..ops.contract import abs_square, execute
from ..ops.features import measurement_matrices
from ..ops.mps_sweep import is_mps_chain

__all__ = ["supports_chain_sampling", "chain_sample"]

_TINY = 1e-30


def _chain_plan(graph: CircuitGraph):
    """Structural plan for the canonical MPS layout, or None if the graph
    deviates from it.  Per core: ``(state_axes, order)`` where
    ``state_axes`` is ``[(axis_pos, qubit), ...]`` in descending position
    (absorption order) and ``order`` is the permutation of the
    post-absorption tensor into ``[left_bond?, out_legs..., right_bond?]``
    (outs by ascending qubit).  Graph metadata only, so
    :func:`supports_chain_sampling` can check the layout before dispatch."""
    n = graph.ncores
    plan = []
    for i, core in enumerate(graph.cores):
        axes = []  # in-edges then out-edges, as the raw tensor's axes
        for is_out, edges in ((False, core.in_edges), (True, core.out_edges)):
            for e in edges:
                if e.neighbor == -1:
                    axes.append(("out" if is_out else "state", e.qubit))
                elif e.neighbor == i - 1:
                    axes.append(("left", e.qubit))
                elif e.neighbor == i + 1:
                    axes.append(("right", e.qubit))
                else:
                    return None
        # state axes are absorbed highest position first, so the lower
        # positions stay valid
        state_axes = sorted(
            ((p, q) for p, (k, q) in enumerate(axes) if k == "state"),
            reverse=True,
        )
        rem = [a for a in axes if a[0] != "state"]
        order = (
            [p for p, (k, _) in enumerate(rem) if k == "left"]
            + sorted(
                (p for p, (k, _) in enumerate(rem) if k == "out"),
                key=lambda p: rem[p][1],
            )
            + [p for p, (k, _) in enumerate(rem) if k == "right"]
        )
        kinds = [rem[p][0] for p in order]
        expect = (
            (["out", "right"] if i == 0 else
             ["left", "out", "out"] if i == n - 1 else
             ["left", "out", "right"])
            if n > 1
            else ["out", "out"]
        )
        if kinds != expect:
            return None
        plan.append((state_axes, order))
    return plan


def _site_tensors(graph: CircuitGraph, params, states) -> List[torch.Tensor]:
    """Absorb the input states; the site tensors in canonical axis order
    (see :func:`_chain_plan`), or None for a non-canonical layout."""
    plan = _chain_plan(graph)
    if plan is None:
        return None
    sites = []
    for core, (state_axes, order) in zip(graph.cores, plan):
        arr = params[core.name]
        for pos, q in state_axes:
            s = torch.as_tensor(states[q], device=arr.device)
            dt = torch.promote_types(arr.dtype, s.dtype)
            arr = torch.tensordot(arr.to(dt), s.to(dt), dims=([pos], [0]))
        sites.append(arr.permute(order))
    return sites


def supports_chain_sampling(graph: CircuitGraph) -> bool:
    # is_mps_chain admits layouts (mirrored output legs, say) the sweep
    # cannot canonicalise: check the whole plan
    return graph.ncores >= 2 and is_mps_chain(graph) and _chain_plan(graph) is not None


def _norm_rows(x: torch.Tensor, batch_axes: int) -> torch.Tensor:
    """Max-abs normalise over all but the leading ``batch_axes`` axes; the
    scale is detached."""
    red = tuple(range(batch_axes, x.ndim))
    s = torch.amax(x.abs(), dim=red, keepdim=True) + _TINY
    return x / s.detach()


def _born(v: torch.Tensor) -> torch.Tensor:
    return abs_square(v) if v.is_complex() else v


def _grid(bounds: Tuple[float, float], G: int, K: int, dtype, device):
    """The grid points ``[G]`` float32 and their measurement operators
    ``[G, K, K]`` in ``dtype``."""
    gx = torch.as_tensor(
        np.linspace(bounds[0], bounds[1], G, dtype=np.float32), device=device
    )
    return gx, measurement_matrices(gx[:, None], K)[:, 0].to(dtype)


def _draw_uniforms(generator: torch.Generator, nq: int, S: int, device) -> torch.Tensor:
    """Every uniform of one sampling call, ``[nq, S, 1]`` float32, in qubit
    order, from ``generator`` (which must live on ``device``)."""
    return torch.rand((nq, S, 1), generator=generator, dtype=torch.float32, device=device)


def _invert_cdf(dens: torch.Tensor, gx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row of the non-negative grid density ``dens [S, G]``:
    invert its normalised CDF at ``u [S, 1]`` with linear interpolation
    between grid points.  Returns ``y [S]``."""
    G = dens.shape[1]
    cdf = torch.cumsum(dens, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    idx = (cdf < u).sum(dim=1).clamp(max=G - 2)[:, None]
    cdf_l = torch.gather(cdf, 1, idx)
    cdf_r = torch.gather(cdf, 1, idx + 1)
    x_l = gx[idx[:, 0]][:, None]
    x_r = gx[idx[:, 0] + 1][:, None]
    # clamp: a zero-density (flat-CDF) bin makes the raw ratio unbounded
    frac = ((u - cdf_l) / (cdf_r - cdf_l + 1e-10)).clamp(0.0, 1.0)
    return (x_l + frac * (x_r - x_l))[:, 0]


def _step_bodies(S: int, K: int, density_power: int, dtype):
    """The draw and the four per-site step bodies, each taking its
    uniforms ``u [S, 1]`` explicitly."""

    def draw(dens, gx, u):
        # clip, then square: the reverse of the generic sampler's order
        dens = dens.clamp(min=0.0)
        if density_power == 2:
            dens = dens * dens
        y = _invert_cdf(dens, gx, u)
        return y, measurement_matrices(y[:, None], K)[:, 0].to(dtype)

    def step_first(A0, r, mg, gx, u):
        env = execute("ob,pd,bd->op", [A0, A0.conj(), r])  # env over o_0
        dens = _born(execute("op,gop->g", [env, mg]))
        y, mx_y = draw(dens[None].expand(S, -1), gx, u)
        L = execute("ob,sop,pd->sbd", [A0, mx_y, A0.conj()])
        return y, _norm_rows(L, 1)

    def step_mid(L, A, r, mg, gx, u):
        env = execute("sac,aob,cpd,bd->sop", [L, A, A.conj(), r])
        dens = _born(execute("sop,gop->sg", [env, mg]))
        y, mx_y = draw(dens, gx, u)
        L2 = execute("sac,aob,sop,cpd->sbd", [L, A, mx_y, A.conj()])
        return y, _norm_rows(L2, 1)

    def step_last_first(L, A, mg, gx, u):
        # A: [a, o, p]; identity on p
        env = execute("sac,aop,cqp->soq", [L, A, A.conj()])
        dens = _born(execute("soq,goq->sg", [env, mg]))
        y, mx_y = draw(dens, gx, u)
        L2 = execute("sac,aop,soq,cqr->spr", [L, A, mx_y, A.conj()])  # absorb o
        return y, _norm_rows(L2, 1)

    def step_last_second(L, mg, gx, u):
        dens = _born(execute("spr,gpr->sg", [L, mg]))
        y, _ = draw(dens, gx, u)
        return y

    return draw, step_first, step_mid, step_last_first, step_last_second


def _right_envs(mids: Sequence[torch.Tensor], last: torch.Tensor) -> List[torch.Tensor]:
    """Right environments by one reverse loop: entry i is the env to the
    right of core i, for i = 0 .. n-2 (the last is the bare last-core
    env).  Uniform and non-uniform chains, and the two-core chain (no
    middles), take the same loop."""
    r = _norm_rows(execute("aop,bop->ab", [last, last.conj()]), 0)
    rs = [r]
    for A in reversed(mids):
        r = _norm_rows(execute("aob,cod,bd->ac", [A, A.conj(), r]), 0)
        rs.append(r)
    return rs[::-1]


def _chain_sample_from_uniforms(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    K: int,
    us: torch.Tensor,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    grid_size: int = 200,
    density_power: int = 1,
    dtype: torch.dtype = torch.complex64,
    fused: bool = True,
) -> torch.Tensor:
    """The sweep on the uniforms ``us [nq, S, 1]``; ``[S, nq]`` float32 on
    ``us``'s device."""
    sites = _site_tensors(graph, params, states)
    if sites is None:
        raise ValueError("graph is not in canonical MPS-chain layout")
    n = graph.ncores
    S = us.shape[1]
    gx, mg = _grid(bounds, grid_size, K, dtype, us.device)
    _, step_first, step_mid, step_last_first, step_last_second = _step_bodies(
        S, K, density_power, dtype
    )
    rs = _right_envs(sites[1:-1], sites[-1])
    ys = []
    y, L = step_first(sites[0], rs[0], mg, gx, us[0])
    ys.append(y)
    for i in range(1, n - 1):
        y, L = step_mid(L, sites[i], rs[i], mg, gx, us[i])
        ys.append(y)
    y, L = step_last_first(L, sites[-1], mg, gx, us[n - 1])
    ys.append(y)
    ys.append(step_last_second(L, mg, gx, us[n]))
    if fused:
        return torch.stack(ys, dim=1)
    # one copy to the host per qubit, as JAX's per-site dispatch makes
    samples = np.zeros((S, n + 1), np.float32)
    for q, y in enumerate(ys):
        samples[:, q] = y.cpu().numpy()
    return torch.as_tensor(samples, device=us.device)


def chain_sample(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    num_samples: int,
    K: int,
    generator: torch.Generator,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    grid_size: int = 200,
    density_power: int = 1,
    dtype: torch.dtype = torch.complex64,
    fused: bool = True,
) -> torch.Tensor:
    """MPS-chain sampler; same semantics as :func:`tneq_tpu_torch.infer.sample`.

    Draws ``[num_samples, nqubits]`` float32 on the params' device.  Both
    values of ``fused`` run the same steps in the same order on the same
    device, so their draws are identical bit for bit: ``fused=True`` keeps
    every draw on the device until the end, ``fused=False`` copies each
    qubit's draws to the host as it goes, as JAX's per-site dispatch does.
    (JAX's ``fused=True`` is one XLA program of its own, whose draws may
    differ from its per-site path by a grid bin.)"""
    dev = next(iter(params.values())).device
    us = _draw_uniforms(generator, graph.nqubits, num_samples, dev)
    return _chain_sample_from_uniforms(
        graph, params, states, K, us, bounds=bounds, grid_size=grid_size,
        density_power=density_power, dtype=dtype, fused=fused,
    )
