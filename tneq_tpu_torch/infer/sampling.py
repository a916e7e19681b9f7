"""Autoregressive sampling by numerical inverse CDF.

Counterpart of ``tneq_tpu/infer/sampling.py``: per qubit, evaluate the
(unnormalised) density on a grid, invert the CDF with linear interpolation,
and set the sampled qubit's measurement operator for the qubits after it.

Per qubit the siamese network is contracted once with that qubit's
measurement legs left open, giving an environment ``E[s, k, l]``; the
density at every grid point is then the small product
``E[s,k,l]·Mx_grid[g,k,l]`` (the siamese value is linear in each
measurement operator), so the largest live tensor is the ``[S, G]``
density.

MPS chains go to the sweep sampler of ``infer/chain_sampling.py``.  Random
draws: every uniform of a call is drawn first, ``us [nq, S, 1]`` float32,
from the caller's ``torch.Generator`` in qubit order (the counterpart of
JAX's one ``split`` per qubit); :func:`_sample_from_uniforms` does the rest.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..graph.dsl import CircuitGraph
from ..ops.contract import abs_square, execute, make_siamese_env_fn
from ..ops.features import measurement_matrices
from .chain_sampling import (
    _chain_sample_from_uniforms,
    _draw_uniforms,
    _grid,
    _invert_cdf,
    supports_chain_sampling,
)

__all__ = ["sample"]


@functools.lru_cache(maxsize=512)
def _env_fn(graph: CircuitGraph, q: int, rescale: bool):
    """Qubit ``q``'s environment function, built once per ``(graph, q,
    rescale)``: its spec and contraction plan are the cost."""
    return make_siamese_env_fn(graph, q, rescale=rescale)


def _qubit_step(graph, q, rescale, params, states, measures, mx_grid, gx, u,
                density_power: int, dtype):
    """Qubit ``q``'s draw (the counterpart of the program of JAX's
    ``_env_step_program``): its environment under the current
    ``measures`` (the entry at ``q`` is unused), the ``[S, G]`` grid
    density, and the inverse CDF at ``u [S, 1]``.  Returns ``(y [S],
    Mx(y) [S, K, K])``."""
    S, K = u.shape[0], mx_grid.shape[-1]
    env = _env_fn(graph, q, bool(rescale))(params, states, measures)
    if rescale:
        env, _ = env  # the scale cancels in each sample's CDF normalisation
    if env.ndim == 2:  # one qubit: no sample axis
        env = env.expand(S, -1, -1)
    v = execute("skl,gkl->sg", [env, mx_grid])
    dens = abs_square(v) if v.is_complex() else v
    # square, then clip: the reverse of the chain sampler's order
    if density_power == 2:
        dens = dens * dens
    y = _invert_cdf(dens.clamp(min=0.0), gx, u)
    return y, measurement_matrices(y[:, None], K)[:, 0].to(dtype)


def _sample_from_uniforms(
    graph: CircuitGraph,
    params,
    states: Sequence[torch.Tensor],
    K: int,
    us: torch.Tensor,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    grid_size: int = 200,
    density_power: int = 1,
    dtype: torch.dtype = torch.complex64,
    rescale: bool = False,
) -> torch.Tensor:
    """The generic sampler on the uniforms ``us [nq, S, 1]``; ``[S, nq]``
    float32 on ``us``'s device."""
    nq, S = graph.nqubits, us.shape[1]
    gx, mx_grid = _grid(bounds, grid_size, K, dtype, us.device)
    # identity on every qubit not yet sampled
    measures = [torch.eye(K, dtype=dtype, device=us.device).expand(S, K, K)] * nq
    ys = []
    for q in range(nq):
        y, measures[q] = _qubit_step(graph, q, rescale, params, states, measures,
                                     mx_grid, gx, us[q], density_power, dtype)
        ys.append(y)
    return torch.stack(ys, dim=1)


def sample(
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
    rescale=None,
    chain=None,
    fused: bool = True,
) -> torch.Tensor:
    """Draw ``[num_samples, nqubits]`` continuous samples (float32, on the
    params' device).  ``generator`` (the counterpart of JAX's ``key``)
    must live on the params' device.

    ``density_power=2`` samples from P² (the reference's double Born
    square); the default 1 samples from P.

    ``rescale`` runs each qubit's environment through the per-step
    rescaled executor, float32-safe at 30 and more qubits (the per-qubit
    CDF is scale-invariant, so the log-scale cancels).  ``None`` turns it
    on from 16 qubits.

    MPS chains go to the sweep sampler (``infer/chain_sampling.py``):
    ``chain=False`` forces the generic path, ``chain=True`` requires the
    sweep sampler (and raises if the graph is not a canonical MPS chain).
    ``fused`` is passed to it (see ``chain_sample``).
    """
    nq = graph.nqubits
    if any(r != K for r in graph.output_ranks):
        raise ValueError(
            f"K={K} must equal every qubit's output rank {graph.output_ranks}"
        )
    dev = next(iter(params.values())).device
    us = _draw_uniforms(generator, nq, num_samples, dev)
    if chain is None or chain:
        supported = supports_chain_sampling(graph)
        if chain and not supported:
            raise ValueError(
                "chain=True requires a canonical MPS-chain graph "
                "(ops.mps_sweep.is_mps_chain layout)"
            )
        if supported:
            return _chain_sample_from_uniforms(
                graph, params, states, K, us, bounds=bounds, grid_size=grid_size,
                density_power=density_power, dtype=dtype, fused=fused,
            )
    if rescale is None:
        rescale = nq >= 16
    return _sample_from_uniforms(
        graph, params, states, K, us, bounds=bounds, grid_size=grid_size,
        density_power=density_power, dtype=dtype, rescale=rescale,
    )
