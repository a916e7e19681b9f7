"""Network-space fidelity fitting: no dense target tensor, log-space math.

Counterpart of ``tneq_tpu/train/network_fit.py`` for MPS chains.  The
fidelity of two same-graph networks,

    log F = 2·log|⟨t,o⟩| − log⟨o,o⟩ − log⟨t,t⟩,

is computed from network-network overlaps on max-abs-normalised cores, each
chain overlap as a transfer sweep with per-site max-abs rescaling (detached
scales keep the LOG gradient exact).  A chain inside
``ops.chain_overlap.fused_chain_supported`` (real float32, uniform bond,
S = bond² <= 1024) runs through the sweep kernels; any other chain runs the
direct einsum scan :func:`_chain_log_overlap`, as JAX does.

Non-chain graphs (the row-sweep and pairwise executors), the multi-chip
mesh and the stacked-real ``complex_as_real`` fits wait for later slices and
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..graph.dsl import CircuitGraph
from ..ops.chain_overlap import _TINY, _rescale, fused_chain_log_overlap, fused_chain_supported
from ..ops.mps_sweep import is_mps_chain
from ..ops.scaling import auto_scale
from ..optim.stiefel import GradientTransformation
from ..utils.device import DeviceLike, resolve_device
from ..utils.device import matmul_precision as _precision
from ._fit_driver import FitDrivers
from .fit import FitResult, identity_cores, masked_cores

__all__ = [
    "make_masked_network_fidelity_fit",
    "network_fidelity",
    "network_log_fidelity",
]

_NON_CHAIN = (
    "only MPS chains with >= 2 cores are ported so far; other graphs need "
    "ops/row_scan.py and ops/pairwise.py (ROADMAP queue A, item 7b)"
)


def _normalize(params):
    return {n: auto_scale(v).data for n, v in params.items()}


def _chain_cores(graph: CircuitGraph, params):
    """Ordered (first, middles-stacked-or-None, last) cores for an MPS
    chain, or None when it cannot scan: middles must be shape-uniform AND
    every bond dim along the chain equal."""
    names = graph.core_names
    first, last = params[names[0]], params[names[-1]]
    mids = [params[n] for n in names[1:-1]]
    if mids and any(m.shape != mids[0].shape for m in mids):
        return None
    bonds = {first.shape[-1], last.shape[0]}
    if mids:
        bonds |= {mids[0].shape[0], mids[0].shape[-1]}
    if len(bonds) != 1:
        return None
    stacked = torch.stack(mids) if mids else None
    return first, stacked, last


def _chain_log_overlap(a, b) -> torch.Tensor:
    """log |⟨A, B⟩| of two same-structure chains by the direct transfer
    scan with per-step max-abs rescaling (detached scales).

    Core axis convention (graph/dsl.py: in-edges then out-edges, ascending
    qubit): first ``[x0, x1, y0, c]``, middle ``[c, x, y, c']``, last
    ``[c, x, y, z]``.
    """
    (fa, ma, la), (fb, mb, lb) = a, b
    v = torch.einsum("xiyc,xiye->ce", fa, fb.conj())
    v, logs = _rescale(v, torch.zeros((), dtype=v.real.dtype, device=v.device))
    if ma is not None:
        for A, B in zip(ma, mb):
            v = torch.einsum("ce,cxyf->exyf", v, A)
            v = torch.einsum("exyf,exyg->fg", v, B.conj())
            v, logs = _rescale(v, logs)
    final = torch.einsum("ce,cxyz,exyz->", v, la, lb.conj())
    return logs + torch.log(torch.abs(final) + _TINY)


def _chain_overlap(a, b) -> torch.Tensor:
    """The one dispatch for chain overlaps: the sweep kernels inside their
    gate, the direct scan outside it."""
    if fused_chain_supported(a) and fused_chain_supported(b):
        return fused_chain_log_overlap(a, b)
    return _chain_log_overlap(a, b)


def _is_chain(graph: CircuitGraph) -> bool:
    return graph.ncores >= 2 and is_mps_chain(graph)


def network_log_fidelity(graph: CircuitGraph, params, target_params) -> torch.Tensor:
    """log F between two same-graph MPS-chain networks, float32-safe at any
    depth."""
    if not _is_chain(graph):
        raise NotImplementedError(_NON_CHAIN)
    p = _normalize(params)
    t = _normalize(target_params)
    pc, tc = _chain_cores(graph, p), _chain_cores(graph, t)
    if pc is None or tc is None:
        raise NotImplementedError(
            "chains with non-uniform bonds go through ops/pairwise.py in "
            "JAX (ROADMAP queue A, item 7b)"
        )
    log_ov = _chain_overlap(pc, tc)
    log_oo = _chain_overlap(pc, pc)
    log_tt = _chain_overlap(tc, tc)
    return 2.0 * log_ov - log_oo - log_tt


def network_fidelity(graph: CircuitGraph, params, target_params) -> torch.Tensor:
    """Fidelity between two same-graph networks via overlaps only."""
    return torch.exp(network_log_fidelity(graph, params, target_params))


def make_masked_network_fidelity_fit(
    graph: CircuitGraph,
    optimizer: GradientTransformation,
    max_steps: int,
    tol: float = 1e-3,
    dtype: torch.dtype = torch.complex64,
    complex_as_real: bool = False,
    jit_scope: str = "fit",
    sync_every: int = 1,
    mesh=None,
    identities=None,
    matmul_precision: str = "highest",
    device: DeviceLike = "cuda",
) -> Callable:
    """Build ``fit(params, mask, target_params, target_mask) -> FitResult``.

    Both the candidate and the target are masked full-graph networks
    (identity-core substitution); the loss is −log F, minimised until
    ``1 − F < tol`` or ``max_steps``.  ``jit_scope`` keeps the JAX names and
    selects the driver: 'fit' tests the exit before every step, 'step'
    every ``sync_every`` steps, 'chunk' after whole ``sync_every``-step
    chunks (see ``_fit_driver``).  ``identities`` overrides the substitution
    cores (MPS experiments pass ``transparent_cores(..., pairing='kind')``).
    ``matmul_precision`` ('highest' default: full f32, TF32 off; 'high' /
    'default') holds within the fit only.  ``device``: where the
    substitution cores live — the params and targets handed to ``fit`` must
    be there too.
    """
    if complex_as_real:
        raise NotImplementedError(
            "complex_as_real needs ops/complex_pair.py and "
            "optim/pair_stiefel.py (ROADMAP queue A, item 7c)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "bond-sliced multi-device overlaps need parallel/mp.py "
            "(ROADMAP queue A, item 11)"
        )
    mid_shapes = {c.shape for c in graph.cores[1:-1]}
    bonds = {graph.cores[0].shape[-1], graph.cores[-1].shape[0]}
    for s in mid_shapes:
        bonds |= {s[0], s[-1]}
    if not (_is_chain(graph) and len(mid_shapes) <= 1 and len(bonds) == 1):
        raise NotImplementedError(_NON_CHAIN)
    if jit_scope not in ("fit", "step", "chunk"):
        raise ValueError(
            f"jit_scope must be 'fit', 'step' or 'chunk', got {jit_scope!r}"
        )
    dev = resolve_device(device)
    idents_np = identities if identities is not None else identity_cores(graph, dtype)
    idents = {k: torch.as_tensor(np.asarray(v)).to(device=dev, dtype=dtype)
              for k, v in idents_np.items()}
    names = graph.core_names
    # exit when log F > log(1 - tol), tested in float32 as in JAX
    neg_log_tol = np.float32(-float(np.log1p(-tol)))

    def log_abs_overlap(a, b):
        """log |⟨A, B⟩| on already-normalised core dicts.  Unlike JAX, whose
        masked fit always runs the einsum scan, this goes through the same
        dispatch as ``network_log_fidelity``, so the fits run the sweep
        kernels too; parity is still held against JAX's scan."""
        return _chain_overlap(_chain_cores(graph, a), _chain_cores(graph, b))

    def neg_log_f(params, mask, target_eff_n, log_tt):
        eff = _normalize(masked_cores(params, mask, idents, names, dtype))
        return -(2.0 * log_abs_overlap(eff, target_eff_n)
                 - log_abs_overlap(eff, eff) - log_tt)

    def prepare(target_params, target_mask):
        """Loop-invariant target quantities, computed once per fit."""
        with torch.no_grad(), _precision(matmul_precision):
            target_eff_n = _normalize(masked_cores(target_params, target_mask, idents,
                                                   names, dtype))
            return target_eff_n, log_abs_overlap(target_eff_n, target_eff_n)

    def _step(params, opt_state, mask, target_eff_n, log_tt):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        nlf = neg_log_f(leaves, mask, target_eff_n, log_tt)
        grads = dict(zip(leaves, torch.autograd.grad(nlf, list(leaves.values()))))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = {k: params[k] + updates[k] for k in params}
        return params, opt_state, nlf.detach()

    drivers = FitDrivers(
        _step, optimizer, max_steps, sync_every,
        running=lambda nlf: nlf > neg_log_tol, init_metric=1e9,
        matmul_precision=matmul_precision,
    )
    run = {"fit": drivers.fit_while, "step": drivers.fit_host,
           "chunk": drivers.fit_chunked}[jit_scope]

    def fit(params, mask, target_params, target_mask) -> FitResult:
        target_eff_n, log_tt = prepare(target_params, target_mask)
        p, o, steps, nlf = run(params, mask, target_eff_n, log_tt)
        # 1 - F from the exit-triggering -log F (pre-final-step)
        return FitResult(p, -torch.expm1(-nlf), steps, o)

    fit.scope = jit_scope
    return fit
