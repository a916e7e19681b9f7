"""Network-space fidelity fitting: no dense target tensor, log-space math.

Counterpart of ``tneq_tpu/train/network_fit.py``.  The fidelity of two
same-graph networks,

    log F = 2·log|⟨t,o⟩| − log⟨o,o⟩ − log⟨t,t⟩,

is computed from network-network overlaps on max-abs-normalised cores, each
overlap contracted with a max-abs rescale per step (detached scales keep
the LOG gradient exact), so it stays finite in float32 at any depth:

- an MPS chain of uniform bond runs a transfer sweep: through the sweep
  kernels inside ``ops.chain_overlap.fused_chain_supported`` (real
  float32, S = bond² <= 1024), as the direct einsum scan
  :func:`_chain_log_overlap` outside it;
- a layered 2-local circuit (the brick wall, wall_col, a chain of uneven
  bonds) runs the row sweep of ``ops/row_scan.py``;
- any other graph (trees, the one-core chain) runs the rescaled pairwise
  executor of ``ops/pairwise.py``.

The masked fit's stacked-real pair form (``complex_as_real=True``) takes
neither sweep, as in JAX: its overlaps run the pair twin of the rescaled
executor (``ops/complex_pair.make_pair_log_abs_overlap_fn``).  With a mesh
whose ``model`` axis is > 1, every overlap is bond-sliced over that axis
(``parallel/mp.make_sliced_log_overlap_fn``) and the chain sweep is off,
as in JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..graph.dsl import CircuitGraph
from ..ops.chain_overlap import fused_chain_log_overlap, fused_chain_supported
from ..ops.complex_pair import make_pair_log_abs_overlap_fn
from ..ops.mps_sweep import is_mps_chain
from ..ops.pairwise import _TINY, _rescale, make_log_abs_overlap_fn
from ..ops.row_scan import make_row_scan_log_overlap_fn, supports_row_scan
from ..ops.scaling import auto_scale
from ..optim.stiefel import GradientTransformation
from ..utils.device import DeviceLike, resolve_device
from ..utils.device import matmul_precision as _precision
from ..utils.profiling import annotate
from ._fit_driver import FitDrivers
from .fit import FitResult, functional_step, identity_cores, masked_cores, pair_identity_cores

__all__ = [
    "make_masked_network_fidelity_fit",
    "network_fidelity",
    "network_log_fidelity",
]


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
    v, logs = _rescale(v)
    if ma is not None:
        for A, B in zip(ma, mb):
            v = torch.einsum("ce,cxyf->exyf", v, A)
            v = torch.einsum("exyf,exyg->fg", v, B.conj())
            v, logs = _rescale(v, logs)
    final = torch.einsum("ce,cxyz,exyz->", v, la, lb.conj())
    return logs + torch.log(torch.abs(final) + _TINY)


def _chain_log_overlap_batched(pairs) -> torch.Tensor:
    """log |⟨A_k, B_k⟩| for several same-shape chain pairs in one batched
    transfer scan (returns ``[len(pairs)]``): the math of
    :func:`_chain_log_overlap` with a leading batch axis, each pair
    rescaled by its own detached max-abs per site.  No fit calls it; the
    probe ``bench/chain_variants.py`` times it against separate scans."""
    fa = torch.stack([a[0] for a, _ in pairs])
    fb = torch.stack([b[0] for _, b in pairs])
    la = torch.stack([a[2] for a, _ in pairs])
    lb = torch.stack([b[2] for _, b in pairs])

    def rescale(v, logs):
        s = v.detach().abs().amax(dim=(1, 2), keepdim=True) + _TINY
        return v / s, logs + torch.log(s[:, 0, 0])

    v = torch.einsum("bxiyc,bxiye->bce", fa, fb.conj())
    v, logs = rescale(v, torch.zeros(len(pairs), dtype=v.real.dtype, device=v.device))
    if pairs[0][0][1] is not None:
        ma = torch.stack([a[1] for a, _ in pairs], dim=1)  # [n, b, ...]
        mb = torch.stack([b[1] for _, b in pairs], dim=1)
        for A, B in zip(ma, mb):
            v = torch.einsum("bce,bcxyf->bexyf", v, A)
            v = torch.einsum("bexyf,bexyg->bfg", v, B.conj())
            v, logs = rescale(v, logs)
    final = torch.einsum("bce,bcxyz,bexyz->b", v, la, lb.conj())
    return logs + torch.log(torch.abs(final) + _TINY)


def _chain_overlap(a, b) -> torch.Tensor:
    """The one dispatch for chain overlaps: the sweep kernels inside their
    gate, the direct scan outside it."""
    if fused_chain_supported(a) and fused_chain_supported(b):
        return fused_chain_log_overlap(a, b)
    return _chain_log_overlap(a, b)


def _is_chain(graph: CircuitGraph) -> bool:
    return graph.ncores >= 2 and is_mps_chain(graph)


def _overlap_fn(graph: CircuitGraph):
    """log|⟨A,B⟩| function for graphs off the chain path: the row sweep for
    layered 2-local circuits, the rescaled pairwise executor otherwise."""
    if supports_row_scan(graph):
        return make_row_scan_log_overlap_fn(graph)
    return make_log_abs_overlap_fn(graph)


def network_log_fidelity(graph: CircuitGraph, params, target_params) -> torch.Tensor:
    """log F between two same-graph networks, float32-safe at any depth."""
    p = _normalize(params)
    t = _normalize(target_params)
    if _is_chain(graph):
        pc, tc = _chain_cores(graph, p), _chain_cores(graph, t)
        if pc is not None and tc is not None:
            log_ov = _chain_overlap(pc, tc)
            log_oo = _chain_overlap(pc, pc)
            log_tt = _chain_overlap(tc, tc)
            return 2.0 * log_ov - log_oo - log_tt
    log_abs_overlap = _overlap_fn(graph)
    log_ov = log_abs_overlap(p, t)
    log_oo = log_abs_overlap(p, p)
    log_tt = log_abs_overlap(t, t)
    return 2.0 * log_ov - log_oo - log_tt


def network_fidelity(graph: CircuitGraph, params, target_params,
                     target_norm=None) -> torch.Tensor:
    """Fidelity between two same-graph networks via overlaps only.
    ``target_norm`` is accepted and ignored, as in JAX."""
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
    model_axis: str = "model",
    slice_bonds=None,
    identities=None,
    matmul_precision: str = "highest",
    device: DeviceLike = "cuda",
) -> Callable:
    """Build ``fit(params, mask, target_params, target_mask) -> FitResult``.

    Both the candidate and the target are masked full-graph networks
    (identity-core substitution); the loss is −log F, minimised until
    ``1 − F < tol`` or ``max_steps``.  The overlaps contract as in
    :func:`network_log_fidelity`: a chain of uniform bond by the transfer
    sweep, a layered 2-local circuit by the row sweep, any other graph by
    the rescaled pairwise executor.  ``complex_as_real``: params and target
    are stacked-real pairs and every overlap runs the pair executor (pass a
    pair optimizer).  ``jit_scope`` keeps the JAX names and selects the
    driver: 'fit' tests the exit before every step, 'step' every
    ``sync_every`` steps, 'chunk' after whole ``sync_every``-step chunks
    (see ``_fit_driver``).  ``identities`` overrides the substitution cores
    (MPS experiments pass ``transparent_cores(..., pairing='kind')``).
    ``mesh`` (``parallel.make_mesh``) with a ``model_axis`` > 1 bond-slices
    every overlap, ``prepare``'s ⟨t,t⟩ included, over that axis;
    ``slice_bonds`` overrides the bond choice.  Across ``torch.distributed``
    ranks (one per position) the step sums the parameter gradients over the
    ranks before the update, and every rank's optimizer must be seeded
    alike (the SGD-G retraction draws), so the replicas stay equal.
    ``matmul_precision`` ('highest' default: full f32, TF32 off; 'high' /
    'default') holds within the fit only.  ``device``: where the
    substitution cores live — the params and targets handed to ``fit`` must
    be there too.

    ``fit.batched(params, masks, target_params, target_mask,
    chunk_steps=0)`` runs one lane per row of ``masks`` in lockstep from
    ``params``, the target prepared once and shared by the lanes; across
    ranks too, the combine and the gradient sum reducing the lane-batched
    tensors whole (an all-reduce commutes with the lane axis).
    """
    use_mesh = mesh is not None and mesh.shape[model_axis] > 1
    mid_shapes = {c.shape for c in graph.cores[1:-1]}
    bonds = {graph.cores[0].shape[-1], graph.cores[-1].shape[0]}
    for s in mid_shapes:
        bonds |= {s[0], s[-1]}
    use_chain = (not complex_as_real and not use_mesh and _is_chain(graph)
                 and len(mid_shapes) <= 1 and len(bonds) == 1)
    reduce_grads = None
    if use_mesh:
        # imported here: parallel/mp imports train/losses, whose package
        # imports this module
        from ..parallel.mp import make_sliced_log_overlap_fn

        generic_overlap = make_sliced_log_overlap_fn(graph, mesh, slice_bonds, model_axis,
                                                     pair=complex_as_real)
        reduce_grads = generic_overlap.reduce_gradients if generic_overlap.ranks else None
    elif complex_as_real:
        generic_overlap = make_pair_log_abs_overlap_fn(graph)
    else:
        generic_overlap = None if use_chain else _overlap_fn(graph)
    if jit_scope not in ("fit", "step", "chunk"):
        raise ValueError(
            f"jit_scope must be 'fit', 'step' or 'chunk', got {jit_scope!r}"
        )
    dev = resolve_device(device)
    cast = torch.float32 if complex_as_real else dtype
    if identities is not None:
        idents_np = identities
    else:
        idents_np = pair_identity_cores(graph) if complex_as_real else identity_cores(graph, dtype)
    idents = {k: torch.as_tensor(np.asarray(v)).to(device=dev, dtype=cast)
              for k, v in idents_np.items()}
    names = graph.core_names
    # exit when log F > log(1 - tol), tested in float32 as in JAX
    neg_log_tol = np.float32(-float(np.log1p(-tol)))

    def log_abs_overlap(a, b):
        """log |⟨A, B⟩| on already-normalised core dicts.  On chains, unlike
        JAX, whose masked fit always runs the einsum scan, this goes through
        the same dispatch as ``network_log_fidelity``, so the fits run the
        sweep kernels too; parity is still held against JAX's scan."""
        if use_chain:
            return _chain_overlap(_chain_cores(graph, a), _chain_cores(graph, b))
        return generic_overlap(a, b)

    def neg_log_f(params, mask, target_eff_n, log_tt):
        with annotate("loss.mask"):
            eff = _normalize(masked_cores(params, mask, idents, names, cast))
        nlf = -(2.0 * log_abs_overlap(eff, target_eff_n)
                - log_abs_overlap(eff, eff) - log_tt)
        return nlf, nlf

    def prepare(target_params, target_mask):
        """Loop-invariant target quantities, computed once per fit."""
        with annotate("fit.prepare"), torch.no_grad(), _precision(matmul_precision):
            with annotate("loss.mask"):
                target_eff_n = _normalize(masked_cores(target_params, target_mask, idents,
                                                       names, cast))
            return target_eff_n, log_abs_overlap(target_eff_n, target_eff_n)

    drivers = FitDrivers(
        functional_step(neg_log_f, optimizer, reduce_grads), optimizer, max_steps, sync_every,
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

    def batched(params, masks, target_params, target_mask, chunk_steps: int = 0) -> FitResult:
        """Lockstep lanes over mask rows (see ``FitDrivers.batched``); the
        target is prepared once and shared by the lanes."""
        with annotate("fit.batched"):
            target_eff_n, log_tt = prepare(target_params, target_mask)
            p_b, o_b, steps, nlf_b = drivers.batched(params, masks, target_eff_n, log_tt,
                                                     chunk_steps=chunk_steps)
            return FitResult(p_b, -torch.expm1(-nlf_b), steps, o_b)

    fit.batched = batched
    fit.scope = jit_scope
    # one update, and the prepared target it takes, for measuring a step alone
    fit.drivers = drivers
    fit.prepare = prepare
    # JAX's introspection hooks of the chunk scope (bench/chunk_probe.py,
    # bench/flagship.py): a k-step chunk sharing one prepared target
    fit.chunk = drivers.chunk
    fit.make_opt_state = optimizer.init
    return fit
