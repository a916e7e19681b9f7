"""Fused MPS-chain two-network overlap: one kernel launch per sweep.

Counterpart of ``tneq_tpu/ops/chain_overlap.py``.  The chain log-overlap of
``train/network_fit.py`` is restructured in two parts:

1. **M-form precompute** (:func:`chain_pair_to_mv`, one batched einsum with
   autograd): fold each site's core pair into a transfer matrix
   ``M_i[ce, fg] = sum_xy A_i[c,x,y,f] * conj(B_i)[e,x,y,g]`` (S = bond²).
2. **The sweep** ``log |v0 . (prod_i M_i) . w|`` with per-site max-abs
   rescaling, as the hand-written Hopper kernels of ``csrc/chain_sweep.cu``:
   B1 (forward: prefix stack, scales, f = u_n . w, sum log s_i) and B2 (the
   exact VJP with the scales held constant, dM fused), wrapped as the
   ``torch.autograd.Function`` behind :func:`mv_chain_log_overlap_cuda`.
   Each sweep runs as one thread-block cluster that prefetches M through
   shared memory and exchanges the carry over distributed shared memory;
   its launch parameters come from :func:`sweep_plan`.  Under
   ``torch.func.vmap`` (the batched prune's lanes) the Functions' vmap
   rules run every lane's sweep in ONE launch, a cluster per lane.

Each kernel has a plain PyTorch version beside it (:func:`_sweep_fwd_plain`,
:func:`_sweep_bwd_plain`) with the same outputs.  The dispatch sends a CPU
tensor to the plain version and a CUDA tensor to the kernel; a CUDA tensor
launches the kernel or raises — nothing falls back.

Why the kernel is the port's default although JAX made its Pallas sweep
opt-in (``TNEQ_CHAIN_PALLAS=1``): XLA compiles the whole JAX scan into one
program, while eager PyTorch pays about seven small launches per site
(matmul, abs, max, add, div, log, accumulate) — the fused sweep is one
launch per overlap.  :func:`fused_chain_supported` keeps JAX's gate minus
the TPU tiling rule (S % 128): real float32 cores, stacked middles, uniform
bonds, S <= 1024.  Outside the gate (complex, non-uniform bonds, the D >= 32
chains with S > 1024, chains without middle cores) callers use the direct
scan ``train/network_fit._chain_log_overlap``, as JAX does.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Tuple

import torch

from . import cuda_build
from .pairwise import _TINY, _rescale

__all__ = [
    "chain_pair_to_mv",
    "mv_chain_log_overlap",
    "mv_chain_log_overlap_cuda",
    "fused_chain_log_overlap",
    "fused_chain_supported",
    "launch_counts",
    "reset_launch_counts",
    "sweep_plan",
]

MAX_S = 1024  # JAX's cap (chain_overlap.py:340-341); the kernels take any S up to it

# The sweep kernels' launch plan (csrc/chain_sweep.cu, which checks it)
THREADS = 256  # threads per CTA (kThreads)
MAX_CLUSTER = 16  # CTAs in a cluster where the card schedules it (non-portable)
PORTABLE_CLUSTER = 8  # the portable limit, used where 16 is not schedulable
SMEM_MAX = 232448  # shared memory one CTA may use on an H100
MAX_STAGES = 16  # ring stages (kMaxStages)
MIN_STRIP_WORK = 4096  # floats of M a CTA takes per site, at least
MAX_STRIP = 128  # the widest strip a CTA takes (kMaxStrip)
SMS = 132  # streaming multiprocessors of an H100 SXM: one CTA each
BAR_FLOATS = 8  # the mbarriers at the head of shared memory (kBarFloats)

# launches of each kernel, counted by the wrappers where they launch
_LAUNCHES: Dict[str, int] = {"chain_sweep_fwd": 0, "chain_sweep_bwd": 0}
_LAUNCH_LOCK = threading.Lock()  # farm workers launch from several threads


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1


def chain_pair_to_mv(a, b):
    """Fold two ``(first, mids, last)`` chain-core triples into
    ``(v0 [S], M [n, S, S] | None, w [S])`` with ``S = bond**2``.

    Axis convention as ``train/network_fit.py``: first ``[x,i,y,c]``,
    middle ``[c,x,y,f]``, last ``[c,x,y,z]``; the bra side is conjugated.
    """
    (fa, ma, la), (fb, mb, lb) = a, b
    v0 = torch.einsum("xiyc,xiye->ce", fa, fb.conj()).reshape(-1)
    w = torch.einsum("cxyz,exyz->ce", la, lb.conj()).reshape(-1)
    if ma is None:
        return v0, None, w
    n, c, f = ma.shape[0], ma.shape[1], ma.shape[-1]
    m = torch.einsum("icxyf,iexyg->icefg", ma, mb.conj())
    return v0, m.reshape(n, c * c, f * f), w


def mv_chain_log_overlap(v0, M, w) -> torch.Tensor:
    """Plain PyTorch sweep of the M-form: ``log |v0 . (prod_i M_i) . w|``
    with per-site max-abs rescaling (detached scales), differentiable by
    autograd; any dtype."""
    v, logs = _rescale(v0)
    if M is not None:
        for Mi in M:
            v, logs = _rescale(v @ Mi, logs)
    # w already carries the bra conjugation (chain_pair_to_mv)
    return logs + torch.log(torch.abs(torch.sum(v * w)) + _TINY)


# ---------------------------------------------------------------------------
# B1 / B2: plain versions, kernel wrappers, dispatch
# ---------------------------------------------------------------------------
#
# Every function below takes a sweep with or without leading lane axes
# (u0 [..., S], M [..., n, S, S], w [..., S]): the lanes are independent
# sweeps.  The vmap rules of the autograd Functions put torch.func.vmap's
# lanes there, so on the card a lane-batched sweep is ONE launch, with one
# cluster per lane.


def _sweep_fwd_plain(u0, M, w):
    """B1's function in plain PyTorch: ``-> (ustack [..., n, S], scales
    [..., n], f [...], logsum [...], ulast [..., S])``."""
    n = M.shape[-3]
    ustack = torch.empty(M.shape[:-1], dtype=u0.dtype, device=u0.device)
    scales = torch.empty(M.shape[:-2], dtype=u0.dtype, device=u0.device)
    v = u0
    logsum = torch.zeros(u0.shape[:-1], dtype=u0.dtype, device=u0.device)
    for i in range(n):
        ustack[..., i, :] = v
        raw = (v.unsqueeze(-2) @ M[..., i, :, :]).squeeze(-2)
        s = raw.abs().amax(dim=-1) + _TINY
        v = raw / s.unsqueeze(-1)
        scales[..., i] = s
        logsum = logsum + torch.log(s)
    return ustack, scales, torch.sum(v * w, dim=-1), logsum, v


def _sweep_bwd_plain(r0, M, ustack, scales):
    """B2's function in plain PyTorch: ``-> (dM [..., n, S, S], du0 [..., S])``."""
    dM = torch.empty_like(M)
    r = r0
    for i in reversed(range(M.shape[-3])):
        draw = r / scales[..., i, None]
        dM[..., i, :, :] = ustack[..., i, :, None] * draw.unsqueeze(-2)
        r = (M[..., i, :, :] @ draw.unsqueeze(-1)).squeeze(-1)
    return dM, r


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sweep_shapes(M: torch.Tensor) -> Tuple[Tuple[int, ...], int, int, int]:
    """``(lanes shape, lanes, n, S)`` of ``M [..., n, S, S]``."""
    if M.dim() < 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"M must be [..., n, S, S], got {tuple(M.shape)}")
    lead = tuple(int(d) for d in M.shape[:-3])
    n, S = int(M.shape[-3]), int(M.shape[-1])
    lanes = math.prod(lead)
    if n < 1 or not 1 <= S <= MAX_S:
        raise ValueError(f"the sweep kernels take n >= 1 and 1 <= S <= {MAX_S}, got n={n}, S={S}")
    if lanes < 1:
        raise ValueError(f"the sweep kernels take at least one lane, got {lead}")
    return lead, lanes, n, S


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_pitch(strip: int) -> int:
    """B1's ring tile row pitch in floats: the strip rounded up to float4s,
    made an odd number of float4s so that a warp's float4 reads of 8
    consecutive rows fall in 8 different bank groups (``tile_pitch`` in
    ``csrc/chain_sweep.cu``)."""
    quads = _ceil(strip, 4)
    return 4 * (quads if quads % 2 else quads + 1)


def sweep_plan(n: int, S: int, backward: bool = False,
               max_cluster: int = MAX_CLUSTER,
               lanes: int = 1) -> Tuple[int, int, int, int, int]:
    """``(cluster, strip, ring_stages, tile_rows, smem_bytes)`` of one B1
    (``backward=False``) or B2 launch, decided by shape, lane count and the
    card's cluster limit alone.

    Each of the ``lanes`` sweeps of a launch is one cluster of ``cluster``
    CTAs that walks the n sites; CTA c owns the strip ``[c*strip,
    (c+1)*strip)`` of every M_i: columns for B1, rows for B2.  A CTA holds
    an SM (its shared memory), so the cluster halves while ``lanes``
    clusters would outgrow the card's :data:`SMS` SMs, but not below the
    :data:`MAX_STRIP` width a CTA takes (past that the lanes run in
    waves).  The strip gives each CTA at least :data:`MIN_STRIP_WORK`
    floats per site (small S runs as fewer CTAs, S <= 64 as one), is a
    multiple of 4 where S is (16-byte copies), and no CTA is left empty;
    the last strip may be ragged.  A CTA's share of a site is cut into as
    few tiles of ``tile_rows`` rows as leave room for two of them (a row is
    :func:`tile_pitch` floats for B1; ``S`` for B2, whose stage also
    carries the tile's entries of ustack): each tile costs the sweep's
    critical path a fixed latency.  The tiles are prefetched through a ring
    of ``ring_stages`` of them that fills the shared memory left by the
    exchange buffers, never past the n sites' tiles."""
    if n < 1 or not 1 <= S <= MAX_S:
        raise ValueError(f"the sweep kernels take n >= 1 and 1 <= S <= {MAX_S}, got n={n}, S={S}")
    if not 1 <= max_cluster <= MAX_CLUSTER:
        raise ValueError(f"max_cluster must be in [1, {MAX_CLUSTER}], got {max_cluster}")
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    least = _ceil(S, MAX_STRIP)
    while lanes * max_cluster > SMS and max_cluster // 2 >= least:
        max_cluster //= 2
    strip = min(S, max(_ceil(S, max_cluster), _ceil(MIN_STRIP_WORK, S)))
    if S % 4 == 0:
        strip = 4 * _ceil(strip, 4)
    cluster = _ceil(S, strip)
    if backward:  # mbarriers, ring, draws [3][S]
        row, rows_per_site, fixed = S, strip, BAR_FLOATS + 3 * S
    else:  # mbarriers, ring, exchange [2][S]
        row, rows_per_site, fixed = tile_pitch(strip), S, BAR_FLOATS + 2 * S
    budget = SMEM_MAX // 4 - fixed

    def stage_floats(rows: int) -> int:
        return rows * row + (4 * _ceil(rows, 4) if backward else 0)

    tiles_per_site = 1
    while 2 * stage_floats(_ceil(rows_per_site, tiles_per_site)) > budget:
        tiles_per_site += 1
    tile_rows = _ceil(rows_per_site, tiles_per_site)
    stages = min(MAX_STAGES, n * tiles_per_site, budget // stage_floats(tile_rows))
    return cluster, strip, stages, tile_rows, 4 * (stages * stage_floats(tile_rows) + fixed)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# the C entry points' parameters; each returns a CUDA error code (int)
_SIGNATURES = {
    # device, lanes, out
    "tneq_chain_sweep_max_cluster": [_I, _I, ctypes.POINTER(_I)],
    # device, u0, M, w, lanes, n, S, plan (5), ustack, scales, f, logsum, ulast, stream
    "tneq_chain_sweep_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _Z,
                             _P, _P, _P, _P, _P, _P],
    # device, r0, M, ustack, scales, lanes, n, S, plan (5), dM, du0, stream
    "tneq_chain_sweep_bwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _Z,
                             _P, _P, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The chain-sweep library with its C signatures declared."""
    lib = cuda_build.library("chain_sweep")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


@functools.cache
def _max_cluster(device_index: int, lanes: int = 1) -> int:
    """16 where the card can hold ``lanes`` clusters of 16 CTAs at once at
    the most shared memory a plan asks for, else the portable 8 (asked once
    per card and lane count)."""
    out = ctypes.c_int(0)
    err = _lib().tneq_chain_sweep_max_cluster(device_index, lanes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"chain_sweep cluster query failed: CUDA error {err}")
    return out.value


def _plan_for(M: torch.Tensor, backward: bool) -> Tuple[int, int, int, int, int]:
    _, lanes, n, S = _sweep_shapes(M)
    return sweep_plan(n, S, backward, _max_cluster(M.device.index, lanes), lanes)


def _sweep_fwd_cuda(u0, M, w):
    """Launch B1 (``csrc/chain_sweep.cu``) once for all lanes; same outputs
    as the plain version."""
    lead, lanes, n, S = _sweep_shapes(M)
    dev = M.device
    _check("u0", u0, lead + (S,), dev)
    _check("M", M, lead + (n, S, S), dev)
    _check("w", w, lead + (S,), dev)
    plan = _plan_for(M, backward=False)
    ustack = torch.empty(lead + (n, S), dtype=torch.float32, device=dev)
    scales = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    f = torch.empty(lead, dtype=torch.float32, device=dev)
    logsum = torch.empty(lead, dtype=torch.float32, device=dev)
    ulast = torch.empty(lead + (S,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().tneq_chain_sweep_fwd(
        dev.index, _ptr(u0), _ptr(M), _ptr(w), lanes, n, S, *plan, _ptr(ustack),
        _ptr(scales), _ptr(f), _ptr(logsum), _ptr(ulast),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"chain_sweep_fwd (B1) launch failed: CUDA error {err}")
    _count_launch("chain_sweep_fwd")
    return ustack, scales, f, logsum, ulast


def _sweep_bwd_cuda(r0, M, ustack, scales):
    """Launch B2 (reverse sweep with the outer products fused) once for all
    lanes; same outputs as the plain version."""
    lead, lanes, n, S = _sweep_shapes(M)
    dev = M.device
    _check("r0", r0, lead + (S,), dev)
    _check("M", M, lead + (n, S, S), dev)
    _check("ustack", ustack, lead + (n, S), dev)
    _check("scales", scales, lead + (n,), dev)
    plan = _plan_for(M, backward=True)
    dM = torch.empty(lead + (n, S, S), dtype=torch.float32, device=dev)
    du0 = torch.empty(lead + (S,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().tneq_chain_sweep_bwd(
        dev.index, _ptr(r0), _ptr(M), _ptr(ustack), _ptr(scales), lanes, n, S, *plan,
        _ptr(dM), _ptr(du0), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"chain_sweep_bwd (B2) launch failed: CUDA error {err}")
    _count_launch("chain_sweep_bwd")
    return dM, du0


def _route(M: torch.Tensor, plain, kernel):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if M.device.type == "cpu":
        return plain
    if M.device.type == "cuda":
        return kernel
    raise ValueError(f"no chain-sweep path for device {M.device}")


def _lanes_first(batch_size: int, in_dims, args):
    """torch.func.vmap's lane axis of each argument moved to the front (an
    unbatched argument expanded), contiguous for the kernel."""
    out = []
    for x, d in zip(args, in_dims):
        x = x.expand((batch_size,) + tuple(x.shape)) if d is None else x.movedim(d, 0)
        out.append(x.contiguous())
    return out


class _ChainSweep(torch.autograd.Function):
    """``(u0, M, w) -> (f, logsum, ustack, scales, ulast)``: forward = B1,
    backward = B2 (:class:`_ChainSweepBwd`) with ``dw = df * u_n``.  Only
    ``f`` is differentiable: the scales are constants (exact for the LOG
    overlap, as ``sweep_bwd`` treats them), and ustack, scales and ulast
    are B1's stored values, returned for the backward.  Its vmap rule runs
    all lanes of a ``torch.func.vmap`` as one sweep with a lane axis."""

    @staticmethod
    def forward(u0, M, w):
        ustack, scales, f, logsum, ulast = _route(M, _sweep_fwd_plain, _sweep_fwd_cuda)(u0, M, w)
        return f, logsum, ustack, scales, ulast

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, M, w = inputs
        _, logsum, ustack, scales, ulast = output
        ctx.save_for_backward(M, w, ustack, scales, ulast)
        ctx.mark_non_differentiable(logsum, ustack, scales, ulast)

    @staticmethod
    def backward(ctx, df, *_):
        M, w, ustack, scales, ulast = ctx.saved_tensors
        du0 = dM = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dM, du0 = _ChainSweepBwd.apply((df.unsqueeze(-1) * w).contiguous(), M, ustack,
                                           scales)
        if ctx.needs_input_grad[2]:
            dw = df.unsqueeze(-1) * ulast
        return du0, dM, dw

    @staticmethod
    def vmap(info, in_dims, u0, M, w):
        return _ChainSweep.apply(*_lanes_first(info.batch_size, in_dims, (u0, M, w))), (0,) * 5


class _ChainSweepBwd(torch.autograd.Function):
    """``(r0, M, ustack, scales) -> (dM, du0)``: B2, the VJP of
    :class:`_ChainSweep`, with the same lane axes and vmap rule; it has no
    derivative of its own."""

    @staticmethod
    def forward(r0, M, ustack, scales):
        return _route(M, _sweep_bwd_plain, _sweep_bwd_cuda)(r0, M, ustack, scales)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError("the chain sweep's backward (B2) is not differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _ChainSweepBwd.apply(*_lanes_first(info.batch_size, in_dims, args)), (0, 0)


def mv_chain_log_overlap_cuda(v0, M, w) -> torch.Tensor:
    """``log |v0 . (prod M_i) . w|`` through the B1/B2 kernels (float32,
    differentiable); matches :func:`mv_chain_log_overlap` to f32 rounding.
    The s0 pre-scale stays outside the kernel, as in JAX.  Under
    ``torch.func.vmap`` every lane's sweep runs in one launch."""
    if M is None:
        return mv_chain_log_overlap(v0, M, w)
    s0 = (v0.abs().max() + _TINY).detach()
    f, logsum = _ChainSweep.apply((v0 / s0).contiguous(), M.contiguous(), w.contiguous())[:2]
    return torch.log(s0) + logsum + torch.log(torch.abs(f) + _TINY)


def fused_chain_supported(a) -> bool:
    """True when the ``(first, mids, last)`` triple takes the kernel path:
    real float32 cores, stacked middles present, uniform bonds (square
    per-site transfer matrices whose S matches the boundary vectors) and
    S = bond² <= 1024.  Decided by dtype and shape alone."""
    first, mids, last = a
    if mids is None:
        return False
    if any(x.dtype != torch.float32 for x in (first, mids, last)):
        return False
    if mids.shape[1] != mids.shape[-1]:
        return False
    if first.shape[-1] != mids.shape[1] or last.shape[0] != mids.shape[1]:
        return False
    return mids.shape[1] * mids.shape[1] <= MAX_S


def fused_chain_log_overlap(a, b) -> torch.Tensor:
    """M-form chain overlap of two core triples through the sweep kernels."""
    v0, M, w = chain_pair_to_mv(a, b)
    return mv_chain_log_overlap_cuda(v0, M, w)
