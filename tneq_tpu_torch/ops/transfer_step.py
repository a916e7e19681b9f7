"""The MPS transfer sweep of the Born-rule contraction: kernels B3 (float32)
and B4 (complex64).

Counterpart of ``tneq_tpu/ops/pallas_kernels.py``.  One step contracts the
boundary environment with one middle core and its measurement operators::

    out[z,c,d] = sum env[z,a,b] * A[a,k,c] * bra(A)[b,l,d] * Mx[z,k,l]

with ``bra(A) = A`` (B3) or ``conj(A)`` (B4, the Born-rule bra).  A sweep
runs the steps of a stack of cores ``A [n, Da, K, Dc]`` and operators
``Mx [n, B, K, K]`` from ``env0 [B, Da, Da]``; on a CUDA tensor the whole
sweep is ONE launch of a hand-written Hopper kernel of
``csrc/transfer_step.cu``, on a CPU tensor the plain PyTorch version
(:func:`transfer_sweep_plain`, :func:`transfer_sweep_complex_plain`), which
loops over the same factorised step.  A CUDA tensor launches the kernel or
raises: nothing falls back.

:func:`kernel_plan` picks the kernel's route from shape and dtype: the
narrow route (one block per group of entries, CUDA cores) at the Born-rule
widths, bonds below 32; the wide route (a thread-block cluster per group of
entries, its env split over the cluster's shared memory, products on the
tensor cores in 3xTF32) from bond 32 and wherever the narrow one does not
fit.  Together they take float32 and complex64 at every bond up to 256 and
physical rank up to 64, at any batch and number of sites.

:func:`transfer_sweep` and :func:`transfer_sweep_complex` are
``torch.autograd.Function``\\ s returning the last env.  Their backward runs
the ``d_env`` chain as one more launch of the same kernel (the sites in
reverse, on the transposed cores, as JAX's custom VJP does per step,
``pallas_kernels.py:231-262``), and ``d_a``/``d_mx`` of all sites as a few
batched pairwise contractions over the stack.  The complex backward is
derived for torch's convention (the gradient of a real loss is the
conjugate of ``jax.grad``'s)::

    d_env = B4(g, conj(A).permute(2,1,0), conj(Mx))
    d_A   = sum conj(env) A conj(Mx) g  +  sum env A Mx conj(g)
    d_Mx  = sum conj(env) conj(A) A g

and is held by ``gradcheck`` in complex128 (``tests/test_torch_transfer_step.py``,
``tests/test_torch_transfer_sweep.py``).  :func:`transfer_step` and
:func:`transfer_step_complex` are the one-site sweep.

JAX's ``block_z``, ``interpret`` and ``precision`` are TPU knobs and are
dropped: the kernels compute at float32 accuracy (float32 FMAs on the
narrow route, 3xTF32 products with float32 sums on the wide one).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional

import torch

from . import cuda_build

__all__ = [
    "transfer_sweep",
    "transfer_sweep_complex",
    "transfer_sweep_plain",
    "transfer_sweep_complex_plain",
    "transfer_step",
    "transfer_step_complex",
    "transfer_step_plain",
    "transfer_step_complex_plain",
    "kernel_supported",
    "transfer_sweep_supported",
    "kernel_plan",
    "SweepPlan",
    "launch_counts",
    "reset_launch_counts",
]

THREADS = 256  # threads per block (csrc/transfer_step.cu kThreads)
WARPS = THREADS // 32
SMEM_MAX = 232448  # dynamic shared memory one block may use on an H100
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_ZB = 32  # batch entries per block
MAX_STAGES = 8  # sites staged ahead (csrc/transfer_step.cu kMaxStages)
MIN_STRIP = 8  # narrower strips leave a block's tiles half empty: fewer entries instead
WIDE_D = 32  # bonds from which the wide route runs the sweep
MAX_WIDE_D = 256  # the widest bond the plan takes (kMaxWideD)
MAX_WIDE_K = 64  # the largest physical rank the plan takes (kMaxWideK)
MAX_WIDE_ZB = 8  # batch entries per cluster (kMaxWideZb)
PORTABLE_CLUSTER = 8  # larger clusters need the non-portable size (up to 16)
MAX_STRIP = 32  # columns c per CTA on the wide route
MAX_TILES3 = 4  # phase-3 output tiles a warp holds (kMaxTiles3)
MAX_RING = 4  # tiles in the wide route's ring (kMaxRing)

# launches of the sweep kernel, by dtype, counted by the wrapper where it launches
_LAUNCHES: Dict[str, int] = {"transfer_step": 0, "transfer_step_complex": 0}
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


def kernel_supported(dtype: torch.dtype) -> bool:
    """True for the dtypes the kernels take: float32 (B3), complex64 (B4).
    Counterpart of JAX's ``pallas_supported``."""
    return dtype in (torch.float32, torch.complex64)


def transfer_sweep_supported(Da: int, K: int, Dc: int, dtype: torch.dtype) -> bool:
    """True where :func:`kernel_plan` takes steps ``[B,Da,Da], [Da,K,Dc] ->
    [B,Dc,Dc]`` at every batch ``B`` and sweep length ``n``: float32 or
    complex64, bonds up to ``MAX_WIDE_D`` and physical ranks up to
    ``MAX_WIDE_K``.  The backward's d_env sweep runs the transposed steps
    (``Dc, K, Da``), whose largest bond is the same, so one check covers
    both passes.  The gate of ``ops/mps_sweep.chain_takes_kernel``."""
    return kernel_supported(dtype) and max(Da, Dc) <= MAX_WIDE_D and K <= MAX_WIDE_K


class SweepPlan(NamedTuple):
    zb: int  # batch entries per block (narrow) or per cluster (wide)
    ct: int  # width of the strip of output columns c a block computes at a time (wide: per CTA)
    tile: int  # each thread's register tile is tile x tile outputs (wide: 0, tensor-core fragments)
    stages: int  # sites of A / Mx staged ahead in a ring (1: no prefetch; wide: 1)
    smem: int  # bytes of shared memory per block
    route: str = "narrow"  # "narrow" (transfer_sweep_kernel) or "wide" (transfer_wide_kernel)
    cluster: int = 1  # CTAs per thread-block cluster (wide)
    ring: int = 0  # tiles of the core in the wide route's ring
    bc: int = 0  # wide: rows b per chunk of T1/T2
    kg: int = 0  # wide: slabs k of T1 at once
    lc: int = 0  # wide: slabs l of T2 at once
    ka: int = 0  # wide: rows a per tile of the core's column strip
    qt: int = 0  # wide: rows b per tile of the core
    lt: int = 0  # wide: slabs l per tile of the core


def _smem_bytes(n: int, Da: int, K: int, Dc: int, dtype: torch.dtype, zb: int, ct: int,
               stages: int) -> int:
    """Shared memory of one narrow block (``csrc/transfer_step.cu``
    ``smem_elems``): ``stages`` copies of A and of the group's Mx, one env
    buffer per entry (two when ``n > 1``), and T1/T2, whose rows (``ct |
    1``) and entries have odd pitches against bank conflicts."""
    envs = 2 if n > 1 else 1
    entry = (Da * K * (ct | 1)) | 1
    elems = stages * (Da * K * Dc + zb * K * K) + zb * (envs * Da * Da + 2 * entry)
    return elems * (8 if dtype.is_complex else 4)


def _narrow_plan(B: int, Da: int, K: int, Dc: int, dtype: torch.dtype, n: int):
    """The narrow route's plan (:func:`kernel_plan`), None where even one
    stage of A does not fit next to one entry's env and a strip."""

    def fits(zb: int, ct: int, stages: int) -> bool:
        return _smem_bytes(n, Da, K, Dc, dtype, zb, ct, stages) <= SMEM_MAX

    def widest(zb: int, stages: int) -> int:
        """The widest balanced strip that fits, 0 if none."""
        return next((-(-Dc // k) for k in range(1, Dc + 1) if fits(zb, -(-Dc // k), stages)), 0)

    zb = max(1, min(MAX_ZB, B, -(-B // NUM_SMS)))
    while True:
        stages = 2 if n > 1 and widest(zb, 2) else 1
        ct = widest(zb, stages)
        if ct >= min(Dc, MIN_STRIP) or (ct and zb == 1):
            break
        if zb == 1:
            return None
        zb = max(1, zb // 2)
    while stages > 1 and stages < min(n, MAX_STAGES) and fits(zb, ct, stages + 1):
        stages += 1
    tile = next(t for t in (4, 2, 1)
                if t == 1 or (t <= ct and zb * Da * K * ct >= THREADS * t * t))
    return SweepPlan(zb, ct, tile, stages, _smem_bytes(n, Da, K, Dc, dtype, zb, ct, stages))


def _cdiv(x: int, m: int) -> int:
    return -(-x // m)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _pitch_tg(x: int, cx: bool) -> int:
    """Row pitch for fragment loads at t * P + g (``pitch_tg``)."""
    p = _round_up(x, 4)
    while (p % 8 != 4) if cx else (p % 16 != 8):
        p += 4
    return p


def _pitch_gt(x: int) -> int:
    """Row pitch for fragment loads at g * P + t (``pitch_gt``)."""
    p = _round_up(x, 4)
    while p % 8 != 4:
        p += 4
    return p


def _wide_layout(n, Da, K, Dc, cx, bwd, zb, cs, bc, kg, lc, ka, qt, lt, stages) -> dict:
    """The wide route's derived shapes and shared memory in bytes
    (``csrc/transfer_step.cu`` ``wide_layout``, term for term)."""
    K8, Da8, Dc16 = _round_up(K, 8), _round_up(Da, 8), _round_up(Dc, 16)
    nbc, nkg, nlc = _cdiv(Da, bc), _cdiv(K, kg), _cdiv(K, lc)
    lcs = min(lc, K)
    Pe, PK, Pc = _pitch_tg(nbc * bc, cx), _pitch_tg(nlc * lc, cx), _pitch_tg(cs, cx)
    SK1 = _pitch_tg(bc * Pc, cx)
    P1 = _pitch_gt(ka) if bwd else Pc
    P3 = _pitch_gt(lt * qt) if bwd else _pitch_tg(Dc16, cx)
    t1_tile = kg * (cs if bwd else ka) * P1
    t3_tile = Dc16 * P3 if bwd else lt * qt * P3
    N3 = (Dc16 // 16) * zb * (cs // 8)
    split = 1
    while N3 * split * 2 <= WARPS:
        split *= 2
    last_rows = Da8 - (nbc - 1) * bc
    m_last = _cdiv(K - (nlc - 1) * lc, lt) * _cdiv(min(last_rows, bc), qt)
    scratch = (split - 1) * N3 * 32 * 4
    envs = 2 if n > 1 else 1
    r4 = lambda x: _round_up(x, 4)  # noqa: E731
    total = (r4(envs * zb * cs * Pe) + r4(zb * K8 * PK) + r4(max(zb * kg * SK1, scratch))
             + r4(zb * lcs * SK1) + stages * r4(max(t1_tile, t3_tile)))
    return {"N3": N3, "m_last": m_last, "P3": P3, "t1_tile": t1_tile,
            "smem": 8 * MAX_RING + total * (8 if cx else 4)}  # the ring slots' mbarriers first


def _wide_plan(B: int, Da: int, K: int, Dc: int, dtype: torch.dtype, n: int):
    """The wide route's plan (:func:`kernel_plan`), None where no cluster of
    at most 16 CTAs fits."""
    cx = dtype.is_complex
    D = max(Da, Dc)
    most = MAX_TILES3 * WARPS  # phase-3 output tiles of one CTA

    def qt_of(bc):
        return max(q for q in (bc, 64, 32, 16, 8) if q <= 64 and bc % q == 0)

    # the narrowest strips a cluster of at most 8 CTAs covers D with (16
    # where those do not fit), at most MAX_STRIP columns
    for cs in range(8 * _cdiv(_cdiv(D, 8), PORTABLE_CLUSTER), 7, -8):
        C = _cdiv(D, cs)
        if C > 16:
            break
        zb = max(1, min(MAX_WIDE_ZB, B, B * C // NUM_SMS))

        def layout(zb, bc, kg, lc, ka, qt, lt, stages, bwd):
            return _wide_layout(n, Da, K, Dc, cx, bwd, zb, cs, bc, kg, lc, ka, qt, lt, stages)

        def n3(zb):
            return layout(zb, 16, 1, 8, 8, 16, 1, 3, False)["N3"]

        while zb > 1 and n3(zb) > most:
            zb //= 2
        if n3(zb) > most:
            continue
        bc, kg, lc = _round_up(Da, 16), K, _round_up(K, 8)
        ka, stages = min(_round_up(Da, 8), 64), MAX_RING
        qt = qt_of(bc)

        def finish(zb, bc, kg, lc, ka, qt, stages):
            """lt from the room a phase-1 tile leaves; None if it does not fit."""
            lts = [1]
            if qt == bc:  # a tile of several slabs l where one slab's rows are few
                fwd = layout(zb, bc, kg, lc, ka, qt, 1, stages, False)
                lts = range(min(lc, K, max(1, fwd["t1_tile"] // max(fwd["P3"] * qt, 1))), 0, -1)
            for lt in lts:
                lays = [layout(zb, bc, kg, lc, ka, qt, lt, stages, bwd) for bwd in (False, True)]
                st = min(stages, min(x["m_last"] for x in lays) + 2)
                lays = [layout(zb, bc, kg, lc, ka, qt, lt, st, bwd) for bwd in (False, True)]
                if max(x["smem"] for x in lays) <= SMEM_MAX:
                    return lt, st, max(x["smem"] for x in lays)
            return None

        # shared memory: give up, in this order, the deepest a-tiles, the
        # fourth ring slot, the widest chunk of slabs l, the longest b-tiles,
        # entries, rows b, slabs k, and last the a- and b-tiles down to 8 rows
        while True:
            got = finish(zb, bc, kg, lc, ka, qt, stages)
            if got:
                lt, stages, smem = got
                return SweepPlan(zb, cs, 0, 1, smem, "wide", C, stages, bc, kg, lc, ka, qt, lt)
            if ka > 16:
                ka = _round_up(ka // 2, 8)
            elif stages > 3:
                stages = 3
            elif lc > 8:
                lc = _round_up(lc // 2, 8)
            elif qt > 16:
                qt = max(q for q in (32, 16, 8) if q < qt and bc % q == 0)
            elif zb > 1:
                zb //= 2
            elif bc > 16:
                bc = _round_up(bc // 2, 16)
                qt = min(qt, qt_of(bc))
            elif kg > 1:
                kg = _cdiv(kg, 2)
            elif ka > 8:
                ka = 8
            elif qt > 8:
                qt = 8
            else:
                break
    return None


@functools.lru_cache(maxsize=4096)
def kernel_plan(B: int, Da: int, K: int, Dc: int, dtype: torch.dtype, n: int = 1,
                route: Optional[str] = None) -> SweepPlan:
    """The launch plan of an ``n``-site sweep of steps ``env [B,Da,Da], A
    [Da,K,Dc] -> [B,Dc,Dc]``, decided by shape and dtype alone.

    **Route.**  The narrow route (``transfer_sweep_kernel``, one block per
    group of entries, CUDA cores) where ``max(Da, Dc) < WIDE_D`` (32) and its
    plan fits; the wide route (``transfer_wide_kernel``, a cluster per group
    of entries, tensor cores in 3xTF32) at ``max(Da, Dc) >= 32`` and
    wherever the narrow plan does not fit.  ``route`` forces one of them
    (phase 5 of ``chip_smoke.py`` times both at (4096, 16, 4)).  Both take
    float32 and complex64 at any ``B >= 1`` and ``n >= 1``; the plan takes
    every width up to ``D = 256`` and ``K = 64`` and raises ``ValueError``
    with the reason past that.

    **Narrow.**  ``zb`` spreads the batch over the card's SMs (one block
    each, at most ``MAX_ZB`` entries).  ``ct = Dc`` where that fits in
    shared memory, else the columns are cut into the fewest balanced strips
    that do, with a second stage of A / Mx where ``n > 1`` (prefetch) if it
    fits; ``zb`` halves until a strip of ``MIN_STRIP`` columns (or all of
    them) fits.  Then the ring grows to as many stages as fit, up to ``n``
    and ``MAX_STAGES``.  ``tile`` is the largest of 4, 2, 1 no wider than
    the strip that still gives every thread a tile of T1.

    **Wide.**  Each CTA of a cluster of ``cluster`` CTAs owns ``ct`` (a
    multiple of 8, at most ``MAX_STRIP``) columns: the narrowest strips
    that at most 8 CTAs cover ``max(Da, Dc)`` with (narrower, up to 16
    CTAs, where those do not fit).  ``zb`` = ``B * cluster // 132`` entries
    per cluster (1 to 8), so that the launch has 132 CTAs or more wherever
    ``B * cluster`` allows; it halves (then the strip narrows) until a CTA
    has at most 32 phase-3 output tiles.  Then the tiles of the core (``ka`` rows a, ``qt`` rows
    b, ``lt`` slabs l), the chunks (``bc`` rows b, ``kg`` slabs k, ``lc``
    slabs l) and ``zb`` shrink, in a fixed order, until the block fits
    ``SMEM_MAX`` with a ring of 4 (else 3) tiles, 2 (1) of them in flight
    ahead of the one in use; no more are in flight than the last chunk of a
    site has tiles after its last phase 2 (the site's Mx rides with its
    first tile).  ``tile`` is 0 and ``stages`` 1."""
    if not kernel_supported(dtype):
        raise ValueError(f"the transfer-sweep kernels take float32 or complex64, got {dtype}")
    if min(n, B, Da, K, Dc) < 1:
        raise ValueError(f"empty transfer sweep: n={n}, B={B}, Da={Da}, K={K}, Dc={Dc}")
    if n > 1 and Da != Dc:
        raise ValueError(f"a sweep of {n} sites needs square cores, got Da={Da}, Dc={Dc}")
    if not transfer_sweep_supported(Da, K, Dc, dtype):
        raise ValueError(
            f"transfer sweep Da={Da}, K={K}, Dc={Dc} ({dtype}) does not fit the kernels: "
            f"they take bonds up to {MAX_WIDE_D} and physical ranks up to {MAX_WIDE_K}")
    if route not in (None, "narrow", "wide"):
        raise ValueError(f"route must be 'narrow' or 'wide', got {route!r}")
    narrow = None
    if route == "narrow" or (route is None and max(Da, Dc) < WIDE_D):
        narrow = _narrow_plan(B, Da, K, Dc, dtype, n)
        if narrow is not None or route == "narrow":
            if narrow is None:
                raise ValueError(
                    f"transfer sweep Da={Da}, K={K}, Dc={Dc} ({dtype}) does not fit the "
                    f"narrow route: one core, one entry's env and a one-column strip need "
                    f"more than {SMEM_MAX} bytes of shared memory")
            return narrow
    wide = _wide_plan(B, Da, K, Dc, dtype, n)
    if wide is None:  # not reached within MAX_WIDE_D and MAX_WIDE_K
        raise ValueError(f"transfer sweep Da={Da}, K={K}, Dc={Dc} ({dtype}) does not fit the "
                         f"wide route in {SMEM_MAX} bytes of shared memory")
    return wide


# ---------------------------------------------------------------------------
# plain versions (the kernel's arithmetic, in the same factorised order)
# ---------------------------------------------------------------------------


def _plain(env, a, mx, bra):
    t1 = torch.einsum("zab,akc->zbkc", env, a)
    t2 = torch.einsum("zbkc,zkl->zblc", t1, mx)
    return torch.einsum("zblc,bld->zcd", t2, bra)


def transfer_step_plain(env, a, mx):
    """B3's step in plain PyTorch (any real dtype)."""
    return _plain(env, a, mx, a)


def transfer_step_complex_plain(env, a, mx):
    """B4's step in plain PyTorch: the bra is ``conj(a)``."""
    return _plain(env, a, mx, a.conj())


def _sweep_plain(env0, a, mx, complex_: bool, backward: bool) -> torch.Tensor:
    if backward:  # the d_env chain: sites reversed, cores transposed (conj for B4)
        a, mx = a.flip(0).permute(0, 3, 2, 1), mx.flip(0)
        if complex_:
            a, mx = a.conj(), mx.conj()
    outs, env = [], env0
    for ai, mi in zip(a, mx):
        env = _plain(env, ai, mi, ai.conj() if complex_ else ai)
        outs.append(env)
    out = torch.stack(outs)
    return out.flip(0) if backward else out


def transfer_sweep_plain(env0, a, mx, backward: bool = False):
    """B3's sweep in plain PyTorch: ``out[i]`` is site i's env, ``[n, B, Dc,
    Dc]``.  ``backward``: the d_env chain of the kernel, ``env0`` the
    cotangent of the last env and ``out[i]`` that of site i's input."""
    return _sweep_plain(env0, a, mx, False, backward)


def transfer_sweep_complex_plain(env0, a, mx, backward: bool = False):
    """B4's sweep in plain PyTorch (the bra is ``conj(a)``); as
    :func:`transfer_sweep_plain`."""
    return _sweep_plain(env0, a, mx, True, backward)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The transfer-sweep library with its C signatures declared."""
    lib = cuda_build.library("transfer_step")
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for fn in (lib.tneq_transfer_sweep_f32, lib.tneq_transfer_sweep_c64):
        fn.argtypes = [I, P, P, P, I, I, I, I, I, I, I, I, I, I, P, P]
        fn.restype = I
    for fn in (lib.tneq_transfer_wide_f32, lib.tneq_transfer_wide_c64):
        fn.argtypes = [I, P, P, P] + [I] * 16 + [Z, P, P]
        fn.restype = I
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.is_conj():
        raise ValueError(f"{name} must be contiguous, with its conjugation resolved")


def _launch(env0, a, mx, complex_: bool, backward: bool = False,
            route: Optional[str] = None) -> torch.Tensor:
    """One launch of B3 (``complex_=False``) or B4 over the whole sweep; the
    same output as :func:`_sweep_plain`.  ``route`` forces the narrow or
    the wide kernel (:func:`kernel_plan`)."""
    dtype = torch.complex64 if complex_ else torch.float32
    if env0.dim() != 3 or a.dim() != 4 or mx.dim() != 4:
        raise ValueError("transfer sweep takes env0 [B,Da,Da], a [n,Da,K,Dc], mx [n,B,K,K]")
    n, Da, K, Dc = (int(s) for s in a.shape)
    B = int(env0.shape[0])
    if backward:
        Da, Dc = Dc, Da  # the step's own dims: it runs on the transposed cores
    dev = a.device
    _check("env0", env0, (B, Da, Da), dtype, dev)
    _check("a", a, tuple(a.shape), dtype, dev)
    _check("mx", mx, (n, B, K, K), dtype, dev)
    plan = kernel_plan(B, Da, K, Dc, dtype, n, route)
    out = torch.empty((n, B, Dc, Dc), dtype=dtype, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    args = (dev.index, env0.data_ptr(), a.data_ptr(), mx.data_ptr(), n, B, Da, K, Dc,
            int(backward))
    lib = _lib()
    if plan.route == "wide":
        fn = lib.tneq_transfer_wide_c64 if complex_ else lib.tneq_transfer_wide_f32
        err = fn(*args, plan.zb, plan.ct, plan.cluster, plan.bc, plan.kg, plan.lc, plan.ka,
                 plan.qt, plan.lt, plan.ring, plan.smem, out.data_ptr(), stream)
    else:
        fn = lib.tneq_transfer_sweep_c64 if complex_ else lib.tneq_transfer_sweep_f32
        err = fn(*args, plan.zb, plan.ct, plan.tile, plan.stages, out.data_ptr(), stream)
    name = "transfer_step_complex" if complex_ else "transfer_step"
    if err != 0:
        raise RuntimeError(f"{name} ({'B4' if complex_ else 'B3'}) launch failed: CUDA error {err}")
    _count_launch(name)
    return out


def _ready(t: torch.Tensor) -> torch.Tensor:
    return t.resolve_conj().contiguous()


def _sweep(env0, a, mx, complex_: bool, backward: bool) -> torch.Tensor:
    """Every env of the sweep, ``[n, B, Dc, Dc]``: the plain version for CPU
    tensors, one kernel launch for CUDA tensors."""
    if a.device.type == "cpu":
        return _sweep_plain(env0, a, mx, complex_, backward)
    if a.device.type == "cuda":
        return _launch(_ready(env0), _ready(a), _ready(mx), complex_, backward)
    raise ValueError(f"no transfer-step path for device {a.device}")


def _param_grads(env, a, mx, g, complex_: bool, need_a: bool, need_mx: bool):
    """``d_a [n,Da,K,Dc]`` and ``d_mx [n,B,K,K]`` of every site at once, as
    pairwise contractions batched over the site axis n; ``env[i]`` is site
    i's input env and ``g[i]`` the cotangent of its output (module
    docstring for the complex convention)."""
    cj = torch.conj if complex_ else (lambda x: x)
    t1 = torch.einsum("nzab,nakc->nzbkc", env, a)
    u = torch.einsum("nbld,nzcd->nzblc", a, g)
    d_a = d_mx = None
    if need_mx:
        d_mx = torch.einsum("nzbkc,nzblc->nzkl", cj(t1), u)
    if need_a:
        v = torch.einsum("nzkl,nzblc->nzbkc", cj(mx), u)
        t2 = torch.einsum("nzbkc,nzkl->nzblc", t1, mx)
        d_a = (torch.einsum("nzab,nzbkc->nakc", cj(env), v)
               + torch.einsum("nzblc,nzcd->nbld", t2, cj(g)))
    return d_a, d_mx


class _TransferSweep(torch.autograd.Function):
    """Forward: one sweep launch, returning the last env.  Backward: one
    launch of the same kernel for the d_env chain; ``d_a``/``d_mx`` by
    :func:`_param_grads`."""

    @staticmethod
    def forward(ctx, env0, a, mx, complex_):
        out = _sweep(env0, a, mx, complex_, backward=False)
        ctx.complex_ = complex_
        ctx.save_for_backward(env0, a, mx, out)
        return out[-1]

    @staticmethod
    def backward(ctx, g):
        env0, a, mx, out = ctx.saved_tensors
        need_env, need_a, need_mx = ctx.needs_input_grad[:3]
        n = a.shape[0]
        d_env = d_a = d_mx = None
        genv = None  # genv[i]: the cotangent of site i's input env
        if need_env or n > 1:
            genv = _sweep(g, a, mx, ctx.complex_, backward=True)
            if need_env:
                d_env = genv[0]
        if need_a or need_mx:
            # site i's input env, and the cotangent of its output
            env_in = env0[None] if n == 1 else torch.cat([env0[None], out[:-1]])
            g_out = g[None] if n == 1 else torch.cat([genv[1:], g[None]])
            d_a, d_mx = _param_grads(env_in, a, mx, g_out, ctx.complex_, need_a, need_mx)
        return d_env, d_a, d_mx, None


def transfer_sweep(env0: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable real sweep ``[B,Da,Da], [n,Da,K,Dc], [n,B,K,K] ->
    [B,Dc,Dc]``, the env after the last site (B3 on the card: one launch
    forward, one backward)."""
    return _TransferSweep.apply(env0, a, mx, False)


def transfer_sweep_complex(env0: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable complex sweep with the bra ``conj(a)`` (B4 on the card)."""
    return _TransferSweep.apply(env0, a, mx, True)


def transfer_step(env: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable real transfer step ``[B,Da,Da], [Da,K,Dc], [B,K,K] ->
    [B,Dc,Dc]``: the one-site :func:`transfer_sweep`."""
    _check_step(env, a, mx)
    return transfer_sweep(env, a[None], mx[None])


def transfer_step_complex(env: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable complex transfer step with the bra ``conj(a)``: the
    one-site :func:`transfer_sweep_complex`."""
    _check_step(env, a, mx)
    return transfer_sweep_complex(env, a[None], mx[None])


def _check_step(env, a, mx) -> None:
    if env.dim() != 3 or a.dim() != 3 or mx.dim() != 3:
        raise ValueError("transfer step takes env [B,Da,Da], a [Da,K,Dc], mx [B,K,K]")
