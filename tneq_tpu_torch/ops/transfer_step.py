"""The MPS transfer sweep of the Born-rule contraction: kernels B3 (float32)
and B4 (complex64).

Counterpart of ``tneq_tpu/ops/pallas_kernels.py``.  One step contracts the
boundary environment with one middle core and its measurement operators::

    out[z,c,d] = sum env[z,a,b] * A[a,k,c] * bra(A)[b,l,d] * Mx[z,k,l]

with ``bra(A) = A`` (B3) or ``conj(A)`` (B4, the Born-rule bra).  A sweep
runs the steps of a stack of cores ``A [n, Da, K, Dc]`` and operators
``Mx [n, B, K, K]`` from ``env0 [B, Da, Da]``; on a CUDA tensor the whole
sweep is ONE launch of the hand-written Hopper kernel of
``csrc/transfer_step.cu``, on a CPU tensor the plain PyTorch version
(:func:`transfer_sweep_plain`, :func:`transfer_sweep_complex_plain`), which
loops over the same factorised step.  A CUDA tensor launches the kernel or
raises: nothing falls back.

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
dropped: the kernels compute in full float32.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple

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
    "kernel_plan",
    "SweepPlan",
    "launch_counts",
    "reset_launch_counts",
]

THREADS = 256  # threads per block (csrc/transfer_step.cu kThreads)
SMEM_MAX = 232448  # dynamic shared memory one block may use on an H100
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_ZB = 32  # batch entries per block
MAX_STAGES = 8  # sites staged ahead (csrc/transfer_step.cu kMaxStages)
MIN_STRIP = 8  # narrower strips leave a block's tiles half empty: fewer entries instead

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


class SweepPlan(NamedTuple):
    zb: int  # batch entries per block
    ct: int  # width of the strip of output columns c a site computes at a time
    tile: int  # each thread's register tile is tile x tile outputs
    stages: int  # sites of A / Mx staged ahead in a ring (1: no prefetch; 0: read from HBM)
    smem: int  # bytes of shared memory per block


def _smem_bytes(n: int, Da: int, K: int, Dc: int, dtype: torch.dtype, zb: int, ct: int,
               stages: int) -> int:
    """Shared memory of one block (``csrc/transfer_step.cu`` ``smem_elems``):
    ``stages`` copies of A and of the group's Mx (none at ``stages = 0``),
    one env buffer per entry (two when ``n > 1``), and T1/T2, whose rows
    (``ct | 1``) and entries have odd pitches against bank conflicts."""
    envs = 2 if n > 1 else 1
    entry = (Da * K * (ct | 1)) | 1
    elems = stages * (Da * K * Dc + zb * K * K) + zb * (envs * Da * Da + 2 * entry)
    return elems * (8 if dtype.is_complex else 4)


def kernel_plan(B: int, Da: int, K: int, Dc: int, dtype: torch.dtype, n: int = 1) -> SweepPlan:
    """The launch plan of an ``n``-site sweep of steps ``env [B,Da,Da], A
    [Da,K,Dc] -> [B,Dc,Dc]``, decided by shape and dtype alone.

    ``zb`` spreads the batch over the card's SMs (one block each, at most
    ``MAX_ZB`` entries).  ``ct = Dc`` where that fits in shared memory, else
    the columns are cut into the fewest balanced strips that do, with a
    second stage of A / Mx where ``n > 1`` (prefetch) if it fits; ``zb``
    halves until a strip of ``MIN_STRIP`` columns (or all of them) fits.
    Then the ring grows to as many stages as fit, up to ``n`` and
    ``MAX_STAGES``.  A core too wide for even one stage (256 KiB: D = 64, K
    = 16 in float32) gets the same search with ``stages = 0``: A and Mx are
    read from global memory and only the env and T1/T2 use shared memory.
    ``tile`` is the largest of 4, 2, 1 no wider than the strip that still
    gives every thread a tile of T1.  Raises ``ValueError`` when even one
    entry's env with a one-column strip does not fit."""
    if not kernel_supported(dtype):
        raise ValueError(f"the transfer-sweep kernels take float32 or complex64, got {dtype}")
    if min(n, B, Da, K, Dc) < 1:
        raise ValueError(f"empty transfer sweep: n={n}, B={B}, Da={Da}, K={K}, Dc={Dc}")
    if n > 1 and Da != Dc:
        raise ValueError(f"a sweep of {n} sites needs square cores, got Da={Da}, Dc={Dc}")

    def fits(zb: int, ct: int, stages: int) -> bool:
        return _smem_bytes(n, Da, K, Dc, dtype, zb, ct, stages) <= SMEM_MAX

    def widest(zb: int, stages: int) -> int:
        """The widest balanced strip that fits, 0 if none."""
        return next((-(-Dc // k) for k in range(1, Dc + 1) if fits(zb, -(-Dc // k), stages)), 0)

    def search(staged: bool):
        """``(zb, ct, stages)`` with A / Mx staged or not, None if none fits."""
        zb = max(1, min(MAX_ZB, B, -(-B // NUM_SMS)))
        while True:
            stages = (2 if n > 1 and widest(zb, 2) else 1) if staged else 0
            ct = widest(zb, stages)
            if ct >= min(Dc, MIN_STRIP) or (ct and zb == 1):
                return zb, ct, stages
            if zb == 1:
                return None
            zb = max(1, zb // 2)

    found = search(True) or search(False)
    if found is None:
        raise ValueError(
            f"transfer sweep Da={Da}, K={K}, Dc={Dc} ({dtype}) does not fit the "
            f"kernel: one batch entry's env and a one-column strip need "
            f"{_smem_bytes(n, Da, K, Dc, dtype, 1, 1, 0)} of {SMEM_MAX} bytes of shared memory"
        )
    zb, ct, stages = found
    while stages > 1 and stages < min(n, MAX_STAGES) and fits(zb, ct, stages + 1):
        stages += 1
    tile = next(t for t in (4, 2, 1)
                if t == 1 or (t <= ct and zb * Da * K * ct >= THREADS * t * t))
    return SweepPlan(zb, ct, tile, stages, _smem_bytes(n, Da, K, Dc, dtype, zb, ct, stages))


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
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tneq_transfer_sweep_f32, lib.tneq_transfer_sweep_c64):
        fn.argtypes = [I, P, P, P, I, I, I, I, I, I, I, I, I, I, P, P]
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


def _launch(env0, a, mx, complex_: bool, backward: bool = False) -> torch.Tensor:
    """One launch of B3 (``complex_=False``) or B4 over the whole sweep; the
    same output as :func:`_sweep_plain`."""
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
    plan = kernel_plan(B, Da, K, Dc, dtype, n)
    if backward and plan.stages == 0:  # read from global memory in the step's layout
        a = a.permute(0, 3, 2, 1).contiguous()
    out = torch.empty((n, B, Dc, Dc), dtype=dtype, device=dev)
    fn = _lib().tneq_transfer_sweep_c64 if complex_ else _lib().tneq_transfer_sweep_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, env0.data_ptr(), a.data_ptr(), mx.data_ptr(), n, B, Da, K, Dc,
             int(backward), plan.zb, plan.ct, plan.tile, plan.stages, out.data_ptr(),
             ctypes.c_void_p(stream))
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
