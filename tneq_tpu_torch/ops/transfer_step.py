"""The MPS transfer step of the Born-rule sweep: kernels B3 (float32) and B4
(complex64).

Counterpart of ``tneq_tpu/ops/pallas_kernels.py``.  One step contracts the
boundary environment with one middle core and its measurement operators::

    out[z,c,d] = sum env[z,a,b] * A[a,k,c] * bra(A)[b,l,d] * Mx[z,k,l]

with ``bra(A) = A`` (B3) or ``conj(A)`` (B4, the Born-rule bra).  On a CUDA
tensor it runs as the hand-written Hopper kernels of
``csrc/transfer_step.cu``; on a CPU tensor as their plain PyTorch versions
(:func:`transfer_step_plain`, :func:`transfer_step_complex_plain`), which
do the same factorised sums.  A CUDA tensor launches the kernel or raises:
nothing falls back.

:func:`transfer_step` and :func:`transfer_step_complex` are
``torch.autograd.Function``\\ s.  Their backward runs ``d_env`` through the
same kernel on the transposed core, as JAX's custom VJP does
(``pallas_kernels.py:231-262``); ``d_a`` and ``d_mx`` are ``torch.einsum``
reductions.  The complex backward is derived for torch's convention (the
gradient of a real loss is the conjugate of ``jax.grad``'s)::

    d_env = B4(g, conj(A).permute(2,1,0), conj(Mx))
    d_A   = sum conj(env) A conj(Mx) g  +  sum env A Mx conj(g)
    d_Mx  = sum conj(env) conj(A) A g

and is held by ``gradcheck`` in complex128 (``tests/test_torch_transfer_step.py``).

JAX's ``block_z``, ``interpret`` and ``precision`` are TPU knobs and are
dropped: the kernels compute in full float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import cuda_build

__all__ = [
    "transfer_step",
    "transfer_step_complex",
    "transfer_step_plain",
    "transfer_step_complex_plain",
    "kernel_supported",
    "kernel_plan",
    "launch_counts",
    "reset_launch_counts",
]

THREADS = 256  # threads per block (csrc/transfer_step.cu kThreads)
SMEM_MAX = 232448  # dynamic shared memory one block may use on an H100
SMEM_DEFAULT = 48 * 1024  # above this the kernel opts in to more
MAX_ZB = 32  # batch entries per block

# launches of each kernel, counted by the wrappers where they launch
_LAUNCHES: Dict[str, int] = {"transfer_step": 0, "transfer_step_complex": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def kernel_supported(dtype: torch.dtype) -> bool:
    """True for the dtypes the kernels take: float32 (B3), complex64 (B4).
    Counterpart of JAX's ``pallas_supported``."""
    return dtype in (torch.float32, torch.complex64)


def kernel_plan(B: int, Da: int, K: int, Dc: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(zb, ct, smem_bytes)``: batch entries per block, width of the strip
    of output columns c a block computes at a time, and the block's shared
    memory.  Decided by shape and dtype alone.

    Shared memory holds A (``Da*K*Dc``) plus, per batch entry, env
    (``Da*Da``), Mx (``K*K``) and the two intermediates T1/T2
    (``2*Da*K*ct``).  ``ct = Dc`` where one entry fits, else the widest
    strip that does; ``zb`` gives a block about ``THREADS`` outputs, within
    48 KB where that suffices.  Raises ``ValueError`` when even a
    one-column strip does not fit (A alone too large)."""
    if not kernel_supported(dtype):
        raise ValueError(f"the transfer-step kernels take float32 or complex64, got {dtype}")
    if min(B, Da, K, Dc) < 1:
        raise ValueError(f"empty transfer step: B={B}, Da={Da}, K={K}, Dc={Dc}")
    elem = 8 if dtype.is_complex else 4
    a_el = Da * K * Dc
    fixed = Da * Da + K * K

    def per_z(ct: int) -> int:
        return fixed + 2 * Da * K * ct

    ct = min(Dc, (SMEM_MAX // elem - a_el - fixed) // (2 * Da * K))
    if ct < 1:
        raise ValueError(
            f"transfer step Da={Da}, K={K}, Dc={Dc} ({dtype}) does not fit the "
            f"kernel: its core alone needs {a_el * elem} of {SMEM_MAX} bytes of "
            "shared memory"
        )
    budget = SMEM_DEFAULT if (a_el + per_z(ct)) * elem <= SMEM_DEFAULT else SMEM_MAX
    zb = max(1, min(MAX_ZB, B, THREADS // (ct * Dc)))
    zb = max(1, min(zb, (budget // elem - a_el) // per_z(ct)))
    return zb, ct, (a_el + zb * per_z(ct)) * elem


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, in the same factorised order)
# ---------------------------------------------------------------------------


def _plain(env, a, mx, bra):
    t1 = torch.einsum("zab,akc->zbkc", env, a)
    t2 = torch.einsum("zbkc,zkl->zblc", t1, mx)
    return torch.einsum("zblc,bld->zcd", t2, bra)


def transfer_step_plain(env, a, mx):
    """B3's function in plain PyTorch (any real dtype)."""
    return _plain(env, a, mx, a)


def transfer_step_complex_plain(env, a, mx):
    """B4's function in plain PyTorch: the bra is ``conj(a)``."""
    return _plain(env, a, mx, a.conj())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The transfer-step library with its C signatures declared."""
    lib = cuda_build.library("transfer_step")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tneq_transfer_step_f32, lib.tneq_transfer_step_c64):
        fn.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P]
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


def _shapes(env, a, mx) -> Tuple[int, int, int, int]:
    if env.dim() != 3 or a.dim() != 3 or mx.dim() != 3:
        raise ValueError("transfer step takes env [B,Da,Da], a [Da,K,Dc], mx [B,K,K]")
    B, Da, K, Dc = env.shape[0], a.shape[0], a.shape[1], a.shape[2]
    return int(B), int(Da), int(K), int(Dc)


def _launch(env, a, mx, complex_: bool) -> torch.Tensor:
    """Launch B3 (``complex_=False``) or B4; same output as the plain version."""
    dtype = torch.complex64 if complex_ else torch.float32
    B, Da, K, Dc = _shapes(env, a, mx)
    dev = a.device
    _check("env", env, (B, Da, Da), dtype, dev)
    _check("a", a, (Da, K, Dc), dtype, dev)
    _check("mx", mx, (B, K, K), dtype, dev)
    zb, ct, _ = kernel_plan(B, Da, K, Dc, dtype)
    out = torch.empty((B, Dc, Dc), dtype=dtype, device=dev)
    fn = _lib().tneq_transfer_step_c64 if complex_ else _lib().tneq_transfer_step_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, env.data_ptr(), a.data_ptr(), mx.data_ptr(), B, Da, K, Dc,
             zb, ct, out.data_ptr(), ctypes.c_void_p(stream))
    name = "transfer_step_complex" if complex_ else "transfer_step"
    if err != 0:
        raise RuntimeError(f"{name} ({'B4' if complex_ else 'B3'}) launch failed: CUDA error {err}")
    _LAUNCHES[name] += 1
    return out


def _ready(t: torch.Tensor) -> torch.Tensor:
    return t.resolve_conj().contiguous()


def _step(env, a, mx, complex_: bool) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if a.device.type == "cpu":
        return (transfer_step_complex_plain if complex_ else transfer_step_plain)(env, a, mx)
    if a.device.type == "cuda":
        return _launch(_ready(env), _ready(a), _ready(mx), complex_)
    raise ValueError(f"no transfer-step path for device {a.device}")


class _TransferStep(torch.autograd.Function):
    """B3 forward; backward: ``d_env`` = B3 on the transposed core, ``d_a``
    and ``d_mx`` by einsum (``pallas_kernels.py:250-262``)."""

    @staticmethod
    def forward(ctx, env, a, mx):
        ctx.save_for_backward(env, a, mx)
        return _step(env, a, mx, complex_=False)

    @staticmethod
    def backward(ctx, g):
        env, a, mx = ctx.saved_tensors
        d_env = d_a = d_mx = None
        if ctx.needs_input_grad[0]:
            d_env = _step(g, a.permute(2, 1, 0), mx, complex_=False)
        if ctx.needs_input_grad[1]:
            d_a = (torch.einsum("zab,bld,zkl,zcd->akc", env, a, mx, g)
                   + torch.einsum("zab,akc,zkl,zcd->bld", env, a, mx, g))
        if ctx.needs_input_grad[2]:
            d_mx = torch.einsum("zab,akc,bld,zcd->zkl", env, a, a, g)
        return d_env, d_a, d_mx


class _TransferStepComplex(torch.autograd.Function):
    """B4 forward; backward derived for torch's complex convention (module
    docstring), ``d_env`` through B4."""

    @staticmethod
    def forward(ctx, env, a, mx):
        ctx.save_for_backward(env, a, mx)
        return _step(env, a, mx, complex_=True)

    @staticmethod
    def backward(ctx, g):
        env, a, mx = ctx.saved_tensors
        d_env = d_a = d_mx = None
        if ctx.needs_input_grad[0]:
            d_env = _step(g, a.conj().permute(2, 1, 0), mx.conj(), complex_=True)
        if ctx.needs_input_grad[1]:
            d_a = (torch.einsum("zab,bld,zkl,zcd->akc", env.conj(), a, mx.conj(), g)
                   + torch.einsum("zab,akc,zkl,zcd->bld", env, a, mx, g.conj()))
        if ctx.needs_input_grad[2]:
            d_mx = torch.einsum("zab,akc,bld,zcd->zkl", env.conj(), a.conj(), a, g)
        return d_env, d_a, d_mx


def transfer_step(env: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable real transfer step ``[B,Da,Da], [Da,K,Dc], [B,K,K] ->
    [B,Dc,Dc]`` (B3 on the card)."""
    return _TransferStep.apply(env, a, mx)


def transfer_step_complex(env: torch.Tensor, a: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Differentiable complex transfer step with the bra ``conj(a)`` (B4 on
    the card)."""
    return _TransferStepComplex.apply(env, a, mx)
