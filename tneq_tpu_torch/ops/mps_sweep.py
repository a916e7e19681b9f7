"""MPS transfer-matrix sweep: the siamese Born-rule contraction on chains.

Counterpart of ``tneq_tpu/ops/mps_sweep.py``: absorb the input states into
the cores, then sweep left to right carrying the boundary environment
``env[z, a, b]`` (batch, ket bond, bra bond) through the transfer step
``zab,akc,zkl,bld->zcd``.  Valid for the chains of ``mps_graph`` (core i on
qubits (i, i+1)); :func:`is_mps_chain` checks that.

Why the kernel is the default here while JAX's ``use_pallas`` defaults to
False: XLA fuses JAX's einsum step into one compiled program, while eager
PyTorch runs ``torch.einsum`` as a chain of separate launches with
``[B, D, K, D]`` intermediates in device memory; the kernels B3/B4
(``ops/transfer_step.py``) run all the middle steps of a sweep in one
launch, and its d_env backward in one more.

One gate decides which chains take the kernels
(:func:`chain_takes_kernel`): float32 (B3) or complex64 (B4), every middle
core's bonds up to 256 and its physical rank up to 64
(``ops/transfer_step.transfer_sweep_supported``, the region where
``kernel_plan`` plans every batch and sweep length).  A chain the gate
refuses, by dtype or by any one middle core, takes the sweep without them
for every middle site: one ``torch.einsum`` step per site, in the chain's
own precision (the strategy ``mps_sweep`` of
``ops/compiler.compile_siamese``, JAX's ``use_pallas=False``), so no entry
point raises where JAX computes.  An explicit ``use_kernel=True`` on such
a chain raises ``ValueError``: nothing falls back quietly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..graph.dsl import CircuitGraph
from .transfer_step import (
    MAX_WIDE_D,
    MAX_WIDE_K,
    kernel_supported,
    transfer_sweep,
    transfer_sweep_complex,
    transfer_sweep_supported,
)

__all__ = ["chain_takes_kernel", "is_mps_chain", "mps_sweep_siamese_fn"]


def is_mps_chain(graph: CircuitGraph) -> bool:
    """True when core i sits exactly on qubits (i, i+1) in a chain."""
    m = graph.ncores
    if m != graph.nqubits - 1 or m < 1:
        return False
    for i, core in enumerate(graph.cores):
        qubits = sorted(
            {e.qubit for e in core.in_edges} | {e.qubit for e in core.out_edges}
        )
        if qubits != [i, i + 1]:
            return False
        for e in core.in_edges:
            if e.neighbor not in (-1, i - 1):
                return False
        for e in core.out_edges:
            if e.neighbor not in (-1, i + 1):
                return False
    return True


def chain_takes_kernel(graph: CircuitGraph, dtype: torch.dtype) -> bool:
    """The gate: True when the kernels take every middle transfer step of
    the chain ``graph`` in ``dtype``.  Middle core i is ``[b_{i-1},
    s_{i+1}, o_i, b_i]``; its step runs ``Da = b_{i-1}``, ``K`` = the output
    rank of qubit i, ``Dc = b_i`` (and the transposed step backward)."""
    return kernel_supported(dtype) and all(
        transfer_sweep_supported(shape[0], graph.output_ranks[i], shape[3], dtype)
        for i, shape in enumerate(graph.shapes[n] for n in graph.core_names)
        if 0 < i < graph.ncores - 1)


def _einsum_step(env, a, mx, conj):
    return torch.einsum("zab,akc,zkl,bld->zcd", env, a, mx, conj(a))


def _kernel_sweep(env, a, mx):
    """The steps of ``a [n, Da, K, Dc]``, ``mx [n, B, K, K]`` in one sweep."""
    if a.is_complex():
        return transfer_sweep_complex(env, a, mx)
    return transfer_sweep(env, a, mx)


def _kernel_step(env, a, mx, conj):
    return _kernel_sweep(env, a[None], mx[None])


def mps_sweep_siamese_fn(
    graph: CircuitGraph,
    conj_right: bool = True,
    use_kernel: Optional[bool] = None,
    remat: bool = False,
):
    """``fn(params, states, measures) -> [B]`` siamese values (chain only).

    ``states``: per-qubit ``(rank,)`` vectors; ``measures``: per-qubit
    ``(B, K, K)`` operators.  ``use_kernel`` (JAX's ``use_pallas``): None
    lets the gate decide at each call, from the chain's shapes and the
    cores' dtype (:func:`chain_takes_kernel`, module docstring); True runs
    the middle transfer steps through B3/B4 and raises ``ValueError``
    where the gate refuses them; False takes one ``torch.einsum`` per
    step.  Where the middle cores are uniform and more than one (JAX's
    ``lax.scan`` branch),
    the kernel path stacks them and runs the sweep in one call; a
    non-uniform chain steps one site at a time.
    ``remat`` recomputes each middle step in the backward
    (``torch.utils.checkpoint``) instead of storing its intermediates, so
    it too steps one site at a time.
    Unlike ``jnp.einsum``, ``torch.einsum`` does not promote: cores, states
    and measures share one dtype.
    """
    if not is_mps_chain(graph):
        raise ValueError("graph is not an MPS chain; use make_siamese_fn")
    if use_kernel and not conj_right:
        raise ValueError("use_kernel implies the Born-rule conjugated bra")
    m = graph.ncores
    names = graph.core_names

    def fn(params, states, measures):
        conj = torch.conj if conj_right else (lambda x: x)
        params = [params[n] for n in names]
        kernel = use_kernel
        if kernel is None:
            kernel = conj_right and chain_takes_kernel(graph, params[0].dtype)
        elif kernel and not chain_takes_kernel(graph, params[0].dtype):
            raise ValueError(
                f"the transfer-sweep kernels do not take this chain in {params[0].dtype} "
                f"(float32 or complex64, bonds up to {MAX_WIDE_D}, physical ranks up to "
                f"{MAX_WIDE_K}), and use_kernel=True forbids the einsum step: leave "
                f"use_kernel=None, or compile the sweep for the cores' dtype")
        step = _kernel_step if kernel else _einsum_step

        # core layouts (in-edges by qubit, then out-edges by qubit):
        #   c_0: [s_0, s_1, o_0, b_0]; c_i: [b_{i-1}, s_{i+1}, o_i, b_i];
        #   c_last: [b_{m-2}, s_m, o_{m-1}, o_m]; m == 1: [s_0, s_1, o_0, o_1]
        if m == 1:
            a = torch.einsum("stkl,s,t->kl", params[0], states[0], states[1])
            return torch.einsum(
                "kl,zkK,zlL,KL->z", a, measures[0], measures[1], conj(a)
            )

        a0 = torch.einsum("stkc,s,t->kc", params[0], states[0], states[1])
        env = torch.einsum("kc,zkl,ld->zcd", a0, measures[0], conj(a0))
        mids = range(1, m - 1)
        uniform = len({tuple(params[i].shape) for i in mids}) == 1
        if kernel and not remat and uniform and len(mids) > 1:
            a = torch.einsum(
                "naskc,ns->nakc",
                torch.stack([params[i] for i in mids]),
                torch.stack([states[i + 1] for i in mids]),
            )
            env = _kernel_sweep(env, a, torch.stack([measures[i] for i in mids]))
            mids = ()
        for i in mids:
            a = torch.einsum("askc,s->akc", params[i], states[i + 1])
            if remat:
                env = checkpoint(step, env, a, measures[i], conj, use_reentrant=False)
            else:
                env = step(env, a, measures[i], conj)

        a_last = torch.einsum("askl,s->akl", params[m - 1], states[m])
        return torch.einsum(
            "zab,akl,zkK,zlL,bKL->z",
            env, a_last, measures[m - 1], measures[m], conj(a_last),
        )

    return fn
