"""Frozen operation and byte counts: the work the algorithm needs, whatever
implements it.  Kept here, where later changes to the program cannot move
them, so every share built on them stays comparable from PR to PR.

Born-rule transfer sweep (kernels B3/B4).  One pass over ``n`` middle
sites of an MPS chain at batch ``B``, bond ``D``, physical rank ``K`` runs
the step ``zab,akc,zkl,bld->zcd`` factorised as three pairwise products:
``2·B·(2·D³·K + D²·K²)`` FLOPs per site (times 4 in complex64).  Its bytes
read each input once (the first env ``[B, D, D]``, the cores ``[n, D, K,
D]``, the operators ``[n, B, K, K]``) and write each output once (the envs
``[n, B, D, D]``).  A training step runs the forward pass and its backward,
counted as two passes more (the d_env pass and the cores' gradients): three
passes of work per step.

Brick-wall network fit.  ``BRICK_8X5_LANE_STEP_FLOPS`` is one lane step of
the masked network-fidelity fit on the 8 × 5 rank-2 complex64 brick wall:
``tneq_tpu_torch/bench/flops.network_fidelity_step_flops`` of that graph
at commit d31947b (six overlaps, each along the pairwise executor's path,
complex multiply-adds at 8 real FLOPs), recorded as a number so that a
later change to the path finder does not move it.
"""

from __future__ import annotations

BRICK_8X5_LANE_STEP_FLOPS = 569_625_600


def transfer_pass_flops(B: int, D: int, K: int, n: int, complex_: bool = False) -> float:
    """FLOPs of one transfer-sweep pass over ``n`` middle sites."""
    return float(n * 2 * B * (2 * D ** 3 * K + D * D * K * K) * (4 if complex_ else 1))


def transfer_pass_bytes(B: int, D: int, K: int, n: int, complex_: bool = False) -> float:
    """Bytes of one transfer-sweep pass: each input read once, each output
    written once."""
    elem = 8 if complex_ else 4
    return float(elem * (B * D * D + n * (D * K * D + B * K * K + B * D * D)))


def born_step_flops(B: int, D: int, K: int, n_qubits: int, complex_: bool = False) -> float:
    """FLOPs of one Born-rule training step's transfer sweeps: three passes
    over the ``n_qubits - 3`` middle sites."""
    return 3.0 * transfer_pass_flops(B, D, K, n_qubits - 3, complex_)
