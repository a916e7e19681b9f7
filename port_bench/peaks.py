"""Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity, at the full 700 W power limit).  A run prints the card's power
limit beside every share it reports.

``TF32_FLOPS`` is the highest rate at which this card multiplies float32
inputs (tensor cores, TF32), so no implementation that keeps float32 or
complex64 precision can read above 100 % of it.
"""

TF32_FLOPS = 495e12  # FLOP/s, TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # bytes/s, HBM3
