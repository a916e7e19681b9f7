"""The transfer-sweep kernels' share of their roofline, in %: the least time
of a step's sweep passes (each pass ``max(bytes / HBM, FLOPs / TF32 peak)``
by the frozen counts of ``port_bench.counts``) over their traced device
time per step."""

from port_bench.counts import transfer_pass_bytes, transfer_pass_flops
from port_bench.peaks import HBM_BYTES_PER_S, TF32_FLOPS

NAMES = ("transfer_sweep_kernel", "transfer_wide_kernel")


def read(ctx):
    c = ctx.counters
    sweep, steps = c.get("sweep"), c.get("steps", 0)
    sweep_s = ctx.trace.seconds_of(lambda name: any(k in name for k in NAMES))
    if not sweep or not steps or not sweep_s:
        return None
    args = (sweep["B"], sweep["D"], sweep["K"], sweep["n"], sweep["complex"])
    least = max(transfer_pass_bytes(*args) / HBM_BYTES_PER_S,
                transfer_pass_flops(*args) / TF32_FLOPS)
    return 100.0 * sweep["passes_per_step"] * least / (sweep_s / steps)
