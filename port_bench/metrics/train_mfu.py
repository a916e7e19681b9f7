"""The whole training step's share of the card's peak, in %: the frozen
FLOPs of a step (``counts.born_step_flops``, kept in the configuration)
times the steps of the traced window, over the window's length, over the
TF32 peak."""

from port_bench.peaks import TF32_FLOPS


def read(ctx):
    c = ctx.counters
    if not c.get("steps") or not ctx.trace.launches:
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / ctx.trace.window_s / TF32_FLOPS
