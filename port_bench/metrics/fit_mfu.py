"""The whole fit's share of the card's peak, in %: the frozen FLOPs of a
lane step (``counts.BRICK_8X5_LANE_STEP_FLOPS`` for the 8 × 5 wall, kept
in the configuration) times the useful lane-steps of the traced window,
over the window's length, over the TF32 peak."""

from port_bench.peaks import TF32_FLOPS


def read(ctx):
    c = ctx.counters
    if not c.get("useful_lane_steps") or not ctx.trace.launches:
        return None
    return 100.0 * c["flops_per_lane_step"] * c["useful_lane_steps"] / ctx.trace.window_s / TF32_FLOPS
