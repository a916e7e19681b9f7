"""Device milliseconds per training step of the transfer-sweep kernels
(B3/B4: ``transfer_sweep_kernel``, the narrow route, and
``transfer_wide_kernel``, the wide one), from the traced window."""

NAMES = ("transfer_sweep_kernel", "transfer_wide_kernel")


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    sweep_s = ctx.trace.seconds_of(lambda name: any(k in name for k in NAMES))
    if not steps or not sweep_s:
        return None
    return sweep_s * 1e3 / steps
