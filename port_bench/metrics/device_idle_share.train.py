"""Share of the traced window in which no operation ran on the device, in %."""


def read(ctx):
    if not ctx.trace.launches or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
