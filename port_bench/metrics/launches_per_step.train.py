"""Device operations per training step, from the traced window."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or not ctx.trace.launches:
        return None
    return ctx.trace.launches / steps
