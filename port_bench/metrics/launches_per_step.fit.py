"""Device operations per piece step (one vmapped fit step of all the
piece's lanes), from the traced window."""


def read(ctx):
    steps = ctx.counters.get("pieces", 0) * ctx.counters.get("steps_per_piece", 0)
    if not steps or not ctx.trace.launches:
        return None
    return ctx.trace.launches / steps
