"""Milliseconds per piece step in which some operation ran on the device
(the union of the traced device operations' intervals)."""


def read(ctx):
    steps = ctx.counters.get("pieces", 0) * ctx.counters.get("steps_per_piece", 0)
    busy = ctx.trace.busy_s
    if not steps or not busy:
        return None
    return busy * 1e3 / steps
