"""Device idle milliseconds per piece step while the fit thread's innermost
span was in the optimizer (``step.update``, ``optim.*``;
``port_bench.spans``)."""

from port_bench.spans import per_step


def read(ctx):
    b = per_step(ctx)
    if b is None:
        return None
    return b["idle"].get("optim", 0) / 1e6 / b["steps"]
