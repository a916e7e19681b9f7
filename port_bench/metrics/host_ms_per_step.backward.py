"""Host milliseconds per piece step in the loss's backward pass: the self
time of ``step.grad``, where the fit thread waits while autograd runs the
backward (``port_bench.spans``)."""

from port_bench.spans import per_step


def read(ctx):
    b = per_step(ctx)
    if b is None:
        return None
    return b["host"].get("backward", 0) / 1e6 / b["steps"]
