"""CUDA runtime calls per piece step whose name holds ``Synchronize`` and
that start inside a program span: the host waiting for the device
(``port_bench.spans``)."""

from port_bench.spans import per_step


def read(ctx):
    b = per_step(ctx)
    if b is None:
        return None
    return b["syncs"] / b["steps"]
