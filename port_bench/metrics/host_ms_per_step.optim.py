"""Host milliseconds per piece step in the optimizer: ``step.update`` with
the ``optim.*`` spans inside it, waits on the device included
(``port_bench.spans``)."""

from port_bench.spans import per_step


def read(ctx):
    b = per_step(ctx)
    if b is None:
        return None
    return b["host"].get("optim", 0) / 1e6 / b["steps"]
