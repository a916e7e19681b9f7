"""Host milliseconds per piece step in the network loss: the self time of the
fit thread's ``loss.*``, ``row_sweep.*`` and ``pairwise.*`` spans and of
``fit.prepare`` (``port_bench.spans``)."""

from port_bench.spans import per_step


def read(ctx):
    b = per_step(ctx)
    if b is None:
        return None
    return b["host"].get("loss", 0) / 1e6 / b["steps"]
