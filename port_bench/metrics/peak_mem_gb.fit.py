"""Peak device memory of the run up to the window's end, in GB
(``torch.cuda.max_memory_allocated``, 1e9 bytes)."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 1e9
