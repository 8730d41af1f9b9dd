"""``torch.cuda.max_memory_allocated()`` over the window (reset as it
opens), in GB of 1e9 bytes."""


def read(ctx):
    return ctx.peak_window_bytes / 1e9 if ctx.peak_window_bytes else None
