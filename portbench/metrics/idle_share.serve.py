"""The share of the profiled stretch in which no operation ran on the
device: 1 - (union of the device's intervals) / (the stretch), in %."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return (1.0 - p.busy_s / p.window_s) * 100.0
