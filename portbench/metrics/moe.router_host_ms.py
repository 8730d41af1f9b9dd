"""Host time of one call of the MoE router's top-k (``models.moe.router_topk``,
the schedule executor), over the window's calls outside the profiled
stretch."""


def read(ctx):
    h = ctx.ranges.host.get("moe.router_topk")
    return h.seconds / h.calls * 1e3 if h and h.calls else None
