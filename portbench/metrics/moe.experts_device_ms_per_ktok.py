"""Device time of the kernels launched inside the ``moe.expert_ffn`` ranges
of the profiled stretch (the experts' batched products over their
capacity buffers), per 1,000 real prompt tokens prefilled in it."""


def read(ctx):
    p = ctx.profile
    tokens = sum(s.prompt_tokens for s in ctx.profiled_steps())
    if p is None or not tokens or not p.range_device_s.get("moe.expert_ffn"):
        return None
    return p.range_device_s["moe.expert_ffn"] * 1e3 / tokens * 1e3
