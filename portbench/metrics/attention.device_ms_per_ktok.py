"""Device time of the kernels launched inside the ``attention.prefill``
ranges of the profiled stretch (the GQA sublayer at prefill: projections,
norms, RoPE, the chunked softmax, the output product), per 1,000 real
prompt tokens prefilled in it."""


def read(ctx):
    p = ctx.profile
    tokens = sum(s.prompt_tokens for s in ctx.profiled_steps())
    if p is None or not tokens or not p.range_device_s.get("attention.prefill"):
        return None
    return p.range_device_s["attention.prefill"] * 1e3 / tokens * 1e3
