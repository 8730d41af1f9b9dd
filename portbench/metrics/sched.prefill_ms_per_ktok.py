"""The ``sched.prefill`` spans (each ends after the device finished the
batch's logits) summed over the window's unprofiled steps, per 1,000 real
prompt tokens of those steps."""


def read(ctx):
    spans = ctx.spans("sched.prefill")
    tokens = sum(s.prompt_tokens for s in ctx.steps())
    if not spans or not tokens:
        return None
    return sum(sp.dur_ns for sp in spans) * 1e-6 / tokens * 1e3
