"""Model FLOPs of the window's unprofiled steps (``portbench.work``: the
weights each real token runs through, causal attention over its keys, the
output head where a token is sampled; no pads) over those steps' wall
time at the bf16 dense peak, in %."""
from portbench.work import PEAK_BF16_FLOPS


def read(ctx):
    steps = ctx.steps()
    wall = sum(s.t1 - s.t0 for s in steps)
    if not steps or wall <= 0:
        return None
    return sum(s.flops for s in steps) / (wall * PEAK_BF16_FLOPS) * 100.0
