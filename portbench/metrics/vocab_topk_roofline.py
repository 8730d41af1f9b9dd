"""The vocab top-k kernels (rows 4-5: ``vocab_phase1_kernel``,
``vocab_merge_tree_kernel``) against their roofline over the profiled
stretch: the least time, each logits row read once and its k values and
int32 ids written once at the HBM peak, over the kernels' device time, in %."""
from portbench.work import PEAK_HBM_BYTES_PER_S, topk_bytes


def read(ctx):
    p = ctx.profile
    launches = ctx.ranges.vocab_launches
    if p is None or not launches:
        return None
    dev = sum(t for name, t in p.kernel_s.items()
              if "vocab_phase1" in name or "vocab_merge" in name)
    if dev <= 0:
        return None
    moved = sum(topk_bytes(*launch) for launch in launches)
    return moved / PEAK_HBM_BYTES_PER_S / dev * 100.0
