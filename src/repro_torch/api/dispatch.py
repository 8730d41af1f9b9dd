"""Route selection for the library's entry points (counterpart of
``repro.api.dispatch``, its rules for ``sort``, ``merge``, ``merge_k``,
``median`` and ``topk``).

``plan(spec)`` maps a :class:`~repro_torch.api.spec.SortSpec` to a
:class:`Decision`: which route runs the problem and why. The rules are
the reference's decision table with its accelerator rows ("TPU") for
``"cuda"``, and ``pallas`` named ``cuda``:

  op     condition                                  route      detail
  -----  -----------------------------------------  ---------  ---------------
  topk   cuda, axis > 512                           cuda       vocab_topk
  topk   cuda, axis <= 512                          cuda       router_topk
  topk   otherwise                                  schedule   blockwise_topk
  sort   cuda, fits the budget, not stable          cuda       loms_sort_fused
  sort   otherwise (stable / over budget / not cuda) schedule  loms_merge_tree
  merge  payload, cuda, fits, not stable            cuda       fused_payload
  merge  payload / stable otherwise                 schedule   payload
  merge  a network other than loms                  schedule   network
  merge  no common column count                     schedule   ragged
  merge  working set past the budget                streaming  chunked_merge
  merge  cuda, fits the budget                      cuda       loms_merge2
  merge  otherwise                                  schedule   loms_2way
  merge_k the payload / stable / network rows of merge
  merge_k total^2 cloud past the budget             streaming  chunked_merge_k
  merge_k cuda, fits the budget                     cuda       kway_merge
  merge_k otherwise                                 schedule   loms_kway
  median cuda, loms, equal odd lists                cuda       kway_median
  median otherwise                                  schedule   loms_median

The budget is the reference's routing budget (``streaming.planner``).
Not ported: the measured-cost override, the breaker reroute and the obs
counters (ROADMAP Queue 1, items 4 and 8), the sharded rows (item 9),
the segmented rows (the port's ``segment_*`` route themselves) and
explicit ``backend=`` asks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.topk import ROUTER_TOPK_MAX

from .fused import dtype_of, fused_eligible
from .spec import BACKEND_AUTO, SortSpec


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routing outcome: route, kernel detail, reason."""

    backend: str
    detail: str = ""
    reason: str = ""


def _merge2_fits(spec: SortSpec) -> bool:
    from repro_torch.streaming.planner import fits_vmem

    m, n = spec.lengths[0], sum(spec.lengths[1:])
    return fits_vmem(m, n, dtype=dtype_of(spec.dtype))


def _median_on_card(spec: SortSpec) -> bool:
    """The kernel median is the LOMS device of equal odd-length lists."""
    return (spec.network == "loms" and len(set(spec.lengths)) == 1
            and spec.lengths[0] % 2 == 1)


def plan(spec: SortSpec) -> Decision:
    """Resolve the route of one problem. Pure function of ``spec``."""
    if spec.backend != BACKEND_AUTO:
        raise NotImplementedError(
            f"backend={spec.backend!r}: explicit backends are not ported "
            "(ROADMAP Queue 1, item 4)")
    if spec.segmented or spec.sharded:
        raise NotImplementedError(
            "segmented and sharded specs do not route through plan() in the "
            "port (ROADMAP Queue 1, items 4 and 9)")
    on_card = spec.device == "cuda"
    if spec.op == "topk":
        if on_card:
            if spec.total > ROUTER_TOPK_MAX:
                return Decision("cuda", "vocab_topk",
                                f"axis {spec.total} > {ROUTER_TOPK_MAX}: two-phase "
                                "block kernel + truncated merge levels")
            return Decision("cuda", "router_topk",
                            f"axis {spec.total} <= {ROUTER_TOPK_MAX}: single-kernel "
                            "blockwise top-k")
        return Decision("schedule", "blockwise_topk", f"{spec.device} host")
    if spec.op == "sort":
        if on_card and fused_eligible(spec):
            return Decision("cuda", "loms_sort_fused",
                            "fits the budget: single-launch fused merge-tree sort")
        return Decision("schedule", "loms_merge_tree",
                        "stable / over the budget / not on the card: the "
                        "schedule executor")
    if spec.op == "median":
        if on_card and _median_on_card(spec):
            return Decision("cuda", "kway_median", "equal odd lists: the two-stage "
                            "device in one launch of the k-way kernel")
        return Decision("schedule", "loms_median", "schedule executor median")
    if spec.needs_perm:
        if on_card and fused_eligible(spec):
            return Decision("cuda", "fused_payload",
                            "fits the budget: the payload rides the kernel's "
                            "permutation (single fused launch)")
        return Decision("schedule", "payload",
                        "payload/stable needs the permutation-carrying executor")
    if spec.network != "loms":
        return Decision("schedule", "network",
                        f"network {spec.network!r}: the schedule executor")
    if spec.op == "merge":
        if spec.ragged2:
            return Decision("schedule", "ragged",
                            "no common column count divides both lists")
        if not _merge2_fits(spec):
            return Decision("streaming", "chunked_merge",
                            "working set past the budget: the grid merge")
        if on_card:
            return Decision("cuda", "loms_merge2", "fits the budget")
        return Decision("schedule", "loms_2way", f"{spec.device} host")
    from repro_torch.streaming.planner import kway_fits_vmem

    if not kway_fits_vmem(spec.total):
        return Decision("streaming", "chunked_merge_k",
                        "comparison cloud past the budget: the merge-path tiled k-way "
                        "merge")
    if on_card:
        return Decision("cuda", "kway_merge", "fits the budget")
    return Decision("schedule", "loms_kway", f"{spec.device} host")
