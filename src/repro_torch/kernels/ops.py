"""Values-only wrappers over the merge, sort and k-way kernels and the
top-k kernels (counterpart of ``repro.kernels.ops`` ``merge2``, ``sort``,
``merge_k``, ``median_k`` and ``topk``).

The planner picks the family, the column count and ``use_mxu``. As in
the reference, float rows go through the kernels raw, in the raw-float
mode (``use_mxu=True``: raw float comparisons and the rule of the
reference's one-hot matrix permute, ``common.onehot_permute``: a ±inf or
NaN turns the other lanes of its permuted vector into NaN, and a -0.0
mostly comes out as +0.0); int32 rows take the exact permute. Prefer ``repro_torch.merge / merge_k / sort
/ median_of_lists``, which sort floats as total-order keys and route as
the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import kway_schedule, median_schedule
from repro_torch.resilience.failpoints import failpoint
from repro_torch.streaming.planner import plan_op

from .kway import kway_merge
from .loms_merge import loms_merge2
from .sort import loms_sort
from .topk import ROUTER_TOPK_MAX, router_topk, topk_tiles, vocab_topk


def _use_mxu(plan, x: torch.Tensor) -> bool:
    """The reference's ``plan.use_mxu and use_mxu_for(dtype)``."""
    return plan.use_mxu and x.dtype.is_floating_point


def merge2(a: torch.Tensor, b: torch.Tensor, *, n_cols: int = 2,
           kind: str = "loms") -> torch.Tensor:
    """Merge the sorted rows (B, m) and (B, n). ``kind`` names a
    registered family; for loms, ``n_cols`` must divide both lengths."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("merge2 takes (B, m) and (B, n) rows")
    failpoint("kernel.launch.merge2")
    m, n = a.shape[-1], b.shape[-1]
    if kind != "loms":
        # the reference's default use_mxu=True; the port's int32 rows keep
        # the exact permute (the reference's float32 matrix permute of
        # integers is exact only below 2**24)
        return loms_merge2(a, b, network=kind, use_mxu=a.dtype.is_floating_point)[0]
    if m % n_cols or n % n_cols:  # no kernel layout: the schedule executor
        from repro_torch.api import schedules

        return schedules.merge(a, b, n_cols=n_cols)
    plan = plan_op("merge2", (m, n), batch=a.shape[0], dtype=a.dtype)
    return loms_merge2(a, b, network=plan.network, n_cols=n_cols,
                       use_mxu=_use_mxu(plan, a))[0]


def sort(x: torch.Tensor) -> torch.Tensor:
    """Sort every row of (B, n) in one launch of the fused sort."""
    if x.ndim != 2:
        raise ValueError("sort takes (B, n) rows")
    failpoint("kernel.launch.sort")
    plan = plan_op("sort", (x.shape[-1],), batch=x.shape[0], dtype=x.dtype)
    return loms_sort(x, network=plan.network, use_mxu=_use_mxu(plan, x))[0]


def merge_k(lists: Sequence[torch.Tensor]) -> torch.Tensor:
    """Merge the sorted rows (B, len_i) of k lists in one launch of the
    k-way kernel on ``kway_schedule(lens)``."""
    failpoint("kernel.launch.merge_k")
    lens = tuple(int(t.shape[-1]) for t in lists)
    x = torch.cat(list(lists), dim=-1).contiguous()
    plan = plan_op("kway", lens, batch=x.shape[0], dtype=x.dtype)
    return kway_merge(x, kway_schedule(lens), use_mxu=_use_mxu(plan, x))[0]


@functools.lru_cache(maxsize=None)
def median_readout(sched, pos: int):
    """The median device reading out only its center cell: the same
    stages, one output (the reference reads all and slices ``[..., pos]``;
    the kernel then writes one value a row instead of all of them)."""
    return dataclasses.replace(sched, name=f"{sched.name}_center",
                               output_gather=(sched.output_gather[pos],))


def median_k(lists: Sequence[torch.Tensor]) -> torch.Tensor:
    """Median (B,) of k equal odd-length sorted rows after the two LOMS
    stages, in one launch of the k-way kernel."""
    failpoint("kernel.launch.median")
    lens = tuple(int(t.shape[-1]) for t in lists)
    sched, pos = median_schedule(lens)
    x = torch.cat(list(lists), dim=-1).contiguous()
    plan = plan_op("kway", lens, batch=x.shape[0], dtype=x.dtype)
    return kway_merge(x, median_readout(sched, pos), use_mxu=_use_mxu(plan, x))[0][:, 0]


def topk(x: torch.Tensor, k: int, *, block: Optional[int] = None, zero_ties: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k with int32 indices over the last axis of (B, E)
    float or int32 rows: the router kernel (row 3) for E <= 512, the vocab
    kernels (rows 4 and 5) above; ``block`` defaults to the planner's.
    ``zero_ties`` (``nan_policy="unsafe"``): -0.0 and +0.0 tie."""
    failpoint("kernel.launch.topk")
    return topk_rows(x, k, block=block, zero_ties=zero_ties)


def topk_rows(x: torch.Tensor, k: int, *, block: Optional[int] = None,
              zero_ties: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk` without its ``kernel.launch.topk`` seam: the fused
    top-k rung's launch, which has a seam of its own."""
    if x.ndim != 2:
        raise ValueError("topk takes (B, E) rows")
    bsz, e = x.shape
    plan = plan_op("topk", (e,), batch=bsz, dtype=x.dtype, k=k)
    blk = topk_tiles(bsz, e, block=block or plan.block)[0]
    x = x.contiguous()
    if e <= ROUTER_TOPK_MAX:
        return router_topk(x, k, block=blk, zero_ties=zero_ties)
    return vocab_topk(x, k, block=blk, zero_ties=zero_ties)
