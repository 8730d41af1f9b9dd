"""The merge planner: which route, family, column count and tile a merge,
k-way merge or sort takes (the part of ``repro.streaming.planner`` the
library's ``merge``, ``merge_k`` and ``sort`` need).

The closed-form heuristics are the reference's, and so is the budget the
working-set predicates are held to. That budget is **the reference's
routing budget**, not a limit of the card: it decides whether a merge is
one fused launch or streams through the grid merge, and whether a sort
is one fused launch at all, and with the route the family and the column
count that fix the tie order of payload lanes. Any other cutover would
give other permutations than the reference for the shapes in between, so
it is kept verbatim. The CUDA kernels have their own limits (shared
memory, a global scratch past it) and meet every shape the budget admits.

There is no autotune cache (ROADMAP Queue 1, item 4): every plan is the
heuristic one, the plan the reference makes under an empty cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.kernels.common import ceil_pow2
from repro_torch.networks import pick_merge_cols

#: the reference's routing budget (``_VMEM_BUDGET``, 8 MiB): the working
#: set its predicates compare against, kept for parity of routes
ROUTING_BUDGET = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """Resolved knobs for one sort or merge (the reference's ``MergePlan``
    without ``block_batch``, ``block`` and the measured time: a CUDA
    kernel takes a row, or a few narrow rows, a CTA)."""

    kind: str = "loms"  # 'loms' (the kernels) | 'schedule' (the executor)
    n_cols: int = 2
    network: str = "loms"
    #: the reference's one-hot matrix permute of raw floats: True for a
    #: float dtype, as every heuristic of the reference plans it (the
    #: values-only wrappers of ``kernels.ops`` take it)
    use_mxu: bool = True
    tile: int = 512  # the streaming merge's tile


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _vmem_bytes_merge2(m: int, n: int, n_cols: int, block_batch: int,
                       dtype: torch.dtype) -> int:
    """The reference's working set of the 2-way merge kernel."""
    it = max(_itemsize(dtype), 4)
    vals = (m + n) * it
    cloud = (m // n_cols) * (n // n_cols) * 4  # widest column S2MS matrix
    rows = ((m + n) // n_cols) * n_cols * n_cols * 4  # row-sort matrices
    return block_batch * (vals + cloud + rows)


def _vmem_bytes_sort(n: int, block_batch: int, dtype: torch.dtype) -> int:
    """The reference's working set of the fused sort kernel: the widest
    level's rank cloud and the value and position lanes."""
    it = max(_itemsize(dtype), 4)
    npad = ceil_pow2(n)
    cloud = (npad // 2) * (npad // 2) * 4 * 2
    lanes = npad * (it + 4) * 2
    return block_batch * (cloud + lanes)


def fits_vmem(m: int, n: int, *, n_cols: int = 2, block_batch: int = 1,
              dtype: torch.dtype = torch.float32) -> bool:
    """The reference's fused-merge vs streaming cutover."""
    return _vmem_bytes_merge2(m, n, n_cols, block_batch, dtype) <= ROUTING_BUDGET


def sort_fits_vmem(n: int, *, block_batch: int = 1,
                   dtype: torch.dtype = torch.float32) -> bool:
    """The reference's fused-sort vs schedule-executor cutover."""
    return _vmem_bytes_sort(n, block_batch, dtype) <= ROUTING_BUDGET


def kway_fits_vmem(total: int) -> bool:
    """The reference's fused k-way merge vs streaming cutover: its kernel
    materialises a total² float32 comparison cloud a row, so total² · 4
    bytes within the budget (total <= 1,448)."""
    return total * total * 4 <= ROUTING_BUDGET


def plan_merge2(m: int, n: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """One UP-m/DN-n merge: the column count nearest the comparator-cost
    optimum among the common divisors (``pick_merge_cols``); none: the
    schedule executor."""
    n_cols = pick_merge_cols(m, n)
    use_mxu = dtype.is_floating_point
    if n_cols == 1:
        return MergePlan(kind="schedule", n_cols=2, use_mxu=use_mxu)
    return MergePlan(kind="loms", n_cols=n_cols, use_mxu=use_mxu)


def plan_sort(n: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """The fused sort: the loms family's merge tree at ``ceil_pow2(n)``."""
    return MergePlan(kind="loms", n_cols=2, use_mxu=dtype.is_floating_point)


def plan_chunked(total_a: int, total_b: int, *, batch: int = 1,
                 dtype: torch.dtype = torch.float32,
                 tile: Optional[int] = None) -> MergePlan:
    """The streaming merge: the largest tile (512 down to 32) whose
    carry-and-tile merge fits the budget across the whole batch."""
    if tile is None:
        tile = 512
        while tile > 32 and _vmem_bytes_merge2(tile, tile, 2, max(batch, 1),
                                               dtype) > ROUTING_BUDGET:
            tile //= 2
    tile = max(2, tile - (tile % 2))
    return dataclasses.replace(plan_merge2(tile, tile, dtype), tile=tile)


def plan_kway(total: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """The fused k-way merge: the schedule's own wiring, nothing to pick
    (the reference's plan only sizes its batch tile)."""
    return MergePlan(kind="loms", n_cols=2, use_mxu=dtype.is_floating_point)


def plan_chunked_k(lens: Sequence[int], *, batch: int = 1,
                   dtype: torch.dtype = torch.float32,
                   tile: Optional[int] = None) -> MergePlan:
    """The k-way streaming merge: k tile segments an output tile, the
    largest tile (128 down to 16) whose (k · tile)² cloud fits the budget
    across the whole batch."""
    k = len(lens)
    if tile is None:
        tile = 128
        while tile > 16 and max(batch, 1) * (k * tile) * (k * tile) * 4 > ROUTING_BUDGET:
            tile //= 2
    return MergePlan(kind="schedule", n_cols=k, use_mxu=dtype.is_floating_point,
                     tile=int(tile))


_HEURISTICS = {
    "merge2": lambda lengths, batch, dtype: plan_merge2(lengths[0], lengths[1], dtype),
    "sort": lambda lengths, batch, dtype: plan_sort(lengths[0], dtype),
    "kway": lambda lengths, batch, dtype: plan_kway(sum(lengths), dtype),
    "chunked2": lambda lengths, batch, dtype: plan_chunked(lengths[0], lengths[1],
                                                           batch=batch, dtype=dtype),
    "chunked_k": lambda lengths, batch, dtype: plan_chunked_k(lengths, batch=batch,
                                                              dtype=dtype),
}


def plan_op(op: str, lengths: Sequence[int], *, batch: int = 8,
            dtype: torch.dtype = torch.float32) -> MergePlan:
    """The plan of one kernel problem: the closed-form heuristic (the
    reference's ``plan_op`` on a cache miss)."""
    if op not in _HEURISTICS:
        raise ValueError(f"plan_op: unknown op {op!r}; known: {sorted(_HEURISTICS)}")
    return _HEURISTICS[op](tuple(int(x) for x in lengths), batch, dtype)
