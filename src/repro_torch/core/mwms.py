"""Multiway Merge Sort (MWMS) baseline — paper refs [4][5] (a copy of
``repro.core.mwms``).

The paper uses Kent & Pattichis' earlier Multiway Merge Sorting Networks as
the k-way state of the art: k sorted lists arranged WITHOUT the list offset
(each list is simply one column), merged by alternating stages of parallel
single-stage row sorters and column sorters into serpentine order. Without
the offset setup, more alternating stages are needed — the paper reports 5
stages for a full 3c_7r merge and 4 for its median (vs 3 / 2 for LOMS).

We reconstruct the device generically: build the non-offset array, then add
alternating row/column sort stages until the network passes exhaustive 0-1
validation. For 3c_7r this reconstruction needs 6 full-merge stages (5 for
the median) — one more than the published device (an exhaustive search over
row/column/diagonal stage families found no 5-stage non-offset network, so
the original must use a group structure beyond plain row/col sorts). The
comparison tables therefore report both our reconstruction (6/5) and the
published counts (5/4); LOMS wins against either.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from .networks import Group, Schedule, Stage, validate_01_merge
from .setup_array import HOLE, SetupArray


def _non_offset_array(lens: Tuple[int, ...]) -> SetupArray:
    """Column c holds list c, ascending bottom->top, bottom-aligned."""
    k = len(lens)
    rows = max(lens)
    grid = []
    for r in range(rows):
        row = []
        for c in range(k):
            # column index 0 is rightmost; put list 0 in the LEFTMOST column
            lst = k - 1 - c
            row.append((lst, r) if r < lens[lst] else HOLE)
        grid.append(tuple(row))
    return SetupArray(lens=tuple(lens), n_cols=k, grid=tuple(grid))


def _row_stage(arr: SetupArray) -> Stage:
    groups = []
    for r in range(arr.n_rows):
        idx = arr.row_cells(r, ascending_right_to_left=(r % 2 == 0))
        if len(idx) >= 2:
            groups.append(Group(idx=idx))
    return Stage(groups=tuple(groups))


def _col_stage(arr: SetupArray) -> Stage:
    groups = []
    for c in range(arr.n_cols):
        cells = arr.column_cells(c)
        if len(cells) >= 2:
            groups.append(Group(idx=tuple(f for f, _ in cells)))
    return Stage(groups=tuple(groups))


@functools.lru_cache(maxsize=None)
def mwms_kway(lens: Tuple[int, ...], max_stages: int = 12) -> Schedule:
    """Non-offset k-way merge network; stage count found by 0-1 validation."""
    lens = tuple(int(x) for x in lens)
    arr = _non_offset_array(lens)
    stages = []
    for s in range(max_stages):
        stages.append(_row_stage(arr) if s % 2 == 0 else _col_stage(arr))
        cand = Schedule(
            name=f"mwms{len(lens)}way_" + "x".join(map(str, lens)),
            size=arr.size,
            setup_scatter=arr.setup_scatter(),
            output_gather=arr.serpentine_output_gather(),
            stages=tuple(stages),
            meta=(("kind", "mwms"), ("lens", lens), ("n_cols", len(lens))),
        )
        if validate_01_merge(cand, lens):
            return cand
    raise RuntimeError(f"MWMS reconstruction did not converge for lens={lens}")


@functools.lru_cache(maxsize=None)
def mwms_median(lens: Tuple[int, ...]) -> Tuple[Schedule, int]:
    """Median via the MWMS device, truncated to the fewest stages whose
    center output is already correct for every 0-1 pattern (the paper
    reports 4 stages for 3c_7r)."""
    from .networks import _per_list_sorted_01_patterns, apply_schedule_np

    full = mwms_kway(lens)
    med = (sum(lens) - 1) // 2
    pats = _per_list_sorted_01_patterns(lens)
    want = np.sort(pats, axis=-1)[:, med]
    for n_stages in range(1, len(full.stages) + 1):
        got = apply_schedule_np(full, pats, n_stages)[:, med]
        if (got == want).all():
            sched = Schedule(
                name=full.name + f"_median{n_stages}",
                size=full.size,
                setup_scatter=full.setup_scatter,
                output_gather=full.output_gather,
                stages=full.stages[:n_stages],
                meta=full.meta + (("median_stages", n_stages),),
            )
            return sched, med
    raise RuntimeError("median truncation failed")
