"""List Offset Merge Sorter schedule builders (the paper's contribution; a
copy of ``repro.core.loms``).

``loms_2way``   — Section IV: 2 stages (S2MS column merges, then row sorts),
                  any UP-x/DN-y mixture, 2/4/8/... columns.
``loms_kway``   — Section V: k-column k-way merge, alternating column/row
                  stages; stage counts per paper Table 1. k=3 uses the
                  paper's minimal stage-3 (edge-column boundary pair sorts).
``loms_median`` — Section V-A: median of k equal odd lists after only the
                  first two stages (read the center cell).

Every built schedule of modest size is 0-1-validated at construction time
(cached: a schedule is built and checked once a process), so an
incorrect schedule cannot silently escape.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

from .networks import Group, Schedule, Stage, validate_01_merge
from .setup_array import SetupArray, build_2way_setup, build_kway_setup

# Paper Table 1: total alternating column/row sorts for a k-way merge.
_TABLE1 = {2: 2, 3: 3, 4: 4, 5: 4, 6: 5}


def table1_stages(k: int) -> int:
    if k in _TABLE1:
        return _TABLE1[k]
    if 7 <= k <= 14:
        return 6
    raise ValueError(f"paper Table 1 covers k in [2, 14]; got k={k}")


# Validation budget: exhaustive 0-1 merge validation costs prod(len+1)
# patterns; keep it cheap but meaningful.
_VALIDATE_LIMIT = 60_000


def _maybe_validate(sched: Schedule, lens: Sequence[int]) -> Schedule:
    n_pats = 1
    for ln in lens:
        n_pats *= ln + 1
    if n_pats <= _VALIDATE_LIMIT:
        ok = validate_01_merge(sched, lens)
        assert ok, f"schedule {sched.name} failed 0-1 validation for lens={lens}"
    return sched


def _stage1_columns(arr: SetupArray) -> Stage:
    groups = []
    for c in range(arr.n_cols):
        idx, runs = arr.stage1_column_runs(c)
        if len(idx) >= 2 and len(runs) >= 2:
            groups.append(Group(idx=idx, runs=runs))
    return Stage(groups=tuple(groups))


def _row_stage(arr: SetupArray, serpentine: bool) -> Stage:
    groups = []
    for r in range(arr.n_rows):
        asc_r2l = True if not serpentine else (r % 2 == 0)
        idx = arr.row_cells(r, ascending_right_to_left=asc_r2l)
        if len(idx) >= 2:
            groups.append(Group(idx=idx))
    return Stage(groups=tuple(groups))


def _full_column_stage(arr: SetupArray) -> Stage:
    groups = []
    for c in range(arr.n_cols):
        cells = arr.column_cells(c)
        if len(cells) >= 2:
            groups.append(Group(idx=tuple(f for f, _ in cells)))
    return Stage(groups=tuple(groups))


def _edge_pair_column_stage(arr: SetupArray) -> Stage:
    """Paper Fig. 6 stage 3 for 3-way: 2-sorters at the serpentine row
    boundaries, edge columns only (col 0 joins rows (2j+1, 2j+2); the
    leftmost column joins rows (2j, 2j+1))."""
    groups = []
    left = arr.n_cols - 1
    for r in range(0, arr.n_rows - 1, 2):  # rows (2j, 2j+1) at leftmost col
        if arr.populated(r, left) and arr.populated(r + 1, left):
            groups.append(Group(idx=(arr.cell_flat(r, left), arr.cell_flat(r + 1, left))))
    for r in range(1, arr.n_rows - 1, 2):  # rows (2j+1, 2j+2) at col 0
        if arr.populated(r, 0) and arr.populated(r + 1, 0):
            groups.append(Group(idx=(arr.cell_flat(r, 0), arr.cell_flat(r + 1, 0))))
    return Stage(groups=tuple(groups))


@functools.lru_cache(maxsize=None)
def loms_2way(m: int, n: int, n_cols: int = 2) -> Schedule:
    """2-stage UP-m/DN-n List Offset merge in ``n_cols`` columns."""
    arr = build_2way_setup(m, n, n_cols)
    stages = (_stage1_columns(arr), _row_stage(arr, serpentine=False))
    sched = Schedule(
        name=f"loms2way_up{m}_dn{n}_{n_cols}col",
        size=arr.size,
        setup_scatter=arr.setup_scatter(),
        output_gather=arr.rowmajor_output_gather(),
        stages=stages,
        meta=(("kind", "loms2"), ("lens", (m, n)), ("n_cols", n_cols)),
    )
    return _maybe_validate(sched, (m, n))


@functools.lru_cache(maxsize=None)
def loms_kway(lens: Tuple[int, ...], n_stages: Optional[int] = None) -> Schedule:
    """k-way LOMS merge (k = len(lens) columns). ``n_stages`` defaults to
    paper Table 1. Stage 1 = column S2MS merges, stage 2 = serpentine row
    sorts, then alternating column/row sorts. For k == 3 the third stage is
    the paper's minimal edge-column pair sort; other later column stages are
    full column sorts (a validated superset of the paper's unspecified
    minimal extents, as the reference's DESIGN.md §7 says)."""
    lens = tuple(int(x) for x in lens)
    k = len(lens)
    assert k >= 2
    if k == 2:
        return loms_2way(lens[0], lens[1], 2)
    total = n_stages if n_stages is not None else table1_stages(k)
    arr = build_kway_setup(lens)
    stages = [_stage1_columns(arr), _row_stage(arr, serpentine=True)]
    s = 2
    while s < total:
        if s % 2 == 0:  # column stage
            if k == 3 and total == 3:
                stages.append(_edge_pair_column_stage(arr))
            else:
                stages.append(_full_column_stage(arr))
        else:
            stages.append(_row_stage(arr, serpentine=True))
        s += 1
    sched = Schedule(
        name=f"loms{k}way_" + "x".join(map(str, lens)),
        size=arr.size,
        setup_scatter=arr.setup_scatter(),
        output_gather=arr.serpentine_output_gather(),
        stages=tuple(stages),
        meta=(("kind", "lomsk"), ("lens", lens), ("n_cols", k)),
    )
    return _maybe_validate(sched, lens)


@functools.lru_cache(maxsize=None)
def loms_median(lens: Tuple[int, ...]) -> Tuple[Schedule, int]:
    """2-stage median device for k equal odd-length lists (paper §V-A).

    Returns (schedule truncated to 2 stages, output position of the median
    in the schedule's output list). The median sits at the center cell of
    the array after stage 2."""
    lens = tuple(int(x) for x in lens)
    k = len(lens)
    assert k >= 3 and k % 2 == 1, "median early-exit needs odd k"
    assert all(l == lens[0] for l in lens) and lens[0] % 2 == 1, (
        "median early-exit needs equal odd-length lists"
    )
    arr = build_kway_setup(lens)
    stages = (_stage1_columns(arr), _row_stage(arr, serpentine=True))
    gather = arr.serpentine_output_gather()
    center_cell = arr.cell_flat(arr.n_rows // 2, arr.n_cols // 2)
    median_pos = gather.index(center_cell)
    assert median_pos == (sum(lens) - 1) // 2, (median_pos, lens)
    sched = Schedule(
        name=f"loms{k}median_" + "x".join(map(str, lens)),
        size=arr.size,
        setup_scatter=arr.setup_scatter(),
        output_gather=gather,
        stages=stages,
        meta=(("kind", "loms_median"), ("lens", lens), ("n_cols", k)),
    )
    return sched, median_pos
