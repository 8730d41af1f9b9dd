"""Batcher Odd-Even Merge Sort and Bitonic Merge Sort baselines (a copy of
``repro.core.batcher``: pure Python, the schedules the executor runs).

These are the paper's state-of-the-art 2-way comparison points. Both are
multistage 2-sorter networks with depth log2(m+n) for a 2-way merge of
power-of-two lists (vs LOMS's fixed 2 stages). As the paper notes, Batcher
devices are only straightforward for equal power-of-two list sizes; we
implement exactly that case and raise otherwise.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

from .networks import Group, Schedule, Stage


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def _pack_stages(comparators: List[Tuple[int, int]]) -> Tuple[Stage, ...]:
    """ASAP level-schedule. Comparator lists from the recursions below are
    emitted in dependency order (dependencies only exist through shared
    cells), so scheduling each comparator right after the last prior use of
    either cell attains the canonical network depth."""
    last_used: dict = {}
    stages: List[List[Group]] = []
    for a, b in comparators:
        s = max(last_used.get(a, -1), last_used.get(b, -1)) + 1
        while len(stages) <= s:
            stages.append([])
        stages[s].append(Group(idx=(a, b)))
        last_used[a] = s
        last_used[b] = s
    return tuple(Stage(groups=tuple(gs)) for gs in stages)


def _oddeven_merge_comparators(lo: int, n: int, r: int, out: List[Tuple[int, int]]):
    """Batcher odd-even merge of the n power-of-two cells starting at lo,
    assuming halves sorted."""
    step = r * 2
    if step < n:
        _oddeven_merge_comparators(lo, n, step, out)
        _oddeven_merge_comparators(lo + r, n, step, out)
        i = lo + r
        while i + r < lo + n:
            out.append((i, i + r))
            i += step
    else:
        out.append((lo, lo + r))


@functools.lru_cache(maxsize=None)
def oems_merge(m: int, n: int) -> Schedule:
    """Batcher Odd-Even 2-way merge of two sorted power-of-two lists."""
    if m != n or not _is_pow2(m):
        raise ValueError(
            "Batcher odd-even merge implemented for equal power-of-two lists "
            f"only (paper §VI); got UP-{m}/DN-{n}"
        )
    total = m + n
    comps: List[Tuple[int, int]] = []
    _oddeven_merge_comparators(0, total, 1, comps)
    return Schedule(
        name=f"oems_up{m}_dn{n}",
        size=total,
        setup_scatter=tuple(range(total)),
        output_gather=tuple(range(total)),
        stages=_pack_stages(comps),
        meta=(("kind", "oems"), ("lens", (m, n))),
    )


@functools.lru_cache(maxsize=None)
def bitonic_merge(m: int, n: int) -> Schedule:
    """Batcher bitonic 2-way merge: B is written reversed (descending) so
    [A, reversed(B)] is bitonic, then log2(m+n) halving stages."""
    if m != n or not _is_pow2(m):
        raise ValueError(
            "bitonic merge implemented for equal power-of-two lists only "
            f"(paper §VI); got UP-{m}/DN-{n}"
        )
    total = m + n
    # setup: A identity; B reversed
    setup = tuple(range(m)) + tuple(range(total - 1, m - 1, -1))
    comps: List[Tuple[int, int]] = []
    d = total // 2
    while d >= 1:
        for i in range(total):
            if (i % (2 * d)) < d:
                comps.append((i, i + d))
        d //= 2
    return Schedule(
        name=f"bitonic_up{m}_dn{n}",
        size=total,
        setup_scatter=setup,
        output_gather=tuple(range(total)),
        stages=_pack_stages(comps),
        meta=(("kind", "bitonic"), ("lens", (m, n))),
    )


def _oddeven_sort_comparators(lo: int, n: int, out: List[Tuple[int, int]]):
    if n <= 1:
        return
    h = n // 2
    _oddeven_sort_comparators(lo, h, out)
    _oddeven_sort_comparators(lo + h, h, out)
    _oddeven_merge_comparators(lo, n, 1, out)


@functools.lru_cache(maxsize=None)
def oems_sort(n: int) -> Schedule:
    """Full Batcher odd-even merge sort of n (power-of-two) unsorted values."""
    if not _is_pow2(n):
        raise ValueError(f"odd-even merge sort needs power-of-two n, got {n}")
    comps: List[Tuple[int, int]] = []
    _oddeven_sort_comparators(0, n, comps)
    return Schedule(
        name=f"oems_sort{n}",
        size=n,
        setup_scatter=tuple(range(n)),
        output_gather=tuple(range(n)),
        stages=_pack_stages(comps),
        meta=(("kind", "oems_sort"), ("lens", (n,))),
    )


@functools.lru_cache(maxsize=None)
def bitonic_sort(n: int) -> Schedule:
    """Full bitonic sort of n (power-of-two) unsorted values."""
    if not _is_pow2(n):
        raise ValueError(f"bitonic sort needs power-of-two n, got {n}")
    comps: List[Tuple[int, int]] = []
    k = 2
    while k <= n:
        d = k // 2
        while d >= 1:
            for i in range(n):
                j = i ^ d
                if j > i:
                    # ascending blocks of size k; descending handled by
                    # orienting the comparator
                    if (i & k) == 0:
                        comps.append((i, j))
                    else:
                        comps.append((j, i))
            d //= 2
        k *= 2
    # comparators with reversed orientation: Group idx order encodes
    # ascending output, so (j, i) already expresses the descending pair.
    return Schedule(
        name=f"bitonic_sort{n}",
        size=n,
        setup_scatter=tuple(range(n)),
        output_gather=tuple(range(n)),
        stages=_pack_stages(comps),
        meta=(("kind", "bitonic_sort"), ("lens", (n,))),
    )
