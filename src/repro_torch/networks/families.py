"""Comparator-network family generators (a copy of
``repro.networks.families``, pure Python and numpy).

Each family turns a static merge shape ``(m, n)`` (or a pow2 sort width
``w``) into a :class:`~repro_torch.networks.program.MergeProgram` /
``SortProgram``:

``loms``
    The paper's List Offset Merge Sorter column device; the column count
    is :func:`pick_merge_cols` (nearest ``sqrt(m*n/(m+n))`` among the
    common divisors). The sort tree uses the S2MS level below runs of 64
    and the column device from 64 up.
``s2ms``
    The single-stage stable rank-merge (lo wins ties).
``periodic3``
    A 3-periodic merging network (reflect, even brick, odd brick) repeated
    the minimal number of times that an exhaustive 0-1 check proves
    enough; total width at most :data:`PERIODIC3_MAX_WIDTH`.
``bitonic``
    Batcher's bitonic merger: ``[lo, reverse(hi)]`` then log2(m+n)
    xor-halver stages (pow2 total).

Kernels take programs through :mod:`repro_torch.networks.registry`.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from .program import MergeProgram, PairStage, SortProgram

__all__ = [
    "divisor_cols",
    "pick_merge_cols",
    "PERIODIC3_MAX_WIDTH",
    "BUILTIN_FAMILIES",
]

#: total-width cap for the 3-periodic family: the simple reflect+brick
#: period needs O(m) periods in the worst case, so past this the network
#: is too deep to ever win a tournament (and slow to even generate).
PERIODIC3_MAX_WIDTH = 64


def divisor_cols(m: int, n: int) -> Tuple[int, ...]:
    """All feasible LOMS column counts: common divisors >= 2 of (m, n)."""
    g = math.gcd(int(m), int(n))
    return tuple(c for c in range(2, g + 1) if g % c == 0)


def pick_merge_cols(m: int, n: int) -> int:
    """Feasible LOMS column count nearest the comparator-cost optimum
    ``C* = sqrt(m*n/(m+n))`` (1 when the runs share no divisor >= 2).

    Candidates are the actual common divisors of ``(m, n)`` — not a
    hardcoded pow2 list — so non-pow2 runs (the paper's UP-7/DN-7 3-way
    example) get a real column device too."""
    cols = divisor_cols(m, n)
    if not cols:
        return 1
    c_star = (m * n / max(m + n, 1)) ** 0.5
    return min(cols, key=lambda c: abs(c - c_star))


def _per_list_sorted_01_patterns(lens) -> np.ndarray:
    """All 0-1 inputs whose lists are each sorted ascending (a copy of
    ``repro.core.networks._per_list_sorted_01_patterns``): the prod(len+1)
    patterns the 0-1 principle needs for a merge network."""
    parts = []
    for ln in lens:
        parts.append(np.asarray([[0] * (ln - ones) + [1] * ones
                                 for ones in range(ln + 1)], dtype=np.int32))
    grids = np.meshgrid(*[np.arange(p.shape[0]) for p in parts], indexing="ij")
    idxs = [g.reshape(-1) for g in grids]
    return np.concatenate([p[i] for p, i in zip(parts, idxs)], axis=-1)


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


# ---------------------------------------------------------------------------
# loms / s2ms (column-device kinds)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _loms_merge(m: int, n: int, n_cols=None) -> MergeProgram:
    c = pick_merge_cols(m, n) if n_cols is None else int(n_cols)
    if c > 1 and (m % c or n % c):
        raise ValueError(f"n_cols={c} does not divide runs ({m}, {n})")
    return MergeProgram(family="loms", m=m, n=n, kind="columns", n_cols=c)


def _loms_merge_capable(m: int, n: int) -> bool:
    return m >= 1 and n >= 1


@functools.lru_cache(maxsize=None)
def _loms_sort(w: int) -> SortProgram:
    """LOMS merge tree with the column-device cutover: runs below 64 use
    the plain S2MS (C=1) level, wider runs take the 2-stage column
    device at the divisor-optimal count."""
    assert _is_pow2(w), w
    levels, run = [], 1
    while run < w:
        c = pick_merge_cols(run, run) if run >= 64 else 1
        levels.append(MergeProgram(family="loms", m=run, n=run,
                                   kind="columns", n_cols=c))
        run *= 2
    return SortProgram(family="loms", width=w, levels=tuple(levels))


@functools.lru_cache(maxsize=None)
def _s2ms_merge(m: int, n: int, n_cols=None) -> MergeProgram:
    return MergeProgram(family="s2ms", m=m, n=n, kind="columns", n_cols=1)


@functools.lru_cache(maxsize=None)
def _s2ms_sort(w: int) -> SortProgram:
    assert _is_pow2(w), w
    levels, run = [], 1
    while run < w:
        levels.append(MergeProgram(family="s2ms", m=run, n=run,
                                   kind="columns", n_cols=1))
        run *= 2
    return SortProgram(family="s2ms", width=w, levels=tuple(levels))


# ---------------------------------------------------------------------------
# bitonic (Batcher baseline, pairs kind)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bitonic_merge(m: int, n: int, n_cols=None) -> MergeProgram:
    total = m + n
    if not _is_pow2(total):
        raise ValueError(f"bitonic merge needs pow2 total, got {m}+{n}")
    stages, d = [], total // 2
    while d >= 1:
        stages.append(PairStage(kind="xor", d=d))
        d //= 2
    return MergeProgram(family="bitonic", m=m, n=n, kind="pairs",
                        reverse_hi=True, stages=tuple(stages))


def _bitonic_merge_capable(m: int, n: int) -> bool:
    return m >= 1 and n >= 1 and _is_pow2(m + n)


@functools.lru_cache(maxsize=None)
def _bitonic_sort(w: int) -> SortProgram:
    assert _is_pow2(w), w
    levels, run = [], 1
    while run < w:
        levels.append(_bitonic_merge(run, run))
        run *= 2
    return SortProgram(family="bitonic", width=w, levels=tuple(levels))


# ---------------------------------------------------------------------------
# periodic3 (constant-period merging network, pairs kind)
# ---------------------------------------------------------------------------

_PERIOD = (PairStage(kind="reflect"), PairStage(kind="xor", d=1),
           PairStage(kind="brick_odd"))


def _np_period(x: np.ndarray) -> np.ndarray:
    """Numpy replica of one 3-stage period, for the minimal-t search."""
    L = x.shape[-1]
    r = x[..., ::-1]
    left = np.arange(L) < L // 2
    swap = np.where(left, x > r, r > x)
    x = np.where(swap, r, x)
    # even brick (xor d=1)
    y = x.reshape(x.shape[:-1] + (L // 2, 2))
    x = np.concatenate([y.min(-1, keepdims=True),
                        y.max(-1, keepdims=True)], -1).reshape(x.shape)
    # odd brick
    if L > 2:
        mid = x[..., 1:L - 1]
        y = mid.reshape(mid.shape[:-1] + ((L - 2) // 2, 2))
        mid = np.concatenate([y.min(-1, keepdims=True),
                              y.max(-1, keepdims=True)],
                             -1).reshape(mid.shape)
        x = np.concatenate([x[..., :1], mid, x[..., L - 1:]], -1)
    return x


@functools.lru_cache(maxsize=None)
def _periodic3_periods(m: int, n: int):
    """Minimal number of periods that merges every per-list-sorted 0-1
    pattern — exhaustive over all (m+1)(n+1) patterns, so by the 0-1
    principle the result is a proof, not a heuristic. Returns None when
    the bound is exceeded (treated as not capable)."""
    x = _per_list_sorted_01_patterns((m, n)).astype(np.int32)
    L = m + n
    # the period embeds a full even+odd transposition pass, so L//2 + 1
    # periods always suffice (odd-even transposition sorts in L stages)
    for t in range(L // 2 + 2):
        if bool((np.diff(x, axis=-1) >= 0).all()):
            return t
        x = _np_period(x)
    return None


@functools.lru_cache(maxsize=None)
def _periodic3_merge(m: int, n: int, n_cols=None) -> MergeProgram:
    t = _periodic3_periods(m, n) if _periodic3_capable(m, n) else None
    if t is None:
        raise ValueError(f"periodic3 not capable of merge ({m}, {n})")
    return MergeProgram(family="periodic3", m=m, n=n, kind="pairs",
                        stages=_PERIOD * t)


def _periodic3_capable(m: int, n: int) -> bool:
    total = m + n
    return (m >= 1 and n >= 1 and total % 2 == 0
            and total <= PERIODIC3_MAX_WIDTH)


def _periodic3_merge_capable(m: int, n: int) -> bool:
    return _periodic3_capable(m, n) and _periodic3_periods(m, n) is not None


@functools.lru_cache(maxsize=None)
def _periodic3_sort(w: int) -> SortProgram:
    assert _is_pow2(w) and w <= PERIODIC3_MAX_WIDTH, w
    levels, run = [], 1
    while run < w:
        levels.append(_periodic3_merge(run, run))
        run *= 2
    return SortProgram(family="periodic3", width=w, levels=tuple(levels))


def _periodic3_sort_capable(w: int) -> bool:
    return w <= PERIODIC3_MAX_WIDTH


#: name -> (merge_fn(m, n, n_cols=None), sort_fn(w),
#:          merge_capable(m, n), sort_capable(w))
BUILTIN_FAMILIES = {
    "loms": (_loms_merge, _loms_sort, _loms_merge_capable, lambda w: True),
    "s2ms": (_s2ms_merge, _s2ms_sort, _loms_merge_capable, lambda w: True),
    "periodic3": (_periodic3_merge, _periodic3_sort,
                  _periodic3_merge_capable, _periodic3_sort_capable),
    "bitonic": (_bitonic_merge, _bitonic_sort, _bitonic_merge_capable,
                lambda w: True),
}
