"""The schedule executor: the paper's devices as plain torch ops
(counterpart of ``repro.api.schedules``).

Compare-exchange schedules with static shapes and no data-dependent
control flow, run on whatever device the tensors lie. The last axis is
the sorted axis; leading axes are batch. It runs every op and carries
payloads through the permutation, so it is the ``schedule`` backend of
the library (``api.registry``):

  merge(a, b)            2-way merge of two sorted lists (LOMS/S2MS/Batcher)
  merge_k(lists)         k-way merge (LOMS k-way / MWMS / 2-way tree)
  sort(x)                full sort (2-sorter pairs + LOMS merge tree, or
                         Batcher bitonic/OEMS, or single-stage rank sort)
  topk(x, k)             blockwise top-k via truncated LOMS merges
  median_of_lists(ls)    2-stage LOMS median (paper §V-A)
  median9(x)             3x3 median filter core (paper ref [19] use case)

No kernel runs here: the comparison clouds are torch ops, computed in
slabs (``core.networks.CLOUD_BUDGET``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import batcher as _batcher
from repro_torch.core import loms as _loms
from repro_torch.core import mwms as _mwms
from repro_torch.core.networks import (
    Group,
    Schedule,
    Stage,
    apply_schedule,
    apply_schedule_with_payload,
    rank_sort,
)
from repro_torch.kernels.common import stable_compact, take_along

# ---------------------------------------------------------------------------
# schedule selection
# ---------------------------------------------------------------------------


def merge_schedule(m: int, n: int, kind: str = "loms", n_cols: int = 2) -> Schedule:
    if kind == "loms":
        return _loms.loms_2way(m, n, n_cols)
    if kind == "s2ms":  # single-stage 2-way merge: one merge group over everything
        return Schedule(
            name=f"s2ms_up{m}_dn{n}", size=m + n,
            setup_scatter=tuple(range(m + n)), output_gather=tuple(range(m + n)),
            stages=(Stage(groups=(Group(idx=tuple(range(m + n)), runs=(m, n)),)),),
            meta=(("kind", "s2ms"), ("lens", (m, n))))
    if kind == "batcher-oe":
        return _batcher.oems_merge(m, n)
    if kind == "batcher-bitonic":
        return _batcher.bitonic_merge(m, n)
    raise ValueError(f"unknown merge kind {kind!r}")


def merge(a: torch.Tensor, b: torch.Tensor, kind: str = "loms", n_cols: int = 2,
          payload: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Merge two ascending lists along the last axis: the values, or
    ``(values, payload)`` with one."""
    sched = merge_schedule(a.shape[-1], b.shape[-1], kind, n_cols)
    x = torch.cat([a, b], dim=-1)
    if payload is None:
        return apply_schedule(sched, x)
    return apply_schedule_with_payload(sched, x, torch.cat(list(payload), dim=-1))


def merge_k(lists: Sequence[torch.Tensor], kind: str = "loms",
            payload: Optional[Sequence[torch.Tensor]] = None):
    """k-way merge of ascending lists. ``kind``: loms | mwms | tree.
    Returns the values, or ``(values, payload)`` with one."""
    lens = tuple(int(t.shape[-1]) for t in lists)
    if kind in ("loms", "mwms"):
        sched = _loms.loms_kway(lens) if kind == "loms" else _mwms.mwms_kway(lens)
        x = torch.cat(list(lists), dim=-1)
        if payload is None:
            return apply_schedule(sched, x)
        return apply_schedule_with_payload(sched, x, torch.cat(list(payload), dim=-1))
    if kind == "tree":  # a binary tree of 2-way LOMS merges (the prior-art pattern)
        items = list(lists)
        pls = list(payload) if payload is not None else None
        while len(items) > 1:
            nxt, npl = [], []
            for i in range(0, len(items) - 1, 2):
                if pls is None:
                    nxt.append(merge(items[i], items[i + 1]))
                else:
                    v, p = merge(items[i], items[i + 1], payload=(pls[i], pls[i + 1]))
                    nxt.append(v)
                    npl.append(p)
            if len(items) % 2:
                nxt.append(items[-1])
                if pls is not None:
                    npl.append(pls[-1])
            items, pls = nxt, (npl if pls is not None else None)
        return items[0] if payload is None else (items[0], pls[0])
    raise ValueError(f"unknown merge_k kind {kind!r}")


# ---------------------------------------------------------------------------
# full sort
# ---------------------------------------------------------------------------


def _dtype_max(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return int(torch.iinfo(dtype).max)


def _dtype_min(dtype: torch.dtype):
    """Smallest value of ``dtype``, not ``-_dtype_max``: negating the max is
    off by one for signed ints."""
    if dtype.is_floating_point:
        return float("-inf")
    return int(torch.iinfo(dtype).min)


def _pad_last(x: torch.Tensor, pad: int, fill) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return _pad_last(x, n - x.shape[-1], _dtype_max(x.dtype))


def sort(x: torch.Tensor, kind: str = "loms", payload: Optional[torch.Tensor] = None):
    """Full ascending sort along the last axis of unsorted values.

    kind='loms': a 2-sorter pair stage, then a LOMS 2-way merge tree of
    doubling runs. Other lengths than powers of two pad with +max and slice
    back. kind='bitonic'|'oems': Batcher full sorts. kind='rank': the
    single-stage rank sort.

    A payload sort of a padded length rides a position index through the
    network instead of the payload (a +max pad can tie a genuine maximum,
    only an out-of-range index identifies the pad): the valid prefix is
    recovered by mask (``stable_compact``), and the payload gathered."""
    n = x.shape[-1]
    if n <= 1:
        return x if payload is None else (x, payload)
    if kind == "rank":
        return rank_sort(x, payload)
    if kind not in ("loms", "bitonic", "oems"):
        raise ValueError(f"unknown sort kind {kind!r}")
    npad = 1 << (n - 1).bit_length()
    indexed = payload is not None and npad != n
    xp = _pad_to(x, npad)
    if indexed:
        pp = torch.arange(npad, dtype=torch.int32, device=x.device).expand(xp.shape)
    else:
        pp = payload
    if kind in ("bitonic", "oems"):
        sched = _batcher.bitonic_sort(npad) if kind == "bitonic" else _batcher.oems_sort(npad)
        if pp is None:
            xp = apply_schedule(sched, xp)
        else:
            xp, pp = apply_schedule_with_payload(sched, xp, pp)
    else:
        run = 1
        while run < npad:  # rows of two sorted runs, each pair LOMS-merged
            shape = xp.shape[:-1] + (npad // (2 * run), 2 * run)
            xv = xp.reshape(shape)
            if pp is not None:
                pv = pp.reshape(shape)
                xv, pv = merge(xv[..., :run], xv[..., run:],
                               payload=(pv[..., :run], pv[..., run:]))
                pp = pv.reshape(xp.shape)
            else:
                xv = merge(xv[..., :run], xv[..., run:])
            xp = xv.reshape(xp.shape)
            run *= 2
    if payload is None:
        return xp[..., :n]
    if indexed:
        xp, pp = stable_compact(pp < n, xp, pp)
        return xp[..., :n], take_along(payload, -1, pp[..., :n])
    return xp[..., :n], pp[..., :n]


# ---------------------------------------------------------------------------
# top-k via truncated LOMS merges
# ---------------------------------------------------------------------------


def topk(x: torch.Tensor, k: int, block: int = 0, with_indices: bool = True):
    """Top-k (descending) along the last axis via a blockwise oblivious
    merge: rank-sort each block, keep its top ``min(k, block)``, then
    reduce the block lists pairwise with truncated LOMS merges.

    Pad slots (the dtype minimum out to a block multiple) carry index -1:
    a pad can tie a genuine minimum, and an in-range index would alias it.
    Returns ``(values, int32 indices)`` (values only without
    ``with_indices``)."""
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for an axis of {n}")
    if block <= 0:
        block = max(k, 16)
    block = min(block, n)
    nblk = -(-n // block)
    npad = nblk * block
    neg_inf = _dtype_min(x.dtype)
    xp = _pad_last(x, npad - n, neg_inf)
    idx = torch.arange(npad, dtype=torch.int32, device=x.device)
    idx = torch.where(idx < n, idx, -1).expand(xp.shape)
    xb = xp.reshape(xp.shape[:-1] + (nblk, block))
    ib = idx.reshape(xp.shape[:-1] + (nblk, block))
    vs, is_ = rank_sort(xb, ib)  # ascending, then reversed: descending blocks
    kk = min(k, block)
    vs, is_ = vs.flip(-1)[..., :kk], is_.flip(-1)[..., :kk]
    while vs.shape[-2] > 1:
        if vs.shape[-2] % 2:  # carry the odd tail block
            vs = torch.cat([vs, vs.new_full(vs.shape[:-2] + (1, kk), neg_inf)], dim=-2)
            is_ = torch.cat([is_, is_.new_full(is_.shape[:-2] + (1, kk), -1)], dim=-2)
        a_v, b_v = vs[..., 0::2, :], vs[..., 1::2, :]
        a_i, b_i = is_[..., 0::2, :], is_[..., 1::2, :]
        # two descending lists: reversed -> ascending merge -> the top
        mv, mi = merge(a_v.flip(-1), b_v.flip(-1), payload=(a_i.flip(-1), b_i.flip(-1)))
        kk = min(k, 2 * kk)
        vs, is_ = mv.flip(-1)[..., :kk], mi.flip(-1)[..., :kk]
    vs, is_ = vs[..., 0, :k], is_[..., 0, :k]
    return (vs, is_) if with_indices else vs


# ---------------------------------------------------------------------------
# medians (paper §V-A early exit)
# ---------------------------------------------------------------------------


def median_of_lists(lists: Sequence[torch.Tensor], kind: str = "loms") -> torch.Tensor:
    """Median of k equal odd-length sorted lists after the device's first
    stages (two for LOMS)."""
    lens = tuple(int(t.shape[-1]) for t in lists)
    sched, pos = _loms.loms_median(lens) if kind == "loms" else _mwms.mwms_median(lens)
    return apply_schedule(sched, torch.cat(list(lists), dim=-1))[..., pos]


def median9(window: torch.Tensor) -> torch.Tensor:
    """Median of 9 unsorted values (a 3x3 image window, ref [19]): three
    parallel 3-sorters, then the 2-stage 3c_3r LOMS median. Depth 3."""
    if window.shape[-1] != 9:
        raise ValueError(f"median9 takes windows of 9, got {window.shape[-1]}")
    rows = rank_sort(window.reshape(window.shape[:-1] + (3, 3)))
    return median_of_lists([rows[..., i, :] for i in range(3)])
