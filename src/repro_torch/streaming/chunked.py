"""The streaming merges: sorted rows of any length at a fixed tile
(counterpart of ``repro.streaming.chunked``: its 2-way grid mode and its
k-way merge).

:func:`chunked_merge` equals ``sort(concat([a, b], -1))`` on NaN-free
rows of any length, batched or not, in one launch of the grid merge
(kernel row 9); ``mode="loop"`` is the reference's one-launch-a-tile
loop, one launch of the 2-way merge (row 1) a tile, its FLiMS refill
state on the device. :func:`chunked_merge_k` merges k lists the same
way: the merge-path split points put each output tile's share of every
list into one segment row, and one launch of the k-way kernel (row 8)
merges all those rows. The reference makes one kernel call per output
tile (``jax.lax.map``); the output is values only and the sorted
multiset is unique, so the bits are the same.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import (decode_key_values, encode_key_values,
                                        key_transformable, pad_tail_sorted, sentinel_max,
                                        take_along)
from .grid_merge import grid_chunked_merge2
from .planner import MergePlan, plan_chunked, plan_chunked_k


def _as_batched(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten the leading axes into one batch axis."""
    if x.ndim == 1:
        return x[None, :], ()
    lead = tuple(x.shape[:-1])
    return x.reshape(math.prod(lead), x.shape[-1]), lead


def chunked_merge(a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None,
                  plan: Optional[MergePlan] = None, mode: str = "grid") -> torch.Tensor:
    """Streaming 2-way merge of ascending ``a`` (..., Na) and ``b``
    (..., Nb) into (..., Na + Nb). ``tile`` defaults to the plan's, and
    ``plan`` to the planner's (``plan_chunked``). ``mode="grid"`` is one
    launch of the grid merge; ``mode="loop"`` one launch of the 2-way merge
    a tile (the plan's family, columns and raw-float mode, or the schedule
    merge where the columns do not divide the tile)."""
    if mode not in ("grid", "loop"):
        raise ValueError(f"mode must be 'grid' or 'loop', got {mode!r}")
    a2, lead = _as_batched(a)
    b2, lead_b = _as_batched(b)
    if lead != lead_b:
        raise ValueError(f"leading shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, na = a2.shape
    nb = b2.shape[-1]
    if plan is None:
        plan = plan_chunked(na, nb, batch=bsz, dtype=a2.dtype, tile=tile)
    t = int(tile if tile is not None else plan.tile)
    t = max(2, t - (t % 2))
    if mode == "grid":
        out = grid_chunked_merge2(a2.contiguous(), b2.contiguous(), tile=t)
    else:
        out = _chunked_merge2(a2.contiguous(), b2.contiguous(), t, plan)[0]
    return out.reshape(lead + (na + nb,)) if lead else out[0]


def _merge_pair(carry: torch.Tensor, tile: torch.Tensor, plan: MergePlan,
                lanes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(B, T) + (B, T) -> ((B, 2T) ascending, its position lane | None)
    (``chunked.py:69``): one launch of the 2-way merge when the plan's
    columns divide the tile, else the schedule merge. ``lanes``, the two
    halves' int32 positions, ride as the merge's payload (the plan's
    columns must then divide the tile)."""
    from repro_torch.api import schedules
    from repro_torch.kernels.loms_merge import loms_merge2

    t = carry.shape[-1]
    if lanes is not None or (plan.kind == "loms" and t % plan.n_cols == 0):
        raw = plan.use_mxu and carry.dtype.is_floating_point
        payloads = () if lanes is None else (torch.cat(lanes, dim=1),)
        out, _, pos = loms_merge2(carry.contiguous(), tile.contiguous(), payloads,
                                  network=plan.network, n_cols=plan.n_cols, use_mxu=raw)
        return out, (pos[0] if pos else None)
    return schedules.merge(carry, tile), None


def _chunked_merge2(a: torch.Tensor, b: torch.Tensor, t: int, plan: MergePlan,
                    pos_a: Optional[torch.Tensor] = None,
                    pos_b: Optional[torch.Tensor] = None):
    """The reference's loop (``_chunked_merge2``, ``chunked.py:122``): the
    first tile of each stream merged, the lower half out; then a tile at a
    time from the stream whose last loaded value is the smaller (the FLiMS
    rule), merged with the carry. Each stream has one all-sentinel drain
    tile past its tail, where its pointer stops. The pointers and last
    values stay on the device, each tile a gather at them. Returns (out,
    positions | None): with int32 position lanes ``pos_a`` / ``pos_b``
    (the values-only spills where equal keys hold unequal values) the
    positions come back in the order the loop puts their elements, the
    drain tiles' -1."""
    bsz, na = a.shape
    nb = b.shape[-1]
    total = na + nb
    out_tiles = -(-total // t)
    la, lb = (-(-na // t) + 1) * t, (-(-nb // t) + 1) * t
    ap, bp = pad_tail_sorted(a, la), pad_tail_sorted(b, lb)
    carried = pos_a is not None
    if carried:
        qa = torch.cat([pos_a, pos_a.new_full((bsz, la - na), -1)], dim=1)
        qb = torch.cat([pos_b, pos_b.new_full((bsz, lb - nb), -1)], dim=1)
    lane = torch.arange(t, device=a.device)
    ta, tb = ap[:, :t], bp[:, :t]
    merged, pos = _merge_pair(ta, tb, plan, (qa[:, :t], qb[:, :t]) if carried else None)
    out = torch.empty((bsz, out_tiles * t), dtype=a.dtype, device=a.device)
    out_p = (torch.empty((bsz, out_tiles * t), dtype=torch.int32, device=a.device)
             if carried else None)
    out[:, :t] = merged[:, :t]
    carry = merged[:, t:]
    if carried:
        out_p[:, :t], carry_p = pos[:, :t], pos[:, t:]
    last_a, last_b = ta[:, -1], tb[:, -1]
    pa = torch.full((bsz,), t, dtype=torch.int64, device=a.device)
    pb = torch.full_like(pa, t)
    for i in range(1, out_tiles):
        sel_a = last_a <= last_b
        # a load clamps its start into the row, as a dynamic slice does
        ia = pa.clamp(max=la - t)[:, None] + lane
        ib = pb.clamp(max=lb - t)[:, None] + lane
        cur = torch.where(sel_a[:, None], take_along(ap, 1, ia), take_along(bp, 1, ib))
        last_a = torch.where(sel_a, cur[:, -1], last_a)
        last_b = torch.where(sel_a, last_b, cur[:, -1])
        pa = torch.where(sel_a, (pa + t).clamp(max=la - t), pa)
        pb = torch.where(sel_a, pb, (pb + t).clamp(max=lb - t))
        lanes = None
        if carried:
            lanes = (carry_p, torch.where(sel_a[:, None], take_along(qa, 1, ia),
                                          take_along(qb, 1, ib)))
        merged, pos = _merge_pair(carry, cur, plan, lanes)
        out[:, i * t:(i + 1) * t] = merged[:, :t]
        carry = merged[:, t:]
        if carried:
            out_p[:, i * t:(i + 1) * t], carry_p = pos[:, :t], pos[:, t:]
    return out[:, :total], (out_p[:, :total] if carried else None)


def _global_positions(lists: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The merged position of every element (stable: an earlier list's
    equal values go first), each count a batched binary search."""
    pos = []
    for j, lj in enumerate(lists):
        p = torch.arange(lj.shape[-1], device=lj.device).expand(lj.shape)
        for i, li in enumerate(lists):
            if i != j:
                p = p + torch.searchsorted(li, lj, right=i < j)
        pos.append(p)
    return pos


def chunked_merge_k(lists: Sequence[torch.Tensor], *, tile: Optional[int] = None,
                    plan: Optional[MergePlan] = None) -> torch.Tensor:
    """k-way merge of ascending rows (..., n_j) into (..., sum n_j) at a
    fixed tile: ``tile``, else ``plan.tile``, else ``plan_chunked_k``'s.
    Each output tile takes the k segments its merge-path split points
    select, padded with the key type's maximum, and the k-way kernel
    merges all B · tiles segment rows in one launch. Floats merge as their
    total-order keys, decoded (NaN last and canonical, -0.0 below +0.0);
    int32 as it is. Two lists are :func:`chunked_merge` with the same
    ``tile`` and ``plan``. Of three or more, 1-D lists may be empty (an
    empty list's segments are all padding), as in the reference; batched
    rows with an empty list raise ``ValueError`` (the reference divides
    by zero there)."""
    from repro_torch.kernels.kway import kway_merge
    from repro_torch.networks import kway_schedule

    if len(lists) < 2:
        raise ValueError("chunked_merge_k needs at least two lists")
    if len(lists) == 2:
        return chunked_merge(lists[0], lists[1], tile=tile, plan=plan)
    for j, t in enumerate(lists):
        if t.ndim > 1 and t.shape[-1] == 0:
            raise ValueError(f"list {j} of shape {tuple(t.shape)} is empty: batched rows "
                             "need an element in every list (1-D lists may be empty)")
    flat, lead = [], None
    for t in lists:
        f, ld = _as_batched(t)
        if lead is not None and ld != lead:
            raise ValueError(f"leading shapes differ: {[tuple(x.shape) for x in lists]}")
        lead = ld
        flat.append(f.contiguous())
    dtype = flat[0].dtype
    if any(f.dtype != dtype for f in flat):
        raise ValueError("the lists of a chunked merge need one dtype")
    keys = [encode_key_values(f) for f in flat] if key_transformable(dtype) else flat
    lens = tuple(f.shape[-1] for f in flat)
    bsz, k, total = flat[0].shape[0], len(flat), sum(lens)
    if total == 0:
        return flat[0].new_empty(lead + (0,))
    if tile is None:
        tile = (plan if plan is not None else plan_chunked_k(lens, batch=bsz)).tile
    t = int(tile)
    out_tiles = -(-total // t)
    grid = (torch.arange(out_tiles + 1, device=flat[0].device) * t).expand(bsz, -1)
    lane = torch.arange(t, device=flat[0].device)
    fill = sentinel_max(keys[0].dtype)
    segs = []
    for j, pj in enumerate(_global_positions(keys)):
        if not lens[j]:  # an empty list: every segment is padding
            segs.append(torch.full((bsz, out_tiles, t), fill, dtype=keys[j].dtype,
                                   device=keys[j].device))
            continue
        # how many of list j land in the first i * t outputs, for each i
        split = torch.searchsorted(pj.contiguous(), grid.contiguous())
        start, seg_len = split[:, :-1], split[:, 1:] - split[:, :-1]
        idx = (start[..., None] + lane).clamp(max=lens[j] - 1)
        seg = torch.gather(keys[j], 1, idx.reshape(bsz, -1)).reshape(bsz, out_tiles, t)
        segs.append(torch.where(lane < seg_len[..., None], seg, fill))
    rows = torch.cat(segs, dim=-1).reshape(bsz * out_tiles, k * t)
    merged = kway_merge(rows, kway_schedule((t,) * k))[0][:, :t]
    out = merged.reshape(bsz, out_tiles * t)[:, :total]
    if key_transformable(dtype):
        out = decode_key_values(out, dtype)
    return out.reshape(lead + (total,)) if lead else out[0]
