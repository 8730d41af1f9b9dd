"""The streaming merges: sorted rows of any length at a fixed tile
(counterpart of ``repro.streaming.chunked``: its 2-way grid mode and its
k-way merge).

:func:`chunked_merge` equals ``sort(concat([a, b], -1))`` on NaN-free
rows of any length, batched or not, in one launch of the grid merge
(kernel row 9). :func:`chunked_merge_k` merges k lists the same way: the
merge-path split points put each output tile's share of every list into
one segment row, and one launch of the k-way kernel (row 8) merges all
those rows. The reference makes one kernel call per output tile
(``jax.lax.map``); the output is values only and the sorted multiset is
unique, so the bits are the same. The reference's legacy
one-launch-per-tile loop (``mode="loop"``) is not ported (ROADMAP Queue
1, item 6).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import (decode_key_values, encode_key_values,
                                        key_transformable, sentinel_max)
from .grid_merge import grid_chunked_merge2
from .planner import plan_chunked, plan_chunked_k


def _as_batched(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten the leading axes into one batch axis."""
    if x.ndim == 1:
        return x[None, :], ()
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def chunked_merge(a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None,
                  mode: str = "grid") -> torch.Tensor:
    """Streaming 2-way merge of ascending ``a`` (..., Na) and ``b``
    (..., Nb) into (..., Na + Nb). ``tile`` defaults to the planner's
    (``plan_chunked``)."""
    if mode == "loop":
        raise NotImplementedError(
            "chunked_merge(mode='loop'), the one-launch-per-tile loop, is not "
            "ported (ROADMAP Queue 1, item 6); the default mode='grid' is")
    if mode != "grid":
        raise ValueError(f"mode must be 'grid' or 'loop', got {mode!r}")
    a2, lead = _as_batched(a)
    b2, lead_b = _as_batched(b)
    if lead != lead_b:
        raise ValueError(f"leading shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, na = a2.shape
    nb = b2.shape[-1]
    t = int(tile if tile is not None else
            plan_chunked(na, nb, batch=bsz, dtype=a2.dtype).tile)
    t = max(2, t - (t % 2))
    out = grid_chunked_merge2(a2.contiguous(), b2.contiguous(), tile=t)
    return out.reshape(lead + (na + nb,)) if lead else out[0]


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


def chunked_merge_k(lists: Sequence[torch.Tensor], *, tile: Optional[int] = None
                    ) -> torch.Tensor:
    """k-way merge of ascending rows (..., n_j) into (..., sum n_j) at a
    fixed tile (``plan_chunked_k``'s by default). Each output tile takes
    the k segments its merge-path split points select, padded with the
    key type's maximum, and the k-way kernel merges all B · tiles segment
    rows in one launch. Floats merge as their total-order keys, decoded
    (NaN last and canonical, -0.0 below +0.0); int32 as it is."""
    from repro_torch.kernels.kway import kway_merge
    from repro_torch.networks import kway_schedule

    if len(lists) < 2:
        raise ValueError("chunked_merge_k needs at least two lists")
    if len(lists) == 2:
        return chunked_merge(lists[0], lists[1], tile=tile)
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
    if min(lens) < 1:
        raise ValueError(f"every list needs an element, got lengths {lens}")
    bsz, k, total = flat[0].shape[0], len(flat), sum(lens)
    t = int(tile if tile is not None else plan_chunked_k(lens, batch=bsz).tile)
    out_tiles = -(-total // t)
    grid = (torch.arange(out_tiles + 1, device=flat[0].device) * t).expand(bsz, -1)
    lane = torch.arange(t, device=flat[0].device)
    fill = sentinel_max(keys[0].dtype)
    segs = []
    for j, pj in enumerate(_global_positions(keys)):
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
