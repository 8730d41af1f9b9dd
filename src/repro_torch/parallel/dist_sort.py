"""Distributed sample-sort: ``repro_torch.sort`` / ``merge_k`` over a mesh
axis (counterpart of ``repro.parallel.dist_sort``).

PSRS (parallel sorting by regular sampling) out of LOMS devices, one
rank a slice of the axis's ``P`` ranks:

1. **local sort**: each rank sorts its contiguous slice of every row
   (for ``merge_k``: a k-way merge of its slices of the sorted lists; a
   slice of a sorted list is sorted);
2. **splitters**: P regular samples a rank, all-gathered and sorted, every
   P-th picked as one of the P-1 splitters;
3. **partition**: per-row bucket boundaries by binary search over the
   sorted run (``right=True``: an equal-value class never straddles a
   bucket), one all-to-all moving bucket ``j`` to rank ``j`` as blocks of
   the full local length with their valid counts riding along;
4. **merge**: each rank merges the P received runs;
5. **rebalance**: bucket sizes depend on the data, so a second exchange
   moves every element by its global rank back onto the even output
   slices. Validity comes from the all-gathered bucket sizes and from
   positions (``-1`` on pads), never from sentinel values.

The local phases take the tensor's device. On the CPU they are the
reference's own routes (``api.schedules``: the LOMS merge-tree sort and
the 2-way merge tree, the binary-search rank-merge tree past the
routing budget), so every value, position and payload lane is
bit-equal to the reference's. On the card they are the port's kernels:
the sort (row 2, ``kernels.sort.loms_sort``, within the budget; past it
the values-only spill of ``segmented.core``: the class sort, row 6, and
the grid merge, row 9, one launch a level; positions ride row 2's
permutation in tiles merged by the rank-merge tree), the 2-way merge (row
1) and the k-way merge (row 8, ``chunked_merge_k`` past the budget, as
the reference's accelerator takes it). Values are bit-equal on every
route; positions are where the keys are unique (or after the ops
layer's ``stable=True``), and otherwise in the answering kernels' tie
order. Float rows go to the kernels as total-order keys.

Each rank runs :func:`sample_sort_local` / :func:`sample_merge_k_local`
(the reference's ``shard_map`` body) on its slice;
:func:`sample_sort` / :func:`sample_merge_k` keep the reference's
contract, full arrays in and out on every rank.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.common import (ceil_pow2, decode_key_values, encode_key_values,
                                        key_transformable, scatter_along, sentinel_max,
                                        stable_compact, take_along)
from repro_torch.obs import metrics as obs_metrics

from . import comm

#: below this total length the partition and the two exchanges outweigh
#: the device-parallel merge; ``plan`` keeps the single-device backends
DIST_MIN_TOTAL = 8192


def _fill_for(dtype: torch.dtype):
    return sentinel_max(dtype)


# ---------------------------------------------------------------------------
# local phases
# ---------------------------------------------------------------------------


def _as_keys(x: torch.Tensor):
    """Float rows as total-order int32 keys for the kernels, and the
    decode back (None: the rows are keys already)."""
    if key_transformable(x.dtype):
        return encode_key_values(x), (lambda k: decode_key_values(k, x.dtype))
    return x, None


def _merge2_ranked(av: torch.Tensor, ap: Optional[torch.Tensor],
                   bv: torch.Tensor, bp: Optional[torch.Tensor]):
    """Stable 2-run merge by binary-search ranks (the first run wins
    ties): no comparison cloud, the payload-carrying merge for runs far
    past the budget."""
    m, n = av.shape[-1], bv.shape[-1]
    av, bv = av.contiguous(), bv.contiguous()
    ra = torch.arange(m, device=av.device) + torch.searchsorted(bv, av, right=False)
    rb = torch.arange(n, device=av.device) + torch.searchsorted(av, bv, right=True)
    rank = torch.cat([ra, rb], dim=-1)
    out_v = scatter_along(torch.cat([av, bv], dim=-1), -1, rank)
    if ap is None:
        return out_v, None
    return out_v, scatter_along(torch.cat([ap, bp], dim=-1), -1, rank)


def _rank_merge_tree(items: List[torch.Tensor], pls: List[Optional[torch.Tensor]]):
    while len(items) > 1:
        nxt, npl = [], []
        for i in range(0, len(items) - 1, 2):
            v, p = _merge2_ranked(items[i], pls[i], items[i + 1], pls[i + 1])
            nxt.append(v)
            npl.append(p)
        if len(items) % 2:
            nxt.append(items[-1])
            npl.append(pls[-1])
        items, pls = nxt, npl
    return items[0], pls[0]


def _merge_values_on_card(runs: List[torch.Tensor]) -> torch.Tensor:
    """Values-only merge of sorted runs with the kernels: the 2-way merge
    (row 1) or the k-way merge (row 8) within the budget, the k-way tiles
    (``chunked_merge_k``, row 8) past it."""
    from repro_torch.kernels.ops import merge2, merge_k
    from repro_torch.streaming import chunked_merge_k
    from repro_torch.streaming.planner import fits_vmem, kway_fits_vmem

    keys, decode = _as_keys(torch.cat(runs, dim=-1))
    lens = [r.shape[-1] for r in runs]
    parts = list(torch.split(keys, lens, dim=-1))
    parts = [p.contiguous() for p in parts]
    if len(parts) == 2 and fits_vmem(lens[0], lens[1], dtype=keys.dtype):
        out = merge2(parts[0], parts[1])
    elif kway_fits_vmem(sum(lens)):
        out = merge_k(parts)
    else:
        out = chunked_merge_k(parts)
    return out if decode is None else decode(out)


def _merge_sorted_runs(runs: List[torch.Tensor], pos_runs: Optional[List[torch.Tensor]]):
    """k-way merge of sorted (B, n_i) runs, the reference's budget ladder:
    a binary tree of 2-way LOMS merges within the budget, the
    rank-merge tree past it for payload-carrying runs; values-only runs
    on the card take the kernels (:func:`_merge_values_on_card`)."""
    from repro_torch.streaming.planner import kway_fits_vmem

    if len(runs) == 1:
        return runs[0], (None if pos_runs is None else pos_runs[0])
    if pos_runs is None and runs[0].device.type == "cuda":
        return _merge_values_on_card(runs), None
    if kway_fits_vmem(sum(r.shape[-1] for r in runs)):
        from repro_torch.api import schedules

        if pos_runs is None:
            return schedules.merge_k(runs, kind="tree"), None
        return schedules.merge_k(runs, kind="tree", payload=pos_runs)
    pls = list(pos_runs) if pos_runs is not None else [None] * len(runs)
    return _rank_merge_tree(list(runs), pls)


def _sort_on_card(x: torch.Tensor, pos: Optional[torch.Tensor]):
    """Ascending sort of (B, n) rows with the kernels: one launch of row 2
    within the budget; past it the values-only spill, or, with
    positions, row 2 on tiles and the rank-merge tree over them."""
    from repro_torch.kernels.sort import loms_sort
    from repro_torch.segmented.core import SPILL_TILE, _spill_sort_values, max_class_width
    from repro_torch.streaming.planner import plan_op, sort_fits_vmem

    b, n = x.shape
    keys, decode = _as_keys(x)
    if pos is None and not sort_fits_vmem(n, dtype=keys.dtype):
        return _spill_sort_values(x, False, min(SPILL_TILE, max_class_width(x.dtype))), None
    tile = n if sort_fits_vmem(n, dtype=keys.dtype) else ceil_pow2(n)
    while not sort_fits_vmem(tile, dtype=keys.dtype):
        tile //= 2
    c = -(-n // tile)
    if c * tile != n:  # pads last, their lanes past n: the mask drops them
        keys = torch.cat([keys, keys.new_full((b, c * tile - n), sentinel_max(keys.dtype))],
                         dim=1)
    network = plan_op("sort", (tile,), batch=b * c, dtype=keys.dtype).network
    srt, perm, _ = loms_sort(keys.reshape(b * c, tile).contiguous(), network=network,
                             want_perm=pos is not None)
    if pos is None:
        out = srt.reshape(b, n)
        return (out if decode is None else decode(out)), None
    srt = srt.reshape(b, c, tile)
    lane = perm.reshape(b, c, tile) + torch.arange(c, device=x.device,
                                                   dtype=torch.int32)[:, None] * tile
    out, lane = _rank_merge_tree([srt[:, i] for i in range(c)], [lane[:, i] for i in range(c)])
    if c * tile != n:
        out, lane = stable_compact(lane < n, out, lane)
        out, lane = out[:, :n], lane[:, :n]
    out = out if decode is None else decode(out)
    return out, take_along(pos, -1, lane)


def _local_sort(x: torch.Tensor, pos: Optional[torch.Tensor]):
    """Phase 1 of the sort on the tensor's device: ``(sorted, pos | None)``."""
    if x.device.type == "cuda":
        return _sort_on_card(x, pos)
    from repro_torch.api import schedules

    if pos is None:
        return schedules.sort(x), None
    return schedules.sort(x, payload=pos)


# ---------------------------------------------------------------------------
# the exchange phases
# ---------------------------------------------------------------------------


def _splitters(xs: torch.Tensor, group, p: int) -> torch.Tensor:
    """Regular-sampling splitters, the same on every rank: (B, P-1)."""
    n_local = xs.shape[-1]
    samp_idx = torch.as_tensor(np.arange(p) * n_local // p, device=xs.device)
    gathered = comm.all_gather_cat(xs[:, samp_idx], group, dim=1)  # (B, P^2)
    ssort = _local_sort(gathered, None)[0]
    return ssort[:, p - 1::p][:, :p - 1]


def _partition(xs: torch.Tensor, ps: Optional[torch.Tensor], split: torch.Tensor, fill):
    """Scatter each sorted row into P send blocks of the full local
    length (no overflow possible): unused slots carry ``fill`` (runs stay
    sorted) and position -1."""
    b, n_local = xs.shape
    p = split.shape[-1] + 1
    dev = xs.device
    # the first index past each splitter: an equal-value class stays on
    # the left of a boundary, so it lands in one bucket on every rank
    sb = torch.searchsorted(xs.contiguous(), split.contiguous(), right=True)
    bounds = torch.cat([sb.new_zeros((b, 1)), sb, sb.new_full((b, 1), n_local)], dim=1)
    lane = torch.arange(n_local, device=dev)
    bucket = torch.searchsorted(sb.contiguous(), lane.expand(b, n_local).contiguous(),
                                right=True)
    start = torch.gather(bounds, 1, bucket)
    dest = bucket * n_local + (lane[None, :] - start)
    send = xs.new_full((b, p * n_local), fill).scatter(1, dest, xs)
    cnt = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32)
    psend = None
    if ps is not None:
        psend = ps.new_full((b, p * n_local), -1).scatter(1, dest, ps).reshape(b, p, n_local)
    return send.reshape(b, p, n_local), cnt, psend


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """Slice ``j`` of dim 1 to rank ``j``; the slices received stack there.
    ``dist_sort.all_to_all_bytes`` counts this rank's payload bytes each
    call (the port's counters count calls, ROADMAP Queue 3; the
    reference's count once a compilation)."""
    obs_metrics.counter("dist_sort.all_to_all_bytes").inc(x.numel() * x.element_size())
    return comm.all_to_all(x, group, dim=1)


def _rebalance(vals: torch.Tensor, pos: Optional[torch.Tensor], v_count: torch.Tensor,
               group, p: int, n_local: int, fill):
    """Move the merged bucket by global rank onto the even output slices:
    element ``i`` here has rank ``off_me + i`` and goes to rank ``rank //
    n_local`` at ``rank % n_local``. The receiver's validity comes from the
    all-gathered bucket sizes, whose rank intervals tile the row."""
    b, length = vals.shape
    dev = vals.device
    me = dist.get_rank(group)
    v_all = comm.all_gather_stack(v_count, group, dim=1).long()  # (B, P)
    off = torch.cumsum(v_all, dim=1) - v_all  # (B, P) bucket start ranks
    lane = torch.arange(length, device=dev)
    rank = off[:, me:me + 1] + lane[None, :]
    valid = lane[None, :] < v_count[:, None]
    dest = torch.clamp(rank // n_local, 0, p - 1) * n_local + rank % n_local
    slot = torch.where(valid, dest, p * n_local)  # the invalid go to a trash slot
    send = vals.new_full((b, p * n_local + 1), fill).scatter(1, slot, vals)
    recv = _a2a(send[:, :-1].reshape(b, p, n_local), group)
    precv = None
    if pos is not None:
        psend = pos.new_full((b, p * n_local + 1), -1).scatter(1, slot, pos)
        precv = _a2a(psend[:, :-1].reshape(b, p, n_local), group)
    out = vals.new_full((b, n_local), fill)
    pout = None if pos is None else pos.new_full((b, n_local), -1)
    q = torch.arange(n_local, device=dev)[None, :]
    my_lo = me * n_local
    for i in range(p):
        lo = off[:, i:i + 1] - my_lo
        m = (q >= lo) & (q < lo + v_all[:, i:i + 1])
        out = torch.where(m, recv[:, i], out)
        if pos is not None:
            pout = torch.where(m, precv[:, i], pout)
    return out, pout


def _psrs_tail(xs: torch.Tensor, ps: Optional[torch.Tensor], *, group, p: int, fill):
    """Phases 2-5 on a locally sorted (B, n_local) run."""
    n_local = xs.shape[-1]
    split = _splitters(xs, group, p)
    send, cnt, psend = _partition(xs, ps, split, fill)
    recv = _a2a(send, group)  # (B, P, C): run i from rank i
    rcnt = _a2a(cnt, group)  # (B, P): its valid length
    precv = None if psend is None else _a2a(psend, group)
    runs = [recv[:, i].contiguous() for i in range(p)]
    pruns = None if precv is None else [precv[:, i].contiguous() for i in range(p)]
    merged, pmerged = _merge_sorted_runs(runs, pruns)
    if pmerged is not None:
        # pads tie genuine dtype-max values; validity (pos >= 0), not the
        # value, decides the live prefix
        merged, pmerged = stable_compact(pmerged >= 0, merged, pmerged)
    v_count = rcnt.sum(dim=1)
    return _rebalance(merged, pmerged, v_count, group, p, n_local, fill)


# ---------------------------------------------------------------------------
# entry points: the local forms, and full arrays in and out
# ---------------------------------------------------------------------------


def sample_sort_local(xl: torch.Tensor, *, group, pos: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's slice (B, n_local) of an ascending sort over ``group``:
    the slice in, the slice out, with the int32 ``pos`` payload riding
    along (the reference's ``shard_map`` body)."""
    p = dist.get_world_size(group)
    if xl.numel() == 0:
        return xl.clone(), (None if pos is None else pos.clone())
    xs, psl = _local_sort(xl, pos)
    return _psrs_tail(xs, psl, group=group, p=p, fill=_fill_for(xl.dtype))


def sample_merge_k_local(lists: Sequence[torch.Tensor], *, group,
                         pos: Optional[Sequence[torch.Tensor]] = None):
    """This rank's slices of k sorted lists merged over ``group``: the
    slices in, this rank's slice (B, sum n_i / P) of the merge out."""
    lists = list(lists)
    p = dist.get_world_size(group)
    merged, pmerged = _merge_sorted_runs(lists, None if pos is None else list(pos))
    if merged.numel() == 0:
        return merged, pmerged
    return _psrs_tail(merged, pmerged, group=group, p=p, fill=_fill_for(merged.dtype))


def _axis(mesh, axis_name: str):
    """(group, size, coordinate) of one mesh axis."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis_name)


def _check_split(lens: Sequence[int], p: int) -> None:
    if any(ln % p or ln < p for ln in lens):
        raise ValueError(f"lengths {tuple(lens)} do not split evenly over {p} ranks")


def sample_sort(x: torch.Tensor, *, mesh, axis_name: str, pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Ascending sort of (B, N) over ``mesh[axis_name]``: every rank passes
    the same full rows and gets the full result. ``N`` must divide over the
    axis; ``pos`` is the int32 position payload. Returns ``(sorted,
    pos_out | None)``."""
    group, p, me = _axis(mesh, axis_name)
    n = x.shape[-1]
    _check_split((n,), p)
    nl = n // p
    sl = slice(me * nl, (me + 1) * nl)
    out, pout = sample_sort_local(x[:, sl].contiguous(), group=group,
                                  pos=None if pos is None else pos[:, sl].contiguous())
    full = comm.all_gather_cat(out, group, dim=1)
    return full, (None if pout is None else comm.all_gather_cat(pout, group, dim=1))


def sample_merge_k(lists: Sequence[torch.Tensor], *, mesh, axis_name: str,
                   pos: Optional[Sequence[torch.Tensor]] = None):
    """k-way merge of sorted (B, n_i) lists over ``mesh[axis_name]``: full
    lists in on every rank, the full merge out. Every ``n_i`` must divide
    over the axis."""
    lists = list(lists)
    group, p, me = _axis(mesh, axis_name)
    lens = [int(t.shape[-1]) for t in lists]
    _check_split(lens, p)

    def mine(t, ln):
        return t[:, me * (ln // p):(me + 1) * (ln // p)].contiguous()

    out, pout = sample_merge_k_local(
        [mine(t, ln) for t, ln in zip(lists, lens)], group=group,
        pos=None if pos is None else [mine(t, ln) for t, ln in zip(pos, lens)])
    full = comm.all_gather_cat(out, group, dim=1)
    return full, (None if pout is None else comm.all_gather_cat(pout, group, dim=1))
