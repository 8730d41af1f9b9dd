"""Segmented (CSR ragged) sort / merge / top-k over size-class buckets.

Counterpart of ``repro.segmented.core``. One call:

1. ``bucketing`` groups the static segments into pow2 size classes;
2. per class, a gather map packs the member segments into a dense
   ``(n_segments, width)`` tile and **one** class launch
   (:mod:`repro_torch.kernels.segmented`) sorts or merges every row;
3. a scatter map writes each row's valid prefix back to the flat CSR
   output.

Segments past the class cutover (:func:`max_class_width`, the
reference's: 1024 for every dtype the port takes) spill, grouped by exact
length: top-k spills take the stable top-k (``repro_torch.topk(...,
stable=True)``: the vocab kernels, then ``stabilize_ties``); sort and
merge spills that carry a permutation take a stable argsort of the keys,
as the reference's XLA path does. Values-only spills run on the keys as
the reference's do: a sort spill chunk-sorts every tile of every row in
one class-sort launch (kernel row 6), then merges the sorted runs
pairwise with the grid merge (row 9), one launch a level of pairs (two
where an odd run meets the rest); a merge spill is one grid merge.

A card tensor runs the CUDA class kernels; a CPU tensor their plain
versions, so the CPU tests exercise what the card runs. Each class
launch takes the family (and a merge the column count) of
``plan_op("segmented")``: an autotune winner where the cache holds one.
``nan_policy="unsafe"`` runs as ``"last"`` with -0.0 and +0.0 tied (see
``_check_values``).

``set_segmented_enabled(False)`` (or ``REPRO_DISABLE_SEGMENTED=1``, the
reference's switch) is the escape hatch: auto routing of the
``segment_*`` ops plans the per-segment plain version
(``segmented/reference.py``) instead of the class launches, on the card
too, and the MoE dispatch sorts on the schedule executor. An explicit
``backend="segmented"`` still runs the class kernels.

Telemetry (``REPRO_OBS`` on), with the reference's series:
``segmented.class_launches`` counts the class-kernel calls a call makes,
each one launch on the card (``LAUNCHES["seg_sort"]`` plus
``["seg_merge"]``): one a size class wider than 1 (a class of width 1
sorts nothing and launches nothing) and one a values-only sort spill
group (its chunk sort). The reference counts its classes, once a
compilation. ``spill_groups``, ``spill_segments``, ``padded_slots``,
``valid_slots`` and the ``padded_waste_frac`` histogram are the
reference's, counted a call.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.common import (decode_key_values, encode_key_values,
                                        flip_keys, key_transformable, sentinel_max,
                                        sentinel_min, take_along, tie_signed_zeros)
from repro_torch.kernels.segmented import segment_class_merge, segment_class_sort
from repro_torch.networks import merge_program
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.failpoints import failpoint
from repro_torch.streaming.chunked import _chunked_merge2
from repro_torch.streaming.grid_merge import grid_chunked_merge2, grid_merge2_rows
from repro_torch.streaming.planner import MergePlan, plan_chunked, sort_fits_vmem

from .bucketing import (SizeClass, bucket_merge_pairs, bucket_segments,
                        gather_map, normalize_offsets, scatter_map,
                        segment_lengths)
from .reference import ref_segment_merge, ref_segment_sort, ref_segment_topk

#: hard cap on the dense class width (the reference's ``MAX_CLASS_WIDTH``)
MAX_CLASS_WIDTH = 2048

_ENABLED = True


def segmented_enabled() -> bool:
    """Whether auto routing may pick the class kernels (the switch and
    ``REPRO_DISABLE_SEGMENTED``)."""
    return _ENABLED and os.environ.get("REPRO_DISABLE_SEGMENTED") != "1"


def set_segmented_enabled(enabled: bool) -> bool:
    """Turn the class kernels' auto routing on or off; returns the
    previous setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev

#: the network family the class launches run (the planner's heuristic
#: default; the reference's autotune cache may pick another)
def class_plan(widths: Tuple[int, ...], n_segs: int, dtype: torch.dtype):
    """The plan of one class launch (``plan_op("segmented")``): the
    family, and for a class merge the column count, that an autotune
    sweep cached, else the heuristic's (the loms family)."""
    from repro_torch.streaming.planner import plan_op

    return plan_op("segmented", widths, batch=n_segs, dtype=dtype)
#: the chunk a values-only sort spill sorts in one class launch, and the
#: tile of its grid merges (the reference's ``min(512, max_class_width)``)
SPILL_TILE = 512


def max_class_width(dtype: torch.dtype) -> int:
    """Largest pow2 class width whose sort working set fits the
    reference's routing budget at a one-row tile (``sort_fits_vmem``):
    the class vs spill cutover, which decides tie order, so it is the
    reference's and not a shared-memory budget of the card."""
    w = MAX_CLASS_WIDTH
    while w > 2 and not sort_fits_vmem(w, dtype=dtype):
        w //= 2
    return w


def _record_bucketing(op: str, classes, spill, launches: int) -> None:
    """The ``segmented.*`` series of one call. ``classes`` / ``spill``
    hold :class:`SizeClass` entries for sort and top-k and ``(ca, cb)``
    pairs for merge; ``launches``: the class-kernel calls the call made.
    The padded-slot waste is the share of class-kernel lanes that carry
    sentinel padding rather than data."""
    if not obs_trace.enabled():
        return

    def slots(group) -> int:
        if isinstance(group, tuple):  # merge pair
            ca, cb = group
            return ca.n * (ca.width + cb.width)
        return group.n * group.width

    def valid(group) -> int:
        if isinstance(group, tuple):
            return sum(group[0].lens) + sum(group[1].lens)
        return sum(group.lens)

    class_slots = sum(slots(g) for g in classes)
    class_valid = sum(valid(g) for g in classes)
    spill_segs = sum((g[0].n if isinstance(g, tuple) else g.n) for g in spill)
    obs_metrics.counter("segmented.class_launches").inc(launches, op=op)
    obs_metrics.counter("segmented.spill_groups").inc(len(spill), op=op)
    obs_metrics.counter("segmented.spill_segments").inc(spill_segs, op=op)
    obs_metrics.counter("segmented.padded_slots").inc(class_slots - class_valid, op=op)
    obs_metrics.counter("segmented.valid_slots").inc(class_valid, op=op)
    if class_slots:
        obs_metrics.histogram("segmented.padded_waste_frac").observe(
            (class_slots - class_valid) / class_slots, op=op)


def _check_values(x: torch.Tensor, nan_policy: str) -> None:
    """``nan_policy``: ``"last"``, or ``"unsafe"`` (the caller vouches for
    finite, NaN-free values). The port runs both on the total-order keys;
    under ``"unsafe"`` -0.0 takes +0.0's key (``zero_ties``), so on such
    values the keys order as the reference's raw floats do, ties included.
    The spills of ``segment_topk`` and the values-only spills (segments
    past the class width) keep the ``"last"`` order."""
    if nan_policy not in ("last", "unsafe"):
        raise ValueError(f"nan_policy must be 'last' or 'unsafe', got {nan_policy!r}")
    if x.dtype.is_floating_point and not key_transformable(x.dtype):
        raise TypeError(f"segmented ops take float32, bfloat16, float16 or "
                        f"integer values, not {x.dtype}")


def _flatten_leaves(payload, n: int):
    """Payload tree -> flat (N[, F]) lanes and a rebuild closure."""
    leaves, spec = pytree.tree_flatten(payload)
    lanes, trails = [], []
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != n:
            raise ValueError(f"payload leaf of shape {tuple(leaf.shape)} does "
                             f"not lead with the {n} values")
        trail = tuple(leaf.shape[1:])
        lanes.append(leaf.reshape(n, math.prod(trail)) if trail else leaf)
        trails.append(trail)

    def rebuild(outs, m: int):
        return pytree.tree_unflatten(
            [o.reshape((m,) + t) for o, t in zip(outs, trails)], spec)

    return lanes, rebuild


def _ext(x: torch.Tensor) -> torch.Tensor:
    """Append one zero slot: the target of the gather maps' pad lanes."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _idx(m: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, np.int64), device=device)


def _take(ext: torch.Tensor, gmap: np.ndarray) -> torch.Tensor:
    return ext[_idx(gmap, ext.device)]


def _scatter(out: torch.Tensor, smap: np.ndarray, dense: torch.Tensor):
    """Write a class tile into the flat output; trash lanes all land on
    the last slot, which the caller drops."""
    flat = dense.reshape((-1,) + tuple(dense.shape[2:]))
    return out.index_put_((_idx(smap, out.device).reshape(-1),), flat)


def _take_perm(dense_lane: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    idx = perm.long()
    if dense_lane.ndim > idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (dense_lane.ndim - idx.ndim))
        idx = idx.expand(tuple(idx.shape[:2]) + tuple(dense_lane.shape[2:]))
    return take_along(dense_lane, 1, idx)


def _lens_col(cls: SizeClass, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(cls.lens, np.int32)[:, None], device=device)


def _zero_ties(x: torch.Tensor, nan_policy: str) -> bool:
    return nan_policy == "unsafe" and x.dtype.is_floating_point


def _keys_for(x: torch.Tensor, descending: bool, zero_ties: bool = False) -> torch.Tensor:
    keys = encode_key_values(x) if key_transformable(x.dtype) else x
    if zero_ties:
        keys = tie_signed_zeros(keys)
    return flip_keys(keys) if descending else keys


def _undo_keys(keys: torch.Tensor, dtype: torch.dtype, descending: bool) -> torch.Tensor:
    """Sorted keys back to values: the inverse of :func:`_keys_for` (a NaN
    comes out canonical, as the reference's values-only spills give it)."""
    v = flip_keys(keys) if descending else keys
    return decode_key_values(v, dtype) if key_transformable(dtype) else v


def spill_merge_level(cur: torch.Tensor, m: int, ln: int, rest: int, tile: int):
    """One level of the values-only sort spill: each (rows, W) row of
    ``cur`` holds ``m`` sorted runs of ``ln``, then one run of ``rest``
    (0: none). Runs pair up in order, as the reference's list of runs
    does, the last run carried when the count is odd: the equal pairs of
    every row merge in one grid launch, the pair of a run of ``ln`` with
    the one of ``rest`` in a second. Returns ``(next, m', ln', rest')``."""
    s, width = cur.shape
    nxt = torch.empty_like(cur)
    p = m // 2
    if p:
        pairs = cur[:, :2 * p * ln].unflatten(1, (p, 2 * ln))
        grid_merge2_rows(pairs[..., :ln], pairs[..., ln:],
                         nxt[:, :2 * p * ln].unflatten(1, (p, 2 * ln)), tile=tile)
    tail = 2 * p * ln
    if m % 2 and rest:  # the odd run of ln merges with the rest
        grid_merge2_rows(cur[:, None, tail:tail + ln], cur[:, None, tail + ln:width],
                         nxt[:, None, tail:width], tile=tile)
        return nxt, p, 2 * ln, ln + rest
    nxt[:, tail:] = cur[:, tail:]  # the odd run, or the rest, carried
    return nxt, p, 2 * ln, (ln if m % 2 else rest)


def _merge_positions(ka: torch.Tensor, kb: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                     tile: int):
    """(keys, positions): the key rows ``ka`` / ``kb`` merged, and their
    positions ``pa`` / ``pb`` in the order the reference's grid merge puts
    them, ties included: its carry loop (``chunked_merge(mode="loop")``)
    at the grid merge's program, the positions as the payload."""
    plan = MergePlan(n_cols=merge_program("loms", tile, tile).n_cols, use_mxu=False)
    return _chunked_merge2(ka, kb, tile, plan, pa, pb)


def _spill_positions(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """The reference's values-only sort spill on (S, c x tile) keys,
    carried out on positions: every tile sorted by the class kernel (its
    permutation), then the runs of each row merged pairwise in order (the
    odd one carried) by :func:`_merge_positions`. Returns the (S, c x
    tile) positions in the reference's order, ties included."""
    s, width = keys.shape
    c = width // tile
    lens = torch.full((s * c, 1), tile, dtype=torch.int32, device=keys.device)
    srt, perm, _ = segment_class_sort(keys.reshape(s * c, tile).contiguous(), lens,
                                      network=class_plan((tile,), s * c, keys.dtype).network,
                                      want_perm=True)
    base = torch.arange(c, dtype=torch.int32, device=keys.device)[:, None] * tile
    srt, pos = srt.reshape(s, c, tile), (perm.reshape(s, c, tile) + base)
    runs = [(srt[:, i], pos[:, i]) for i in range(c)]
    while len(runs) > 1:
        nxt = [_merge_positions(runs[i][0], runs[i + 1][0], runs[i][1], runs[i + 1][1], tile)
               for i in range(0, len(runs) - 1, 2)]
        runs = nxt + runs[len(runs) - len(runs) % 2:]
    return runs[0][1]


def _spill_sort_values(dense: torch.Tensor, descending: bool, tile: int,
                       zero_ties: bool = False) -> torch.Tensor:
    """Values-only sort of equal-length long rows: every tile of every row
    sorted in one class launch, then the sorted runs of each row merged
    pairwise by the grid merge, one launch a level. With ``zero_ties``
    (-0.0 and +0.0 tie, so equal keys hold unequal values) the runs carry
    positions (:func:`_spill_positions`) and the raw values are gathered
    at them."""
    failpoint("segmented.spill.values")
    s, ln = dense.shape
    keys = _keys_for(dense, descending, zero_ties)
    c = -(-ln // tile)
    if c * tile != ln:
        keys = torch.cat([keys, keys.new_full((s, c * tile - ln),
                                              sentinel_max(keys.dtype))], dim=1)
    if zero_ties:
        return take_along(dense, 1, _spill_positions(keys, tile)[:, :ln])
    lens = torch.full((s * c, 1), tile, dtype=torch.int32, device=dense.device)
    cur = segment_class_sort(keys.reshape(s * c, tile).contiguous(), lens,
                             network=class_plan((tile,), s * c, keys.dtype).network
                             )[0].reshape(s, c * tile)
    m, run, rest = c, tile, 0
    while m + (rest > 0) > 1:
        cur, m, run, rest = spill_merge_level(cur, m, run, rest, tile)
    return _undo_keys(cur[:, :ln], dense.dtype, descending)


def _spill_sort_perm(dense: torch.Tensor, descending: bool, zero_ties: bool = False):
    """Permutation-carrying spill rows: a stable argsort of the keys, as
    the reference's batched XLA path."""
    failpoint("segmented.spill.perm")
    order = torch.argsort(_keys_for(dense, descending, zero_ties), dim=-1, stable=True)
    return take_along(dense, 1, order), order.to(torch.int32)


def _zeros(n: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.zeros((n,) + tuple(like.shape[1:]), dtype=dtype or like.dtype,
                       device=like.device)


# ---------------------------------------------------------------------------
# segment_sort
# ---------------------------------------------------------------------------


def segment_sort_impl(values: torch.Tensor, offsets, *, descending: bool = False,
                      payload=None, nan_policy: str = "last",
                      want_perm: bool = False, use_kernel: bool = True):
    """Sort each CSR segment on its own: ``(values, perm | None,
    payload_tree | None)``. ``use_kernel=False`` runs the per-segment
    plain version (``reference.py``) in place of the class path."""
    offs = normalize_offsets(offsets)
    n = offs[-1]
    if values.ndim != 1 or values.shape[0] != n:
        raise ValueError(f"values of shape {tuple(values.shape)} do not match "
                         f"offsets ending at {n}")
    _check_values(values, nan_policy)
    lanes, rebuild = ([], None) if payload is None else _flatten_leaves(payload, n)
    need_perm = want_perm or payload is not None
    zt = _zero_ties(values, nan_policy)
    if not use_kernel:
        out, perm, pouts = ref_segment_sort(values, offs, descending=descending, zero_ties=zt,
                                            payload_lanes=lanes)
        return (out, perm if want_perm else None,
                None if payload is None else rebuild(list(pouts), n))
    mw = max_class_width(values.dtype)
    classes, spill = bucket_segments(segment_lengths(offs), mw)
    dev = values.device
    vext, lext = _ext(values), [_ext(l) for l in lanes]
    out_v = _zeros(n + 1, values)
    out_p = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    out_l = [_zeros(n + 1, l) for l in lanes]

    for cls in classes:
        gmap = gather_map(offs, cls, n)
        dense = _take(vext, gmap)
        p_dense = [_take(lx, gmap) for lx in lext]
        if cls.width == 1:  # nothing to sort: no network, no launch
            res_v, res_perm, res_l = dense, torch.zeros(
                gmap.shape, dtype=torch.int32, device=dev), p_dense
        else:
            res_v, res_perm, res_l = segment_class_sort(
                dense, _lens_col(cls, dev), p_dense,
                network=class_plan((cls.width,), cls.n, values.dtype).network,
                flip=descending, want_perm=need_perm, zero_ties=zt)
        smap = scatter_map(offs, cls, cls.width)
        _scatter(out_v, smap, res_v)
        if need_perm:
            _scatter(out_p, smap, res_perm)
        for o, r in zip(out_l, res_l):
            _scatter(o, smap, r)

    for cls in spill:  # equal exact-length groups past the class width
        gmap = gather_map(offs, cls, n)
        smap = scatter_map(offs, cls, cls.width)
        if not need_perm:
            _scatter(out_v, smap, _spill_sort_values(_take(vext, gmap), descending,
                                                     min(SPILL_TILE, mw), zt))
            continue
        res_v, res_perm = _spill_sort_perm(_take(vext, gmap), descending, zt)
        _scatter(out_v, smap, res_v)
        _scatter(out_p, smap, res_perm)
        for o, lx in zip(out_l, lext):
            _scatter(o, smap, _take_perm(_take(lx, gmap), res_perm))

    _record_bucketing("segment_sort", classes, spill,
                      sum(c.width > 1 for c in classes) + (0 if need_perm else len(spill)))
    ptree = None if payload is None else rebuild([o[:n] for o in out_l], n)
    return out_v[:n], (out_p[:n] if want_perm else None), ptree


# ---------------------------------------------------------------------------
# segment_merge
# ---------------------------------------------------------------------------


def _cat_csr(lane_a, lane_b, offs_a, offs_b) -> torch.Tensor:
    """Interleave two CSR lanes into the merged layout (per segment: a's
    entries, then b's)."""
    na = offs_a[-1]
    parts = [np.concatenate([np.arange(offs_a[s], offs_a[s + 1]),
                             na + np.arange(offs_b[s], offs_b[s + 1])])
             for s in range(len(offs_a) - 1)]
    idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return torch.cat([lane_a, lane_b])[_idx(idx, lane_a.device)]


def segment_merge_impl(a: torch.Tensor, b: torch.Tensor, offsets_a, offsets_b, *,
                       descending: bool = False, payload=None,
                       nan_policy: str = "last", want_perm: bool = False,
                       use_kernel: bool = True):
    """Merge per-segment sorted runs ``a[s]`` and ``b[s]``: ``(values,
    perm | None, payload_tree | None, out_offsets)``; ``perm`` holds
    positions in the concatenated segment (a first, then b).
    ``use_kernel=False`` runs the per-segment plain version."""
    offs_a, offs_b = normalize_offsets(offsets_a), normalize_offsets(offsets_b)
    if len(offs_a) != len(offs_b):
        raise ValueError("the two runs need the same number of segments")
    na, nb = offs_a[-1], offs_b[-1]
    if a.shape != (na,) or b.shape != (nb,) or a.dtype != b.dtype:
        raise ValueError(f"runs of shapes {tuple(a.shape)}, {tuple(b.shape)} do "
                         f"not match offsets ending at {na}, {nb}")
    _check_values(a, nan_policy)
    out_offs = tuple(x + y for x, y in zip(offs_a, offs_b))
    total = na + nb
    lanes, rebuild = [], None
    if payload is not None:
        tree_a, tree_b = payload
        la, rebuild = _flatten_leaves(tree_a, na)
        lb, _ = _flatten_leaves(tree_b, nb)
        lanes = [_cat_csr(pa, pb, offs_a, offs_b) for pa, pb in zip(la, lb)]
    need_perm = want_perm or payload is not None
    if not use_kernel:
        out, perm, pouts, _ = ref_segment_merge(a, b, offs_a, offs_b, descending=descending,
                                                zero_ties=_zero_ties(a, nan_policy),
                                                payload_lanes=lanes)
        return (out, perm if want_perm else None,
                None if payload is None else rebuild(list(pouts), total), out_offs)
    dev = a.device
    mw = max_class_width(a.dtype)
    classes, spill = bucket_merge_pairs(segment_lengths(offs_a),
                                        segment_lengths(offs_b), mw)
    aext, bext, lext = _ext(a), _ext(b), [_ext(l) for l in lanes]
    out_v = _zeros(total + 1, a)
    out_p = torch.zeros((total + 1,), dtype=torch.int32, device=dev)
    out_l = [_zeros(total + 1, l) for l in lanes]

    def lane_gmap(ca: SizeClass, cb: SizeClass) -> np.ndarray:
        """Dense-coordinate gather map of the merged-CSR payload lanes: a's
        lanes fill [0, Wa), b's [Wa, Wa + Wb)."""
        ga = np.full((ca.n, ca.width), total, np.int64)
        gb = np.full((cb.n, cb.width), total, np.int64)
        for r, sid in enumerate(ca.seg_ids):
            o0 = out_offs[sid]
            ga[r, :ca.lens[r]] = o0 + np.arange(ca.lens[r])
            gb[r, :cb.lens[r]] = o0 + ca.lens[r] + np.arange(cb.lens[r])
        return np.concatenate([ga, gb], axis=1)

    for ca, cb in classes:
        dense_a = _take(aext, gather_map(offs_a, ca, na))
        dense_b = _take(bext, gather_map(offs_b, cb, nb))
        p_dense = [_take(lx, lane_gmap(ca, cb)) for lx in lext]
        plan = class_plan((ca.width, cb.width), ca.n, a.dtype)
        res_v, res_perm, res_l = segment_class_merge(
            dense_a, dense_b, _lens_col(ca, dev), _lens_col(cb, dev), p_dense,
            network=plan.network, flip=descending, want_perm=need_perm,
            n_cols=plan.n_cols if plan.network == "loms" else None,
            zero_ties=_zero_ties(a, nan_policy))
        out_cls = SizeClass(width=ca.width + cb.width, seg_ids=ca.seg_ids,
                            lens=tuple(x + y for x, y in zip(ca.lens, cb.lens)))
        smap = scatter_map(out_offs, out_cls, out_cls.width)
        _scatter(out_v, smap, res_v)
        if need_perm:
            _scatter(out_p, smap, res_perm)
        for o, r in zip(out_l, res_l):
            _scatter(o, smap, r)

    for ca, cb in spill:  # exact-length groups past the class width
        dense_a = _take(aext, gather_map(offs_a, ca, na))
        dense_b = _take(bext, gather_map(offs_b, cb, nb))
        ln = ca.width + cb.width
        smap = scatter_map(out_offs, SizeClass(width=ln, seg_ids=ca.seg_ids,
                                               lens=(ln,) * ca.n), ln)
        zt = _zero_ties(a, nan_policy)
        if not need_perm:  # one grid merge of the keys
            ka, kb = _keys_for(dense_a, descending, zt), _keys_for(dense_b, descending, zt)
            tile = plan_chunked(ca.width, cb.width, batch=ca.n, dtype=ka.dtype).tile
            if zt:  # equal keys, unequal values: the merge's positions
                pa = torch.arange(ca.width, dtype=torch.int32, device=dev).expand(ca.n, -1)
                pb = (ca.width + torch.arange(cb.width, dtype=torch.int32, device=dev)
                      ).expand(ca.n, -1)
                pos = _merge_positions(ka, kb, pa, pb, tile)[1]
                _scatter(out_v, smap, take_along(torch.cat([dense_a, dense_b], 1), 1, pos))
                continue
            _scatter(out_v, smap, _undo_keys(grid_chunked_merge2(ka, kb, tile=tile),
                                             a.dtype, descending))
            continue
        res_v, res_perm = _spill_sort_perm(torch.cat([dense_a, dense_b], dim=1),
                                           descending, _zero_ties(a, nan_policy))
        _scatter(out_v, smap, res_v)
        _scatter(out_p, smap, res_perm)
        for o, lx in zip(out_l, lext):
            _scatter(o, smap, _take_perm(_take(lx, lane_gmap(ca, cb)), res_perm))

    _record_bucketing("segment_merge", classes, spill, len(classes))
    ptree = None if payload is None else rebuild([o[:total] for o in out_l], total)
    return out_v[:total], (out_p[:total] if want_perm else None), ptree, out_offs


# ---------------------------------------------------------------------------
# segment_topk / segment_argmax
# ---------------------------------------------------------------------------


def normalize_ks(k, n_segs: int) -> Tuple[int, ...]:
    if isinstance(k, (int, np.integer)):
        ks = (int(k),) * n_segs
    else:
        ks = tuple(int(x) for x in k)
        if len(ks) != n_segs:
            raise ValueError(f"{len(ks)} values of k for {n_segs} segments")
    if any(x < 0 for x in ks):
        raise ValueError(f"k must be >= 0, got {ks}")
    return ks


def segment_topk_impl(values: torch.Tensor, offsets, k, *, descending: bool = True,
                      payload=None, nan_policy: str = "last", use_kernel: bool = True):
    """Per-segment top-k (``descending=False``: the smallest, ascending);
    ``k`` one int or one per segment. A size class runs **one** launch
    with its largest k and each segment keeps its own prefix. Returns
    ``(values, idx, payload_tree | None, out_offsets)`` in CSR layout
    with ``min(k_s, len_s)`` entries per segment; ``idx`` are positions
    within the segment. ``use_kernel=False`` runs the per-segment plain
    version."""
    offs = normalize_offsets(offsets)
    n = offs[-1]
    if values.ndim != 1 or values.shape[0] != n:
        raise ValueError(f"values of shape {tuple(values.shape)} do not match "
                         f"offsets ending at {n}")
    _check_values(values, nan_policy)
    lengths = segment_lengths(offs)
    ks = normalize_ks(k, len(offs) - 1)
    counts = [min(k_s, int(ln)) for k_s, ln in zip(ks, lengths)]
    # ints, also for zero segments (the reference's np.cumsum([]) is a float)
    out_offs = (0,) + tuple(itertools.accumulate(counts))
    total = out_offs[-1]
    lanes, rebuild = ([], None) if payload is None else _flatten_leaves(payload, n)
    if not use_kernel:
        out, idx, pouts, _ = ref_segment_topk(values, offs, ks, descending=descending,
                                              zero_ties=_zero_ties(values, nan_policy),
                                              payload_lanes=lanes)
        return out, idx, None if payload is None else rebuild(list(pouts), total), out_offs
    dev = values.device
    mw = max_class_width(values.dtype)
    classes, spill = bucket_segments(lengths, mw)
    vext, lext = _ext(values), [_ext(l) for l in lanes]
    out_v = _zeros(total + 1, values)
    out_i = torch.zeros((total + 1,), dtype=torch.int32, device=dev)
    out_l = [_zeros(total + 1, l) for l in lanes]

    for cls in classes:
        cnts = [counts[sid] for sid in cls.seg_ids]
        k_out = max(max(cnts), 1)
        gmap = gather_map(offs, cls, n)
        dense = _take(vext, gmap)
        p_dense = [_take(lx, gmap) for lx in lext]
        if cls.width == 1:
            res_v, res_l = dense[:, :1], [p[:, :1] for p in p_dense]
            res_perm = torch.zeros((cls.n, 1), dtype=torch.int32, device=dev)
        else:
            res_v, res_perm, res_l = segment_class_sort(
                dense, _lens_col(cls, dev), p_dense, k_out=k_out,
                network=class_plan((cls.width,), cls.n, values.dtype).network,
                flip=descending, want_perm=True, zero_ties=_zero_ties(values, nan_policy))
        smap = scatter_map(out_offs, cls, k_out, counts=cnts, trash=total)
        _scatter(out_v, smap, res_v)
        _scatter(out_i, smap, res_perm)
        for o, r in zip(out_l, res_l):
            _scatter(o, smap, r)

    for cls in spill:  # equal-length vocab-scale rows
        failpoint("segmented.spill.topk")
        cnts = [counts[sid] for sid in cls.seg_ids]
        k_out = max(max(cnts), 1)
        gmap = gather_map(offs, cls, n)
        dense = _take(vext, gmap)
        if descending:
            from repro_torch.api.ops import topk

            # stable: idx are genuine positions, ties by ascending position
            res_v, res_perm = topk(dense, k_out, stable=True, nan_policy=nan_policy)
        else:
            order = torch.argsort(_keys_for(dense, False, _zero_ties(values, nan_policy)),
                                  dim=-1, stable=True)[:, :k_out]
            res_v, res_perm = take_along(dense, 1, order), order.to(torch.int32)
        smap = scatter_map(out_offs, cls, k_out, counts=cnts, trash=total)
        _scatter(out_v, smap, res_v)
        _scatter(out_i, smap, res_perm)
        for o, lx in zip(out_l, lext):
            _scatter(o, smap, _take_perm(_take(lx, gmap), res_perm))

    _record_bucketing("segment_topk", classes, spill, sum(c.width > 1 for c in classes))
    ptree = None if payload is None else rebuild([o[:total] for o in out_l], total)
    return out_v[:total], out_i[:total], ptree, out_offs


def segment_argmax_impl(values: torch.Tensor, offsets, *, nan_policy: str = "last",
                        use_kernel: bool = True):
    """Per-segment argmax ``(vals (S,), idx (S,))``; an empty segment
    gives the dtype minimum and index -1."""
    offs = normalize_offsets(offsets)
    n_segs = len(offs) - 1
    vals, idx, _, out_offs = segment_topk_impl(values, offs, 1, descending=True,
                                               nan_policy=nan_policy, use_kernel=use_kernel)
    has = torch.as_tensor(np.diff(np.asarray(out_offs)) > 0, device=values.device)
    src = _idx(np.minimum(np.asarray(out_offs[:-1]), max(out_offs[-1] - 1, 0)),
               values.device)
    if out_offs[-1]:
        got_v, got_i = vals[src], idx[src]
    else:
        got_v = torch.zeros((n_segs,), dtype=values.dtype, device=values.device)
        got_i = torch.zeros((n_segs,), dtype=torch.int32, device=values.device)
    fill = torch.full_like(got_v, sentinel_min(values.dtype))
    return torch.where(has, got_v, fill), torch.where(has, got_i, -1).to(torch.int32)
