"""Public sorting-library entry points of the port.

Counterpart of ``repro.api.ops``:

* ``topk`` as the reference's TPU route runs it: last axis of a 2-D
  tensor, descending, ``nan_policy="last"``, the router kernel for an
  axis of at most 512 and the vocab kernels above, int32 indices with -1
  on pad slots, the planner's block. ``stable=True`` is the reference's
  pallas rung (``api/ops.py:498``): the same kernels on the keys, then
  ``stabilize_ties``, values gathered from the input.
* ``segment_sort / segment_merge / segment_topk / segment_argmax`` over
  static CSR offsets (:mod:`repro_torch.segmented`): the class kernels for
  a card tensor, their plain versions for a CPU tensor.
* ``merge``, ``merge_k``, ``sort`` and ``median_of_lists`` along any
  axis, routed by ``plan`` as the reference routes them on its
  accelerator: one rung, the planned one, and no degradation ladder (a
  failure raises). A fused rung is one launch of kernel row 1 (merge),
  row 2 (sort) or row 8 (k-way merge); the median is one launch of row 8
  on the two-stage device; a merge past the routing budget streams
  through row 9 (two lists) or row 8's tiles (more). The schedule
  executor runs ``merge_k`` and ``median`` where the reference sends
  them there (payloads past the budget, ``stable=True``, another
  network, unequal median lists). Routes the port lacks raise
  ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.common import (decode_key_values, encode_key_values,
                                        key_transformable, take_along)
from repro_torch.kernels.topk import (
    ROUTER_TOPK_MAX,
    plan_block,
    router_topk,
    topk_tiles,
    vocab_topk,
)

from .payload import stabilize_ties, take_rows

__all__ = ["topk", "topk_block", "merge", "merge_k", "sort", "median_of_lists",
           "segment_sort", "segment_merge", "segment_topk", "segment_argmax"]

_KEY_PAD = torch.iinfo(torch.int32).min


def topk_block(n: int, k: int) -> int:
    """The block the fused rung uses for a top-k over an axis of ``n``."""
    return topk_tiles(1, n, block=plan_block(n, k))[0]


def topk(x: torch.Tensor, k: int, *, descending: bool = True,
         stable: bool = False, nan_policy: str = "last"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis of a (rows, n) float tensor,
    descending: ``(values, int32 indices)``.

    NaNs rank above +inf and -0.0 below +0.0. Among equal values the
    higher index comes first, as the reference's kernels order them; with
    ``stable=True`` the lower index comes first and the values are the
    input's own bits. Runs on the tensor's device: the CUDA kernels for a
    card tensor, their plain versions for a CPU tensor."""
    if not descending:
        raise NotImplementedError("this slice ports the descending top-k only")
    if nan_policy != "last":
        raise NotImplementedError("this slice ports nan_policy='last' only")
    if x.ndim != 2:
        raise ValueError(f"topk takes a 2-D tensor, got shape {tuple(x.shape)}")
    n = x.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for an axis of {n}")
    block = topk_block(n, k)
    x = x.contiguous()
    if n <= ROUTER_TOPK_MAX:
        vals, idx = router_topk(x, k, block=block)
    else:
        vals, idx = vocab_topk(x, k, block=block)
    if not stable:
        return vals, idx
    keys = torch.where(idx < 0, _KEY_PAD, encode_key_values(vals))
    keys, idx = stabilize_ties(keys, idx, descending=True)
    got = take_along(x, 1, torch.where(idx < 0, 0, idx))
    return torch.where(idx < 0, decode_key_values(keys, x.dtype), got), idx


def _as_tensor(x, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device`` (the
    card unless the caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x)).to(resolve_device(device))


def segment_sort(values, segment_offsets, *, descending: bool = False,
                 payload=None, nan_policy: str = "last",
                 device: DeviceLike = None):
    """Sort each CSR segment of the flat ``values`` on its own.

    ``segment_offsets`` are host ints ``[0, ..., N]``. ``payload`` is a
    tensor or a tree of tensors whose leaves lead with the N axis; they
    ride each segment's permutation. Returns the sorted values, or
    ``(values, payload_tree)``."""
    from repro_torch.segmented import segment_sort_impl

    out, _, ptree = segment_sort_impl(
        _as_tensor(values, device), segment_offsets, descending=descending,
        payload=payload, nan_policy=nan_policy)
    return out if payload is None else (out, ptree)


def segment_merge(a, b, offsets_a, offsets_b, *, descending: bool = False,
                  payload=None, nan_policy: str = "last",
                  device: DeviceLike = None):
    """Merge per-segment sorted runs: output segment ``s`` is the sorted
    union of ``a``'s and ``b``'s segment ``s``. ``payload`` is a pair
    ``(tree_a, tree_b)``. Returns ``(values, out_offsets)`` or
    ``(values, payload_tree, out_offsets)``."""
    from repro_torch.segmented import segment_merge_impl

    out, _, ptree, out_offs = segment_merge_impl(
        _as_tensor(a, device), _as_tensor(b, device), offsets_a, offsets_b,
        descending=descending, payload=payload, nan_policy=nan_policy)
    return (out, out_offs) if payload is None else (out, ptree, out_offs)


def segment_topk(values, segment_offsets, k, *, descending: bool = True,
                 payload=None, nan_policy: str = "last",
                 device: DeviceLike = None):
    """Per-segment top-k: the ``min(k_s, len_s)`` largest entries of each
    segment, descending (``descending=False``: the smallest, ascending).
    ``k`` is one int or one per segment. Returns ``(values, idx,
    out_offsets)`` (a ``payload_tree`` before the offsets with a payload):
    CSR layout, ``idx`` int32 positions within the segment."""
    from repro_torch.segmented import segment_topk_impl

    out, idx, ptree, out_offs = segment_topk_impl(
        _as_tensor(values, device), segment_offsets, k, descending=descending,
        payload=payload, nan_policy=nan_policy)
    return (out, idx, out_offs) if payload is None else (out, idx, ptree, out_offs)


def segment_argmax(values, segment_offsets, *, nan_policy: str = "last",
                   device: DeviceLike = None):
    """Per-segment argmax ``(vals (S,), idx (S,))``; empty segments give
    the dtype minimum and index -1."""
    from repro_torch.segmented import segment_argmax_impl

    return segment_argmax_impl(_as_tensor(values, device), segment_offsets,
                               nan_policy=nan_policy)


# ---------------------------------------------------------------------------
# merge / sort
# ---------------------------------------------------------------------------

#: the dtypes the kernels take (floats as total-order keys, int32 raw)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)

#: what each route the port lacks waits for
_MISSING = {
    "schedule": "the schedule executor (ROADMAP Queue 1, item 4)",
}
#: the ops whose schedule route is ported
_SCHEDULE_OPS = ("merge_k", "median")


def _check_dtype(dtype: torch.dtype, nan_policy: str) -> None:
    if nan_policy == "unsafe":
        raise NotImplementedError(
            "nan_policy='unsafe' (raw floats through the networks) is not ported "
            "(ROADMAP Queue 1, item 4)")
    if nan_policy != "last":
        raise ValueError(f"nan_policy must be 'last' or 'unsafe', got {nan_policy!r}")
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"{dtype}: the port's kernels take float32, bfloat16, float16 and int32 "
            "(uint32 and the other integer types: ROADMAP Queue 3)")


def _fused_leaves(payload, ax: int, ndim: int):
    """A payload tree as (B, L[, F]) kernel lanes, and ``rebuild(outs,
    length)`` that puts the permuted lanes back into the tree."""
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(payload)
    lanes, shapes = [], []
    for leaf in leaves:
        if leaf.ndim < ndim:
            raise ValueError(f"payload leaf of shape {tuple(leaf.shape)} has fewer "
                             f"than the values' {ndim} dims")
        lm = torch.movedim(leaf, ax, ndim - 1)
        lead, trail = tuple(lm.shape[:ndim]), tuple(lm.shape[ndim:])
        feat = int(np.prod(trail)) if trail else None
        lanes.append(lm.reshape((-1, lead[-1]) + ((feat,) if trail else ()))
                     .contiguous())
        shapes.append((lead, trail))

    def rebuild(pouts, out_len: int):
        outs = [torch.movedim(p.reshape(lead[:-1] + (out_len,) + trail), ndim - 1, ax)
                for p, (lead, trail) in zip(pouts, shapes)]
        return pytree.tree_unflatten(outs, spec)

    return tuple(lanes), rebuild


def _route(spec) -> str:
    from .dispatch import plan

    dec = plan(spec)
    if dec.backend in _MISSING and not (dec.backend == "schedule"
                                        and spec.op in _SCHEDULE_OPS):
        raise NotImplementedError(
            f"{spec.describe()} routes to {dec.backend}/{dec.detail} ({dec.reason}): "
            f"{_MISSING[dec.backend]} is not ported")
    return dec.backend


def merge(a, b, *, axis: int = -1, descending: bool = False, stable: bool = False,
          payload=None, nan_policy: str = "last", network: str = "loms",
          device: DeviceLike = None):
    """Merge two lists sorted along ``axis`` (both descending with
    ``descending=True``) into one sorted list.

    ``payload`` is a pair ``(tree_a, tree_b)`` of tensor trees with one
    structure whose leaves ride the merge permutation (trailing feature
    dims allowed). Returns the merged values, or ``(values,
    payload_tree)``. NaNs order last and -0.0 below +0.0 (the total-order
    key); the values are the keys decoded, so a NaN comes out canonical.
    Tensors stay on their device; anything else goes to ``device``."""
    return merge_k([a, b], axis=axis, descending=descending, stable=stable,
                   payload=payload, nan_policy=nan_policy, network=network,
                   device=device)


class _DecodeSorted(torch.autograd.Function):
    """Decode of sorted keys with the gradient of a value sort w.r.t. the
    raw input (the reference's ``_decode_sorted``): backward recovers the
    order by one stable argsort of the raw keys, reversed when
    descending, and scatters the cotangent back."""

    @staticmethod
    def forward(ctx, raw: torch.Tensor, out_keys: torch.Tensor, descending: bool):
        ctx.save_for_backward(raw)
        ctx.descending = descending
        return decode_key_values(out_keys, raw.dtype)

    @staticmethod
    def backward(ctx, ct):
        (raw,) = ctx.saved_tensors
        order = torch.argsort(encode_key_values(raw), dim=-1, stable=True)
        if ctx.descending:
            order = order.flip(-1)
        return torch.zeros_like(ct).scatter(-1, order, ct).to(raw.dtype), None, None


class _DecodeMedian(torch.autograd.Function):
    """Decode of the (B,) median keys with a gradient w.r.t. the (B, L)
    raw input (the reference's ``_decode_median``): backward finds the
    input that held the median by one stable argsort of the keys (the
    middle position) and routes the cotangent there."""

    @staticmethod
    def forward(ctx, raw: torch.Tensor, out_keys: torch.Tensor):
        ctx.save_for_backward(raw)
        return decode_key_values(out_keys, raw.dtype)

    @staticmethod
    def backward(ctx, ct):
        (raw,) = ctx.saved_tensors
        order = torch.argsort(encode_key_values(raw), dim=-1, stable=True)
        j = order[..., raw.shape[-1] // 2]
        lane = torch.arange(raw.shape[-1], device=raw.device)
        g = torch.where(lane == j[..., None], ct[..., None], torch.zeros_like(ct[..., None]))
        return g.to(raw.dtype), None


def _lists_batched(lists, axis: int, device: DeviceLike):
    """The lists as (B, n_i) rows of one dtype: ``(flats, lead, ax, ndim)``."""
    from .payload import canonical_axis, to_batched_last

    lists = [_as_tensor(t, device) for t in lists]
    ndim = lists[0].ndim
    if ndim < 1 or any(t.ndim != ndim for t in lists):
        raise ValueError(f"lists of one rank needed, got {[tuple(t.shape) for t in lists]}")
    ax = canonical_axis(axis, ndim)
    flats, lead = [], None
    for t in lists:
        f, ld = to_batched_last(t, ax)
        if lead is not None and ld != lead:
            raise ValueError("the lists differ off the merge axis: "
                             f"{[tuple(t.shape) for t in lists]}")
        lead = ld
        flats.append(f)
    dt = flats[0].dtype
    for f in flats[1:]:
        dt = torch.promote_types(dt, f.dtype)
    return [f.to(dt) for f in flats], lead, ax, ndim


def _streaming_merge(cfg, flats):
    """The streaming rung: the lists as ascending keys through
    ``chunked_merge`` (row 9) or ``chunked_merge_k`` (row 8's tiles),
    decoded with the gradient of a value sort."""
    from repro_torch.streaming import chunked_merge_k

    keys = [encode_key_values(f) for f in flats] if cfg.key_dtype else list(flats)
    if cfg.descending:  # descending lists merge as their reversals
        keys = [k.flip(-1) for k in keys]
    out = chunked_merge_k(keys)
    if cfg.descending:
        out = out.flip(-1)
    if cfg.key_dtype is None:
        return out
    return _DecodeSorted.apply(torch.cat(flats, dim=-1), out, cfg.descending)


def _schedule_merge_k(spec, flats):
    """The schedule rung of a k-way merge (the reference's executor rung):
    keys, reversed when descending, through ``schedules.merge_k`` with the
    position lane where the spec needs the permutation; ``stable=True``
    then orders ties by position. Returns ``(values, perm | None)``."""
    from . import schedules

    key_dtype = flats[0].dtype if key_transformable(flats[0].dtype) else None
    keys = [encode_key_values(f) for f in flats] if key_dtype else list(flats)
    if spec.descending:
        keys = [k.flip(-1) for k in keys]
    raw = torch.cat(flats, dim=-1)
    if not spec.needs_perm:
        out = schedules.merge_k(keys, kind=spec.network)
        if spec.descending:
            out = out.flip(-1)
        return (out if key_dtype is None
                else _DecodeSorted.apply(raw, out, spec.descending)), None
    pos, off = [], 0
    for k in keys:
        p = torch.arange(k.shape[1], dtype=torch.int32, device=k.device) + off
        pos.append((p.flip(0) if spec.descending else p).expand(k.shape))
        off += k.shape[1]
    out, perm = schedules.merge_k(keys, kind=spec.network, payload=pos)
    if spec.descending:
        out, perm = out.flip(-1), perm.flip(-1)
    if spec.stable:
        out, perm = stabilize_ties(out, perm, descending=spec.descending)
    if key_dtype is not None:  # the values are the raw input's at the positions
        out = take_rows(raw, 1, perm)
    return out, perm


def merge_k(lists, *, axis: int = -1, descending: bool = False, stable: bool = False,
            payload=None, nan_policy: str = "last", network: str = "loms",
            device: DeviceLike = None):
    """k-way merge of lists sorted along ``axis`` (all descending with
    ``descending=True``). ``payload`` is a sequence of tensor trees, one a
    list, of one structure; their leaves ride the merge permutation.
    Returns the merged values, or ``(values, payload_tree)``.
    ``network``: ``"loms"`` (the kernels), or ``"mwms"`` / ``"tree"`` (the
    schedule executor, three lists or more). NaNs order last and
    -0.0 below +0.0; the kernel routes' values are the keys decoded, so a
    NaN comes out canonical. Tensors stay on their device; anything else
    goes to ``device``."""
    from .fused import FusedCfg, fused_cfg_for, fused_merge_k
    from .payload import concat_payload_trees, from_batched_last
    from .spec import SortSpec

    lists = list(lists)
    if len(lists) < 2:
        raise ValueError("merge_k needs at least two lists")
    flats, lead, ax, ndim = _lists_batched(lists, axis, device)
    _check_dtype(flats[0].dtype, nan_policy)
    lens = tuple(f.shape[1] for f in flats)
    batch = flats[0].shape[0]
    spec = SortSpec(op="merge" if len(lists) == 2 else "merge_k", lengths=lens, batch=batch,
                    dtype=str(flats[0].dtype).split(".")[-1], axis=axis,
                    descending=descending, stable=stable,
                    has_payload=payload is not None, network=network,
                    nan_policy=nan_policy)
    route = _route(spec)
    ptree = None if payload is None else concat_payload_trees(list(payload), ax, ndim)
    if route == "schedule":
        from .payload import take_payload_tree

        out2, perm2 = _schedule_merge_k(spec, flats)
        out = from_batched_last(out2, lead, ax, ndim)
        if payload is None:
            return out
        return out, take_payload_tree(ptree, from_batched_last(perm2, lead, ax, ndim),
                                      ax, ndim)
    if route == "streaming":
        key_dtype = flats[0].dtype if key_transformable(flats[0].dtype) else None
        cfg = FusedCfg(op=spec.op, lens=lens, key_dtype=key_dtype, descending=descending)
        return from_batched_last(_streaming_merge(cfg, flats), lead, ax, ndim)
    cfg = fused_cfg_for(spec, batch, flats[0].dtype)
    if payload is None:
        out2, _ = fused_merge_k(cfg, flats)
        return from_batched_last(out2, lead, ax, ndim)
    lanes, rebuild = _fused_leaves(ptree, ax, ndim)
    out2, pouts = fused_merge_k(cfg, flats, lanes)
    return from_batched_last(out2, lead, ax, ndim), rebuild(pouts, sum(lens))


def median_of_lists(lists, *, axis: int = -1, nan_policy: str = "last",
                    network: str = "loms", device: DeviceLike = None):
    """Median of k equal odd-length lists sorted along ``axis`` (the
    paper's early exit after two LOMS stages), shaped like the lists
    without that axis. ``network="mwms"``: the MWMS baseline's device on
    the schedule executor. Floats are medians of their total-order keys,
    decoded. Tensors stay on their device; anything else goes to
    ``device``."""
    from repro_torch.kernels.ops import median_k

    from . import schedules
    from .spec import SortSpec

    flats, lead, _, _ = _lists_batched(lists, axis, device)
    _check_dtype(flats[0].dtype, nan_policy)
    lens = tuple(f.shape[1] for f in flats)
    if network != "mwms" and not (len(lens) % 2 and len(set(lens)) == 1 and lens[0] % 2):
        raise NotImplementedError(
            f"the LOMS median device takes an odd number of equal odd-length lists, got "
            f"{lens}; the reference falls to its lax rung (a sort) here, and the "
            "degradation ladder is not ported (ROADMAP Queue 1, item 8)")
    key_dtype = flats[0].dtype if key_transformable(flats[0].dtype) else None
    keys = [encode_key_values(f) for f in flats] if key_dtype else flats
    spec = SortSpec(op="median", lengths=lens,
                    batch=flats[0].shape[0], dtype=str(keys[0].dtype).split(".")[-1],
                    axis=axis, network=network, nan_policy=nan_policy)
    if _route(spec) == "cuda":
        out = median_k(keys)
    else:
        out = schedules.median_of_lists(keys, kind="mwms" if network == "mwms" else "loms")
    if key_dtype is not None:
        out = _DecodeMedian.apply(torch.cat(flats, dim=-1), out)
    return out.reshape(lead)


def sort(x, *, axis: int = -1, descending: bool = False, stable: bool = False,
         payload=None, nan_policy: str = "last", network: str = "loms",
         device: DeviceLike = None):
    """Sort along ``axis``. ``payload`` is a tensor tree whose leaves
    match ``x`` on its dims (trailing feature dims allowed) and ride the
    sort permutation. Returns the sorted values, or ``(values,
    payload_tree)``. NaNs order last and -0.0 below +0.0; descending is
    the ascending result reversed, so tied values come out in descending
    position. Tensors stay on their device; anything else goes to
    ``device``."""
    from .fused import fused_cfg_for, fused_sort
    from .payload import canonical_axis, from_batched_last, to_batched_last
    from .spec import SortSpec

    x = _as_tensor(x, device)
    _check_dtype(x.dtype, nan_policy)
    ndim = x.ndim
    ax = canonical_axis(axis, ndim)
    x2, lead = to_batched_last(x, ax)
    batch, n = x2.shape
    spec = SortSpec(op="sort", lengths=(n,), batch=batch,
                    dtype=str(x2.dtype).split(".")[-1], axis=axis,
                    descending=descending, stable=stable,
                    has_payload=payload is not None, network=network,
                    nan_policy=nan_policy)
    _route(spec)
    cfg = fused_cfg_for(spec, batch, x2.dtype)
    if payload is None:
        out2, _ = fused_sort(cfg, x2)
        return from_batched_last(out2, lead, ax, ndim)
    lanes, rebuild = _fused_leaves(payload, ax, ndim)
    out2, pouts = fused_sort(cfg, x2, lanes)
    return from_batched_last(out2, lead, ax, ndim), rebuild(pouts, n)
