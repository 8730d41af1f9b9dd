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
* ``merge`` and ``sort`` along any axis, routed by ``plan`` as the
  reference routes them on its accelerator: one rung, the planned one,
  and no degradation ladder (a failure raises). A fused rung is one
  launch of kernel row 1 (merge) or row 2 (sort); a merge past the
  routing budget streams through row 9. Routes the port lacks raise
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

from .payload import stabilize_ties

__all__ = ["topk", "topk_block", "merge", "sort", "segment_sort",
           "segment_merge", "segment_topk", "segment_argmax"]

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
    "schedule": "the schedule executor (ROADMAP Queue 1, items 3 and 4)",
}


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
    if dec.backend in _MISSING:
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
    from .fused import FusedCfg, fused_cfg_for, fused_merge_k
    from .payload import (canonical_axis, concat_payload_trees, from_batched_last,
                          to_batched_last)
    from .spec import SortSpec

    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.ndim != b.ndim or a.ndim < 1:
        raise ValueError(f"merge takes two lists of one rank, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    _check_dtype(a.dtype, nan_policy)
    ndim = a.ndim
    ax = canonical_axis(axis, ndim)
    (a2, lead), (b2, lead_b) = to_batched_last(a, ax), to_batched_last(b, ax)
    if lead != lead_b:
        raise ValueError(f"the lists differ off the merge axis: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    lens = (a2.shape[1], b2.shape[1])
    batch = a2.shape[0]
    spec = SortSpec(op="merge", lengths=lens, batch=batch,
                    dtype=str(a2.dtype).split(".")[-1], axis=axis,
                    descending=descending, stable=stable,
                    has_payload=payload is not None, network=network,
                    nan_policy=nan_policy)
    route = _route(spec)
    if route == "streaming":
        key_dtype = a2.dtype if key_transformable(a2.dtype) else None
        cfg = FusedCfg(op="merge", lens=lens, key_dtype=key_dtype, descending=descending)
        out2, _ = _streaming_merge(cfg, a2, b2)
        return from_batched_last(out2, lead, ax, ndim)
    cfg = fused_cfg_for(spec, batch, a2.dtype)
    if payload is None:
        out2, _ = fused_merge_k(cfg, (a2, b2))
        return from_batched_last(out2, lead, ax, ndim)
    lanes, rebuild = _fused_leaves(concat_payload_trees(list(payload), ax, ndim), ax, ndim)
    out2, pouts = fused_merge_k(cfg, (a2, b2), lanes)
    return from_batched_last(out2, lead, ax, ndim), rebuild(pouts, sum(lens))


def _streaming_merge(cfg, a2: torch.Tensor, b2: torch.Tensor):
    """The streaming rung: the lists as ascending keys through
    ``chunked_merge`` (kernel row 9), decoded; differentiable like the
    fused rung (backward: one stable argsort of the keys)."""
    from repro_torch.streaming import chunked_merge

    from .fused import merge2_with_grad

    def run(a, b, leaves, want_perm):
        ka, kb = (encode_key_values(a), encode_key_values(b)) if cfg.key_dtype else (a, b)
        if cfg.descending:  # descending lists merge as their reversals
            ka, kb = ka.flip(-1), kb.flip(-1)
        out = chunked_merge(ka, kb)
        if cfg.descending:
            out = out.flip(-1)
        if cfg.key_dtype is not None:
            out = decode_key_values(out, cfg.key_dtype)
        return out, None, ()

    return merge2_with_grad(cfg, run, a2, b2)


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
