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
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.common import decode_key_values, encode_key_values, take_along
from repro_torch.kernels.topk import (
    ROUTER_TOPK_MAX,
    plan_block,
    router_topk,
    topk_tiles,
    vocab_topk,
)

from .payload import stabilize_ties

__all__ = ["topk", "topk_block", "segment_sort", "segment_merge",
           "segment_topk", "segment_argmax"]

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
