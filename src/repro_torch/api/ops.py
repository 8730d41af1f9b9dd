"""Public sorting-library entry points of the port (counterpart of
``repro.api.ops``).

One entry point per op, with the reference's semantics on every backend:

* ``axis=``: sort along any axis;
* ``descending=``: inputs and outputs descending (merges take inputs
  sorted that way);
* ``stable=``: equal values keep ascending input position (an earlier
  list first);
* ``payload=``: a tree of tensors riding the permutation (leaves may carry
  trailing feature dims);
* ``backend=``: ``"auto"`` routes through ``plan`` (:mod:`.dispatch`),
  an explicit name forces a registered backend (:mod:`.registry`);
* ``nan_policy=``: ``"last"`` sorts floats as total-order keys (NaNs
  last, -0.0 below +0.0); ``"unsafe"`` sends raw floats through the
  networks (finite, NaN-free inputs only).

A call runs through the degradation ladder
(:mod:`repro_torch.resilience.ladder`), as the reference's does: the
planned backend's rungs first (the cuda backend's fused rung, then its
unfused one), then streaming, schedule and lax. A failed rung of an auto
call feeds its circuit breaker, is counted and the next rung answers
(values bit-equal, tie order the answering rung's) where its error may
degrade: an injected fault, or any error off the card; on the card a
real error propagates (:func:`~repro_torch.resilience.ladder.degradable`).
An explicit ``backend=`` or ``REPRO_RESILIENCE=0`` runs the first rung
that does not decline and lets its error through. ``par=`` (a
:class:`~repro_torch.parallel.Parallelism`) makes ``sort`` / ``merge`` /
``merge_k`` / ``topk`` eligible for the ``sharded`` backend where its TP
axis divides the lists: every rank passes the same tensors and gets the
same result. The segment ops fall
back from the class kernels to the per-segment plain version
(:func:`_segmented_degrade`) under the same rule.

The cuda backend's fused rung is one launch of kernel row 1 (merge), row
2 (sort) or row 8 (k-way merge); its top-k the router kernel (row 3) or
the vocab kernels (rows 4 and 5); its median one launch of row 8. A CPU
tensor takes the same route through the kernels' plain versions. With
the fused rungs off (:func:`~.fused.set_fused_enabled`) every fused
rung skips: a top-k runs the unfused ``cuda`` rung (the keys encoded,
the same kernels, the values decoded), a sort or a merge with a payload
the schedule executor. The
integer types other than int32 (int8, int16, uint8, uint16, uint32) run
as order-preserving int32 keys whose extremes are the type's
(:func:`~.keys.widen_int_keys`) and come back narrowed; a top-k pad
comes back as the type's minimum, as the reference's pad in the raw type.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.common import decode_key_values, encode_key_values
from repro_torch.kernels.topk import topk_tiles
from repro_torch.resilience.failpoints import failpoint
from repro_torch.resilience.ladder import LadderSkip, run_ladder, rungs_for

from .fused import fused_enabled
from .keys import (decode_keys, encode_keys, has_int_widening, has_key_transform,
                   narrow_int_keys, widen_int_keys)
from .payload import stabilize_ties, take_rows

__all__ = ["topk", "topk_block", "merge", "merge_k", "sort", "median_of_lists",
           "segment_sort", "segment_merge", "segment_topk", "segment_argmax"]

_KEY_PAD = torch.iinfo(torch.int32).min


def topk_block(n: int, k: int, *, batch: int = 1, dtype: torch.dtype = torch.float32) -> int:
    """The block the fused rung uses for a top-k over an axis of ``n``
    (the planner's, cache-aware)."""
    from repro_torch.streaming.planner import plan_op

    return topk_tiles(batch, n, block=plan_op("topk", (n,), batch=batch, dtype=dtype,
                                              k=k).block)[0]


def _int_keys(x: torch.Tensor):
    """``(x, narrow)``: an integer type other than int32 as its int32 keys
    (:func:`~.keys.widen_int_keys`) and that type; anything else as it is
    and None."""
    if has_int_widening(x.dtype):
        return widen_int_keys(x), x.dtype
    return x, None


def _unkey(t, narrow):
    """Keys back to the caller's integer type (``narrow``, None: none)."""
    return t if narrow is None else narrow_int_keys(t, narrow)


def _iota_rows(length: int, batch: int, reverse: bool, device, offset: int = 0):
    pos = torch.arange(length, dtype=torch.int32, device=device) + offset
    return (pos.flip(0) if reverse else pos).expand(batch, length)


def _encode_lists(flats, nan_policy: str):
    """The key pre-pass: floats become total-order int32 keys under
    ``"last"``. Returns ``(keys, decode)``; ``decode`` is None where no
    transform ran."""
    if nan_policy == "unsafe" or not has_key_transform(flats[0].dtype):
        return list(flats), None
    dtype = flats[0].dtype
    return [encode_keys(f) for f in flats], (lambda out: decode_keys(out, dtype))


def _restore_values(out2, perm2, raw, decode, descending: bool = False):
    """Sorted keys back to values: gathered from the raw input where the
    permutation is known (bit-exact, differentiable), else the decode
    with the gradient of a value sort. Negative positions (top-k pads)
    keep the decoded pad."""
    if decode is None:
        return out2
    if perm2 is None:
        return _DecodeSorted.apply(raw, out2, descending)
    got = take_rows(raw, -1, torch.where(perm2 < 0, 0, perm2))
    return torch.where(perm2 < 0, decode(out2), got)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _dist_sharded(par, lens) -> bool:
    """Whether the offered Parallelism makes the spec sample-sortable."""
    if par is None:
        return False
    from repro_torch.parallel.sharding import dist_sort_axis

    return dist_sort_axis(par, lens) is not None


def _par_kw(rung: str, par) -> dict:
    """The sharded rung's adapters take ``par``; no other does."""
    return {"par": par} if rung == "sharded" else {}


def topk(x, k: int, *, axis: int = -1, descending: bool = True, stable: bool = False,
         payload=None, backend: str = "auto", block: Optional[int] = None, par=None,
         with_indices: bool = True, nan_policy: str = "last", device: DeviceLike = None):
    """Top-k along ``axis``: the largest ``k`` descending (default), or the
    smallest ``k`` ascending with ``descending=False``.

    Returns ``(values, indices)``: int32 positions along ``axis``, -1 on
    pad slots (a pad ties a genuine dtype minimum, or k exceeds the real
    candidates). With ``payload`` (a tree shaped like ``x``) returns
    ``(values, indices, payload_tree)`` gathered at the winners; without
    ``with_indices``, the values alone. NaNs rank above +inf and -0.0
    below +0.0 (``nan_policy="last"``). Among equal values the kernels'
    order holds (the higher index first on the card's route), the lower
    index first with ``stable=True``. On the card the router kernel
    (axis <= 512) or the vocab kernels run it, integers on their raw
    int32 keys; ``descending=False`` runs the schedule executor.
    ``block`` sets the executor's and the unfused kernels' block. With a
    :class:`~repro_torch.parallel.Parallelism` whose TP axis divides the
    last axis of a 2-D ``x``, ``backend="auto"`` routes to the device-tree
    reduction over that axis (every rank passes the same rows and gets
    the same answer, rank 0's of the reference)."""
    from .dispatch import plan
    from .payload import canonical_axis, from_batched_last, to_batched_last
    from .registry import get_backend
    from .spec import SortSpec

    x, narrow = _int_keys(_as_tensor(x, device))
    _check_dtype(x.dtype, nan_policy)
    ndim = x.ndim
    ax = canonical_axis(axis, ndim)
    x2, lead = to_batched_last(x, ax)
    batch, n = x2.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for an axis of {n}")
    sharded = False
    if par is not None and ax == ndim - 1 and ndim == 2:
        from repro_torch.parallel.sharding import vocab_topk_axis

        sharded = vocab_topk_axis(par, n) is not None
    spec = SortSpec(op="topk", lengths=(n,), batch=batch, dtype=_dtype_name(x2.dtype), k=k,
                    axis=axis, descending=descending, stable=stable,
                    has_payload=payload is not None, backend=backend,
                    sharded=sharded, nan_policy=nan_policy)

    def finish(vals2, idx2, decode):
        if stable:
            vals2, idx2 = stabilize_ties(vals2, idx2, descending=descending)
        if decode is None:  # the route's own values: the fused top-k's gradient
            from .fused import topk_vjp

            vals2 = topk_vjp(x2, vals2, idx2)
        vals = _unkey(from_batched_last(_restore_values(vals2, idx2, x2, decode),
                                        lead, ax, ndim), narrow)
        idx = from_batched_last(idx2, lead, ax, ndim)
        if payload is not None:
            from .payload import take_payload_tree

            # a pad's -1 wraps to the last position, as the reference's gather
            return vals, idx, take_payload_tree(payload, torch.where(idx < 0, idx + n, idx),
                                                ax, ndim)
        return (vals, idx) if with_indices else vals

    if not descending:  # the smallest k: the ascending sort's prefix
        if backend not in ("auto", "schedule", "lax"):
            raise ValueError("descending=False takes backend auto, schedule or lax")
        be = get_backend("schedule" if backend == "auto" else backend)
        (enc,), decode = _encode_lists([x2], nan_policy)
        out2, perm2 = be.run["sort"](enc, spec=spec,
                                     pos=_iota_rows(n, batch, False, x2.device))
        return finish(out2[:, :k], perm2[:, :k], decode)

    dec = plan(spec, par)

    def attempt(rung: str):
        if rung in ("fused", "cuda"):
            if rung == "fused" and (stable or not fused_enabled()):
                raise LadderSkip
            from repro_torch.kernels.ops import topk as kernel_topk, topk_rows

            unsafe = nan_policy == "unsafe"  # -0.0 and +0.0 tie, as raw floats
            if rung == "fused":
                failpoint("fused.launch.topk")
                vals2, idx2 = topk_rows(x2, k, zero_ties=unsafe,
                                        block=topk_block(n, k, batch=batch, dtype=x2.dtype))
            else:
                vals2, idx2 = kernel_topk(x2, k, block=block, zero_ties=unsafe)
            if rung == "fused" or unsafe or not x2.dtype.is_floating_point:
                return finish(vals2, idx2, None)  # the kernels' values
            keys = torch.where(idx2 < 0, _KEY_PAD, encode_key_values(vals2))
            return finish(keys, idx2, lambda out: decode_key_values(out, x2.dtype))
        (enc,), decode = _encode_lists([x2], nan_policy)
        vals2, idx2 = get_backend(rung).run["topk"](enc, k, spec=spec, block=block,
                                                    **_par_kw(rung, par))
        return finish(vals2, idx2.to(torch.int32), decode)

    return run_ladder(spec, rungs_for(spec, dec), attempt, device=x2.device)


def _as_tensor(x, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device`` (the
    card unless the caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x)).to(resolve_device(device))


def _segmented(op: str, offsets, values: torch.Tensor, *, k=None, descending: bool,
               has_payload: bool, backend: str, nan_policy: str):
    """Plan one segment op: its registered backend's adapter, the spec and
    whether the class kernels run (``use_kernel``; the ``reference`` route,
    where the segmented switch puts auto calls, is the per-segment plain
    version). The spec is planned for the card, so a CPU tensor takes the
    class kernels' plain versions, as the CPU tests hold them."""
    from repro_torch.segmented.bucketing import normalize_offsets

    from .dispatch import plan
    from .registry import get_backend
    from .spec import SortSpec

    offs = tuple(normalize_offsets(o) for o in offsets)
    spec = SortSpec(op=op if op != "argmax" else "topk",
                    lengths=tuple(o[-1] for o in offs), batch=max(len(offs[0]) - 1, 1),
                    dtype=_dtype_name(values.dtype), k=k, descending=descending,
                    has_payload=has_payload, backend=backend, nan_policy=nan_policy,
                    segment_offsets=offs)
    dec = plan(spec)
    return get_backend(dec.backend).run[op], spec, dec.detail != "reference"


def _segmented_degrade(spec, call, device=None, use_kernel: bool = True):
    """The segmented backend's fall-back from the class kernels to the
    per-segment plain version (``segmented/reference.py``), as the
    reference's: with resilience on and an auto ask, a failed kernel path
    whose error may degrade (an injected spill or launch fault; any error
    off the card, ``device`` being the values') feeds a breaker on the
    synthetic ``segmented_kernel`` rung, is counted, and ``call(False)``
    answers; an open breaker skips the kernel path until its cooldown
    probe. ``call(use_kernel)`` runs the op; a plan without the class
    kernels (``use_kernel`` False) runs the plain version alone."""
    from repro_torch.resilience.breaker import breaker_for
    from repro_torch.resilience.ladder import (degradable, record_fallback, resilience_enabled,
                                               spec_class)

    from .spec import BACKEND_AUTO

    if not use_kernel:
        return call(False)
    if not (resilience_enabled() and spec.backend == BACKEND_AUTO):
        return call(True)
    cls = spec_class(spec)
    br = breaker_for(spec.op, "segmented_kernel", cls, create=False)
    if br is not None and not br.allow():
        return call(False)
    try:
        result = call(True)
    except Exception as e:  # noqa: BLE001 — degradable() decides
        if not degradable(e, device):
            raise
        record_fallback(spec.op, "segmented_kernel", cls, e, br)
        return call(False)
    if br is not None:
        br.record_success()
    return result


def segment_sort(values, segment_offsets, *, descending: bool = False,
                 payload=None, backend: str = "auto", nan_policy: str = "last",
                 device: DeviceLike = None):
    """Sort each CSR segment of the flat ``values`` on its own.

    ``segment_offsets`` are host ints ``[0, ..., N]``. ``payload`` is a
    tensor or a tree of tensors whose leaves lead with the N axis; they
    ride each segment's permutation. Returns the sorted values, or
    ``(values, payload_tree)``."""
    values, narrow = _int_keys(_as_tensor(values, device))
    run, spec, use_kernel = _segmented("sort", (segment_offsets,), values,
                                       descending=descending,
                                       has_payload=payload is not None, backend=backend,
                                       nan_policy=nan_policy)
    out, _, ptree = _segmented_degrade(spec, lambda uk: run(
        values, spec=spec, descending=descending, payload=payload, nan_policy=nan_policy,
        use_kernel=uk), values.device, use_kernel)
    out = _unkey(out, narrow)
    return out if payload is None else (out, ptree)


def segment_merge(a, b, offsets_a, offsets_b, *, descending: bool = False,
                  payload=None, backend: str = "auto", nan_policy: str = "last",
                  device: DeviceLike = None):
    """Merge per-segment sorted runs: output segment ``s`` is the sorted
    union of ``a``'s and ``b``'s segment ``s``. ``payload`` is a pair
    ``(tree_a, tree_b)``. Returns ``(values, out_offsets)`` or
    ``(values, payload_tree, out_offsets)``."""
    (a, narrow), (b, _) = _int_keys(_as_tensor(a, device)), _int_keys(_as_tensor(b, device))
    run, spec, use_kernel = _segmented("merge", (offsets_a, offsets_b), a,
                                       descending=descending,
                                       has_payload=payload is not None, backend=backend,
                                       nan_policy=nan_policy)
    out, _, ptree, out_offs = _segmented_degrade(spec, lambda uk: run(
        a, b, spec=spec, descending=descending, payload=payload, nan_policy=nan_policy,
        use_kernel=uk), a.device, use_kernel)
    out = _unkey(out, narrow)
    return (out, out_offs) if payload is None else (out, ptree, out_offs)


def segment_topk(values, segment_offsets, k, *, descending: bool = True,
                 payload=None, backend: str = "auto", nan_policy: str = "last",
                 device: DeviceLike = None):
    """Per-segment top-k: the ``min(k_s, len_s)`` largest entries of each
    segment, descending (``descending=False``: the smallest, ascending).
    ``k`` is one int or one per segment. Returns ``(values, idx,
    out_offsets)`` (a ``payload_tree`` before the offsets with a payload):
    CSR layout, ``idx`` int32 positions within the segment."""
    values, narrow = _int_keys(_as_tensor(values, device))
    ks = list(k) if isinstance(k, (list, tuple)) else [int(k)]
    run, spec, use_kernel = _segmented("topk", (segment_offsets,), values,
                                       k=max(ks) if ks else 1, descending=descending,
                                       has_payload=payload is not None, backend=backend,
                                       nan_policy=nan_policy)
    out, idx, ptree, out_offs = _segmented_degrade(spec, lambda uk: run(
        values, k, spec=spec, descending=descending, payload=payload, nan_policy=nan_policy,
        use_kernel=uk), values.device, use_kernel)
    out = _unkey(out, narrow)
    return (out, idx, out_offs) if payload is None else (out, idx, ptree, out_offs)


def segment_argmax(values, segment_offsets, *, backend: str = "auto",
                   nan_policy: str = "last", device: DeviceLike = None):
    """Per-segment argmax ``(vals (S,), idx (S,))``; empty segments give
    the dtype minimum and index -1."""
    values, narrow = _int_keys(_as_tensor(values, device))
    run, spec, use_kernel = _segmented("argmax", (segment_offsets,), values, k=1,
                                       descending=True, has_payload=False, backend=backend,
                                       nan_policy=nan_policy)
    vals, idx = _segmented_degrade(spec, lambda uk: run(values, spec=spec,
                                                        nan_policy=nan_policy,
                                                        use_kernel=uk),
                                   values.device, use_kernel)
    return _unkey(vals, narrow), idx


# ---------------------------------------------------------------------------
# merge / merge_k / median / sort
# ---------------------------------------------------------------------------

#: the dtypes the routes take (floats as total-order keys or raw, int32
#: raw; the other integer types arrive here as int32 keys)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def _check_dtype(dtype: torch.dtype, nan_policy: str) -> None:
    if nan_policy not in ("last", "unsafe"):
        raise ValueError(f"nan_policy must be 'last' or 'unsafe', got {nan_policy!r}")
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"{dtype}: the port takes float32, bfloat16, float16 and the integer types "
            "of 8 to 32 bits (the reference holds no 64-bit value without jax_enable_x64)")


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


def merge(a, b, *, axis: int = -1, descending: bool = False, stable: bool = False,
          payload=None, backend: str = "auto", network: str = "loms", par=None,
          nan_policy: str = "last", device: DeviceLike = None):
    """Merge two lists sorted along ``axis`` (both descending with
    ``descending=True``) into one sorted list.

    ``payload`` is a pair ``(tree_a, tree_b)`` of tensor trees with one
    structure whose leaves ride the merge permutation (trailing feature
    dims allowed). Returns the merged values, or ``(values,
    payload_tree)``. NaNs order last and -0.0 below +0.0 (the total-order
    key); values-only routes decode the keys, so a NaN comes out
    canonical. Tensors stay on their device; anything else goes to
    ``device``. ``par``: as :func:`merge_k`."""
    return merge_k([a, b], axis=axis, descending=descending, stable=stable,
                   payload=payload, backend=backend, network=network, par=par,
                   nan_policy=nan_policy, device=device)


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


def _check_nonempty(what: str, t: torch.Tensor, ax: int) -> None:
    """Refuse an empty list, as the reference does (it divides by zero)."""
    if t.shape[ax] == 0:
        raise ValueError(f"{what} of shape {tuple(t.shape)} is empty along axis {ax}: "
                         "the ops need an element in every list")


def _lists_batched(lists, axis: int, device: DeviceLike):
    """The lists as (B, n_i) rows of one dtype: ``(flats, lead, ax, ndim)``."""
    from .payload import canonical_axis, to_batched_last

    lists = [_as_tensor(t, device) for t in lists]
    ndim = lists[0].ndim
    if ndim < 1 or any(t.ndim != ndim for t in lists):
        raise ValueError(f"lists of one rank needed, got {[tuple(t.shape) for t in lists]}")
    ax = canonical_axis(axis, ndim)
    for j, t in enumerate(lists):
        _check_nonempty(f"list {j}", t, ax)
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


def merge_k(lists, *, axis: int = -1, descending: bool = False, stable: bool = False,
            payload=None, backend: str = "auto", network: str = "loms", par=None,
            nan_policy: str = "last", device: DeviceLike = None):
    """k-way merge of lists sorted along ``axis`` (all descending with
    ``descending=True``). ``payload`` is a sequence of tensor trees, one a
    list, of one structure; their leaves ride the merge permutation.
    Returns the merged values, or ``(values, payload_tree)``.
    ``network``: ``"loms"`` (the kernels), or another family of the
    schedule executor (``"mwms"`` / ``"tree"`` for three lists or more,
    ``"s2ms"`` / ``"batcher-oe"`` / ``"batcher-bitonic"`` for two). Two
    lists run the 2-way device (``merge_schedule``), as the reference's.
    Tensors stay on their device; anything else goes to ``device``. With
    a :class:`~repro_torch.parallel.Parallelism` whose TP axis divides
    every list, merges of at least ``DIST_MIN_TOTAL`` route to the
    distributed sample-sort (:mod:`repro_torch.parallel.dist_sort`)."""
    from .dispatch import plan
    from .fused import fused_cfg_for, fused_merge_k
    from .payload import concat_payload_trees, from_batched_last, take_payload_tree
    from .registry import get_backend
    from .spec import SortSpec

    lists = list(lists)
    if len(lists) < 2:
        raise ValueError("merge_k needs at least two lists")
    flats, lead, ax, ndim = _lists_batched(lists, axis, device)
    narrow = _int_keys(flats[0])[1]
    flats = [_int_keys(f)[0] for f in flats]
    _check_dtype(flats[0].dtype, nan_policy)
    lens = tuple(f.shape[1] for f in flats)
    batch = flats[0].shape[0]
    spec = SortSpec(op="merge" if len(lists) == 2 else "merge_k", lengths=lens, batch=batch,
                    dtype=_dtype_name(flats[0].dtype), axis=axis, descending=descending,
                    stable=stable, has_payload=payload is not None, network=network,
                    backend=backend, sharded=_dist_sharded(par, lens),
                    nan_policy=nan_policy)
    dec = plan(spec, par)

    def attempt(rung: str):
        if rung == "fused":
            cfg = fused_cfg_for(spec, batch, flats[0].dtype)
            if cfg is None:
                raise LadderSkip
            if payload is None:
                out2, _ = fused_merge_k(cfg, flats)
                return _unkey(from_batched_last(out2, lead, ax, ndim), narrow)
            lanes, rebuild = _fused_leaves(
                concat_payload_trees(list(payload), ax, ndim), ax, ndim)
            out2, pouts = fused_merge_k(cfg, flats, lanes)
            return (_unkey(from_batched_last(out2, lead, ax, ndim), narrow),
                    rebuild(pouts, sum(lens)))
        be = get_backend(rung)
        enc, decode = _encode_lists(flats, nan_policy)
        if descending:  # descending lists merge as their reversals
            enc = [f.flip(-1) for f in enc]
        pos = None
        if spec.needs_perm:
            offs = np.cumsum((0,) + lens)
            pos = [_iota_rows(ln, batch, descending, f.device, int(off))
                   for ln, off, f in zip(lens, offs, flats)]
        kw = _par_kw(rung, par)
        if spec.op == "merge":
            out2, perm2 = be.run["merge"](enc[0], enc[1], spec=spec,
                                          pos=None if pos is None else (pos[0], pos[1]), **kw)
        else:
            out2, perm2 = be.run["merge_k"](enc, spec=spec, pos=pos, **kw)
        if descending:
            out2 = out2.flip(-1)
            perm2 = None if perm2 is None else perm2.flip(-1)
        if stable:
            out2, perm2 = stabilize_ties(out2, perm2, descending=descending)
        raw = None if decode is None else torch.cat(flats, dim=-1)
        out = _unkey(from_batched_last(_restore_values(out2, perm2, raw, decode, descending),
                                       lead, ax, ndim), narrow)
        if payload is None:
            return out
        ptree = concat_payload_trees(list(payload), ax, ndim)
        return out, take_payload_tree(ptree, from_batched_last(perm2, lead, ax, ndim),
                                      ax, ndim)

    return run_ladder(spec, rungs_for(spec, dec), attempt, device=flats[0].device)


def median_of_lists(lists, *, axis: int = -1, backend: str = "auto",
                    network: str = "loms", par=None, nan_policy: str = "last",
                    device: DeviceLike = None):
    """Median of lists sorted along ``axis``, shaped like the lists
    without that axis: the paper's early exit after two LOMS stages for
    an odd count of equal odd-length lists (``network="mwms"``: the MWMS
    baseline's device), else the middle element ``n // 2`` of a sort (the
    ``lax`` rung). Floats are medians of their total-order keys, decoded.
    Tensors stay on their device; anything else goes to ``device``.
    ``par`` is handed to ``plan``, as the reference does: no median route
    is sharded."""
    from .dispatch import plan
    from .registry import get_backend, median_device_fits
    from .spec import SortSpec

    flats, lead, _, _ = _lists_batched(lists, axis, device)
    narrow = _int_keys(flats[0])[1]
    flats = [_int_keys(f)[0] for f in flats]
    _check_dtype(flats[0].dtype, nan_policy)
    lens = tuple(f.shape[1] for f in flats)
    keys, decode = _encode_lists(flats, nan_policy)
    spec = SortSpec(op="median", lengths=lens, batch=flats[0].shape[0],
                    dtype=_dtype_name(keys[0].dtype), axis=axis, network=network,
                    backend=backend, nan_policy=nan_policy)
    dec = plan(spec, par)

    def attempt(rung: str):
        if rung == "fused":
            raise LadderSkip  # no fused median kernel
        if rung in ("cuda", "schedule") and network != "mwms" and not median_device_fits(spec):
            raise LadderSkip  # no LOMS median device for these lists
        out = get_backend(rung).run["median"](keys, spec=spec)
        if decode is not None:
            out = _DecodeMedian.apply(torch.cat(flats, dim=-1), out)
        return _unkey(out.reshape(lead), narrow)

    return run_ladder(spec, rungs_for(spec, dec), attempt, device=flats[0].device)


def sort(x, *, axis: int = -1, descending: bool = False, stable: bool = False,
         payload=None, backend: str = "auto", network: str = "loms", par=None,
         nan_policy: str = "last", device: DeviceLike = None):
    """Sort along ``axis``. ``payload`` is a tensor tree whose leaves
    match ``x`` on its dims (trailing feature dims allowed) and ride the
    sort permutation. Returns the sorted values, or ``(values,
    payload_tree)``. NaNs order last and -0.0 below +0.0; descending is
    the ascending result reversed, so tied values come out in descending
    position (ascending with ``stable=True``). ``network``: ``"loms"``,
    or the executor's ``"bitonic"`` / ``"oems"`` / ``"rank"``. Tensors
    stay on their device; anything else goes to ``device``. With a
    :class:`~repro_torch.parallel.Parallelism` whose TP axis divides the
    length, sorts of at least ``DIST_MIN_TOTAL`` route to the distributed
    sample-sort (every rank passes the same rows and gets the full
    result)."""
    from .dispatch import plan
    from .fused import fused_cfg_for, fused_sort
    from .payload import canonical_axis, from_batched_last, take_payload_tree, to_batched_last
    from .registry import get_backend
    from .spec import SortSpec

    x, narrow = _int_keys(_as_tensor(x, device))
    _check_dtype(x.dtype, nan_policy)
    ndim = x.ndim
    ax = canonical_axis(axis, ndim)
    _check_nonempty("x", x, ax)
    x2, lead = to_batched_last(x, ax)
    batch, n = x2.shape
    spec = SortSpec(op="sort", lengths=(n,), batch=batch, dtype=_dtype_name(x2.dtype),
                    axis=axis, descending=descending, stable=stable,
                    has_payload=payload is not None, network=network, backend=backend,
                    sharded=_dist_sharded(par, (n,)), nan_policy=nan_policy)
    dec = plan(spec, par)

    def attempt(rung: str):
        if rung == "fused":
            cfg = fused_cfg_for(spec, batch, x2.dtype)
            if cfg is None:
                raise LadderSkip
            if payload is None:
                out2, _ = fused_sort(cfg, x2)
                return _unkey(from_batched_last(out2, lead, ax, ndim), narrow)
            lanes, rebuild = _fused_leaves(payload, ax, ndim)
            out2, pouts = fused_sort(cfg, x2, lanes)
            return _unkey(from_batched_last(out2, lead, ax, ndim), narrow), rebuild(pouts, n)
        (enc,), decode = _encode_lists([x2], nan_policy)
        pos = _iota_rows(n, batch, False, x2.device) if spec.needs_perm else None
        out2, perm2 = get_backend(rung).run["sort"](enc, spec=spec, pos=pos,
                                                    **_par_kw(rung, par))
        if descending:  # the ascending sort, read out reversed
            out2 = out2.flip(-1)
            perm2 = None if perm2 is None else perm2.flip(-1)
        if stable:
            out2, perm2 = stabilize_ties(out2, perm2, descending=descending)
        out = _unkey(from_batched_last(_restore_values(out2, perm2, x2, decode, descending),
                                       lead, ax, ndim), narrow)
        if payload is None:
            return out
        return out, take_payload_tree(payload, from_batched_last(perm2, lead, ax, ndim),
                                      ax, ndim)

    return run_ladder(spec, rungs_for(spec, dec), attempt, device=x2.device)
