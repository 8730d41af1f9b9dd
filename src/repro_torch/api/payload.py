"""Axis handling, payload trees and tie stabilisation for the library's
entry points (counterpart of ``repro.api.payload``).

Every kernel works on canonical 2-D problems, ``(batch, length)`` with the
sort axis last; these helpers move an arbitrary ``axis`` there and back
and concatenate the per-list payload trees of a merge. Payload leaves may
carry trailing feature dims beyond the values' shape.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.common import scatter_along, take_along


def canonical_axis(axis: int, ndim: int) -> int:
    ax = axis + ndim if axis < 0 else axis
    if not 0 <= ax < ndim:
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return ax


def to_batched_last(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Move ``axis`` last and flatten the rest: ``((B, L), lead shape)``."""
    xm = torch.movedim(x, canonical_axis(axis, x.ndim), -1)
    lead = tuple(xm.shape[:-1])
    return xm.reshape(-1, xm.shape[-1]).contiguous(), lead


def from_batched_last(x2: torch.Tensor, lead: Tuple[int, ...], axis: int,
                      ndim: int) -> torch.Tensor:
    """Inverse of :func:`to_batched_last` (the length along the axis may
    differ, as after a merge)."""
    xm = x2.reshape(lead + (x2.shape[-1],))
    return torch.movedim(xm, -1, canonical_axis(axis, ndim))


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, dim: int, idx: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.dim = dim
        ctx.shape = t.shape  # a top-k's gather shrinks the axis: the cotangent has t's shape
        return take_along(t, dim, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return ct.new_zeros(ctx.shape).scatter_add(ctx.dim, idx, ct), None, None


def take_rows(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather`` that keeps every bit of the values (see
    ``take_along``) and is differentiable in ``t``; ``idx`` holds unique
    positions along ``dim`` in each row (a permutation, or a top-k's
    winners), possibly fewer than ``t`` has."""
    return _Take.apply(t, dim, idx.long())


def take_payload_tree(tree, perm: torch.Tensor, axis: int, ndim: int):
    """Gather every leaf of ``tree`` at ``perm`` along ``axis``; ``perm``
    is shaped like the output values and holds positions along the axis of
    the input leaves, which may carry trailing feature dims."""
    ax = canonical_axis(axis, ndim)
    idx = torch.movedim(perm, ax, ndim - 1)

    def take(leaf):
        lm = torch.movedim(leaf, ax, ndim - 1)
        i = idx
        if lm.ndim > ndim:
            i = i.reshape(i.shape + (1,) * (lm.ndim - ndim)).expand(i.shape + lm.shape[ndim:])
        return torch.movedim(take_rows(lm, ndim - 1, i), ndim - 1, ax)

    return pytree.tree_map(take, tree)


def concat_payload_trees(trees, axis: int, ndim: int):
    """Concatenate the per-list payload trees of a merge along the sort
    axis; the trees must have one structure."""
    ax = canonical_axis(axis, ndim)
    flat = [pytree.tree_flatten(t) for t in trees]
    spec = flat[0][1]
    if any(s != spec for _, s in flat):
        raise ValueError("the payload trees of a merge need one structure")
    leaves = [torch.cat(group, dim=ax) for group in zip(*(f for f, _ in flat))]
    return pytree.tree_unflatten(leaves, spec)

#: largest last axis stabilised with the oblivious comparison cloud; past
#: it the pass sorts positions by equal-value run id instead (same output)
STABILIZE_CLOUD_MAX = 1024

_POS_PAD = torch.iinfo(torch.int32).max


def stabilize_ties(vals: torch.Tensor, perm: torch.Tensor,
                   descending: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder runs of equal values by ascending original position.
    ``vals`` is already sorted; only positions inside a tie move.
    Negative positions (pad slots) order after every real one."""
    pos = torch.where(perm < 0, _POS_PAD, perm)
    if vals.shape[-1] > STABILIZE_CLOUD_MAX:
        changed = vals[..., 1:] != vals[..., :-1]
        run = torch.cumsum(torch.cat([torch.zeros_like(changed[..., :1]), changed],
                                     dim=-1).to(torch.int32), dim=-1)
        # lexsort by (run, position): stable sorts, minor key first
        order = torch.argsort(pos, dim=-1, stable=True)
        order = torch.gather(order, -1, torch.argsort(
            torch.gather(run, -1, order), dim=-1, stable=True))
        return take_along(vals, -1, order), torch.gather(perm, -1, order)
    from repro_torch.core.networks import _rows, _slabs

    v_j, p_j = vals[..., None, :], pos[..., None, :]
    parts = []
    for i0, i1 in _slabs(_rows(vals), vals.shape[-1], vals.shape[-1]):  # the cloud in slabs
        v_i, p_i = vals[..., i0:i1, None], pos[..., i0:i1, None]
        ahead = (v_j > v_i) if descending else (v_j < v_i)
        tie = v_j == v_i
        tie &= p_j < p_i
        ahead |= tie
        parts.append(ahead.sum(dim=-1, dtype=torch.int32))
    rank = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return scatter_along(vals, -1, rank), scatter_along(perm, -1, rank)
