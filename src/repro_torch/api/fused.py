"""The fused single-launch rungs of ``merge``, ``merge_k`` and ``sort``
(counterpart of ``repro.api.fused``).

On the reference's accelerator a ``repro.sort`` that fits its budget is
one launch of the fused sort kernel (row 2), a ``repro.merge`` of two
lists that fits is one launch of the 2-way merge kernel (row 1), and a
``repro.merge_k`` of three or more lists whose comparison cloud fits is
one launch of the k-way kernel (row 8) on ``kway_schedule(lens)``: the
total-order key encode on load, the descending reversal, the payload
lanes and the decode on store all happen inside it. :func:`fused_sort`
and :func:`fused_merge_k` are those rungs, each differentiable: a
``torch.autograd.Function`` whose backward scatters the cotangents through
the permutation. With payload lanes the permutation is the kernel's own
(the payload gather is a concrete linear map, and a column device's tie
order need not be a stable argsort's); values-only, backward recomputes
it with one stable argsort of the keys, the subgradient convention of a
sort. The TPU had no backward kernel, so backward is plain torch.
:func:`topk_vjp` is the fused top-k's backward (``fused.py:354``).

``set_fused_enabled(False)`` (or ``REPRO_DISABLE_FUSED=1``, the
reference's switch) is the escape hatch and the unfused baseline: the
planner stops offering the fused rows (a sort and a merge with a payload
go to the schedule executor), :func:`fused_cfg_for` declines, so the
fused rungs of ``sort``, ``merge``, ``merge_k`` and ``topk`` skip. An
explicit ``backend="cuda"`` still runs the kernels for a values-only
spec, unfused: the key encode, the reversal and the decode around the
kernel as torch passes (top-k: rows 4 and 5, or 3, on the encoded keys).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import (encode_key_values, gather_lanes, key_transformable,
                                        take_along)
from repro_torch.resilience.failpoints import failpoint

from .spec import SortSpec

_ENABLED = True


def fused_enabled() -> bool:
    """Whether the fused rungs may run (the switch and
    ``REPRO_DISABLE_FUSED``)."""
    return _ENABLED and os.environ.get("REPRO_DISABLE_FUSED") != "1"


def set_fused_enabled(enabled: bool) -> bool:
    """Turn the fused rungs on or off; returns the previous setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a ``SortSpec.dtype`` name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def fused_eligible(spec: SortSpec) -> bool:
    """Whether the kernels run a sort or a merge as one fused launch: the
    loms network, not ``stable``, and within the reference's routing
    budget (a 2-way merge also needs a common column count)."""
    from repro_torch.streaming.planner import fits_vmem, kway_fits_vmem, sort_fits_vmem

    if spec.network != "loms" or spec.stable:
        return False
    if spec.op == "sort":
        return sort_fits_vmem(spec.total, dtype=dtype_of(spec.dtype))
    if spec.op == "merge":
        return not spec.ragged2 and fits_vmem(spec.lengths[0], spec.lengths[1],
                                              dtype=dtype_of(spec.dtype))
    if spec.op == "merge_k":
        return kway_fits_vmem(spec.total)
    return False


@dataclasses.dataclass(frozen=True)
class FusedCfg:
    """The static knobs of one fused call (the reference's ``FusedCfg``
    without ``block_batch``, ``block`` and ``k``, which no fused merge or
    sort of the port reads)."""

    op: str
    lens: Tuple[int, ...]
    key_dtype: Optional[torch.dtype]  # the float dtype encoded, None: raw keys
    descending: bool = False
    n_cols: int = 2
    network: str = "loms"
    #: raw float rows (``nan_policy="unsafe"``): the kernels' raw-float
    #: mode, the reference's one-hot permute
    use_mxu: bool = False


def fused_cfg_for(spec: SortSpec, batch: int, dtype: torch.dtype) -> Optional[FusedCfg]:
    """The config of one eligible sort or merge (None if ineligible or
    the fused rungs are off)."""
    from repro_torch.streaming.planner import plan_op

    kernel_op = {"sort": "sort", "merge": "merge2", "merge_k": "kway"}.get(spec.op)
    if kernel_op is None or not fused_enabled() or not fused_eligible(spec):
        return None
    key_dtype = (dtype if spec.nan_policy == "last" and key_transformable(dtype)
                 else None)
    plan = plan_op(kernel_op, spec.lengths, batch=batch, dtype=dtype)
    loms = plan.kind == "loms"
    return FusedCfg(op=spec.op, lens=tuple(spec.lengths), key_dtype=key_dtype,
                    descending=spec.descending, n_cols=plan.n_cols if loms else 2,
                    network=plan.network if loms else "loms",
                    use_mxu=key_dtype is None and dtype.is_floating_point)


def _lanes_apart(run, leaves, want_perm: bool):
    """``run`` with payload lanes. The raw-float mode carries positions but
    no lanes, so there the lanes are gathered at its permutation (exact:
    ``unsafe`` rows are finite, their ranks a permutation)."""
    if not leaves:
        return run((), want_perm)
    out, perm, _ = run((), True)
    return out, perm, tuple(gather_lanes(perm, leaf) for leaf in leaves)


# ---------------------------------------------------------------------------
# backward helpers
# ---------------------------------------------------------------------------


def _keys_of(cfg: FusedCfg, x: torch.Tensor) -> torch.Tensor:
    return encode_key_values(x) if cfg.key_dtype is not None else x


def _scatter_rows(ct: Optional[torch.Tensor], order: torch.Tensor,
                  like: torch.Tensor) -> Optional[torch.Tensor]:
    """Cotangent of ``out = like[:, order]``: ``ct`` scattered back along
    axis 1 (trailing feature dims ride along); None for a leaf that takes
    no gradient."""
    if ct is None or not like.dtype.is_floating_point:
        return None
    idx = order.long()
    if ct.ndim > idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (ct.ndim - idx.ndim)).expand(ct.shape)
    return torch.zeros(like.shape, dtype=ct.dtype, device=ct.device).scatter(
        1, idx, ct).to(like.dtype)


def sort_order(cfg: FusedCfg, x: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(_keys_of(cfg, x), dim=-1, stable=True)
    return order.flip(-1) if cfg.descending else order


def merge_order(cfg: FusedCfg, lists: Sequence[torch.Tensor]) -> torch.Tensor:
    """The merge permutation (positions in the concatenation) by one
    stable argsort of the keys; descending lists merge as their
    reversals, positions in the original orientation."""
    ks = [_keys_of(cfg, x) for x in lists]
    if not cfg.descending:
        return torch.argsort(torch.cat(ks, dim=-1), dim=-1, stable=True)
    offs, pos, asc = 0, [], []
    for k in ks:
        ln = k.shape[-1]
        asc.append(k.flip(-1))
        p = torch.arange(ln - 1, -1, -1, device=k.device) + offs
        pos.append(p.expand(k.shape))
        offs += ln
    order = torch.argsort(torch.cat(asc, dim=-1), dim=-1, stable=True)
    return take_along(torch.cat(pos, dim=-1), -1, order).flip(-1)


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------


class _TopKVjp(torch.autograd.Function):
    """The reference's fused top-k VJP (``_fused_topk_bwd``,
    ``fused.py:363``): the values pass through as the kernel wrote them;
    backward scatter-adds their cotangent into zeros shaped like ``x`` at
    the kernel's own indices, pad slots (``idx < 0``) adding nothing."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return vals.view_as(vals)

    @staticmethod
    def backward(ctx, ct_v):
        (idx,) = ctx.saved_tensors
        pad = idx < 0
        contrib = torch.where(pad, torch.zeros_like(ct_v), ct_v)
        safe = torch.where(pad, 0, idx).long()
        return ct_v.new_zeros(ctx.shape).scatter_add(1, safe, contrib), None, None


def topk_vjp(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals`` (B, k), a top-k of the (B, n) rows ``x`` at ``idx``, made
    differentiable in ``x`` where ``x`` takes a gradient (integer values
    carry none); the values' bits are untouched."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return vals
    return _TopKVjp.apply(x, vals, idx)


# ---------------------------------------------------------------------------
# fused sort
# ---------------------------------------------------------------------------


class _FusedSort(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: FusedCfg, x: torch.Tensor, *leaves: torch.Tensor):
        from repro_torch.kernels.sort import loms_sort

        # with payload lanes under autograd, backward needs the kernel's own
        # permutation; otherwise the kernel writes none
        def run(lv, want_perm):
            return loms_sort(x, lv, network=cfg.network, key_dtype=cfg.key_dtype,
                             descending=cfg.descending, want_perm=want_perm,
                             use_mxu=cfg.use_mxu)

        want = bool(leaves) and any(ctx.needs_input_grad)
        out, perm, pouts = (_lanes_apart(run, leaves, want) if cfg.use_mxu
                            else run(leaves, want))
        ctx.cfg = cfg
        ctx.save_for_backward(x, perm, *leaves)
        return (out,) + tuple(pouts)

    @staticmethod
    def backward(ctx, ct_out, *ct_pouts):
        x, perm, *leaves = ctx.saved_tensors
        order = perm if perm is not None else sort_order(ctx.cfg, x)
        return (None, _scatter_rows(ct_out, order, x),
                *(_scatter_rows(c, order, leaf) for c, leaf in zip(ct_pouts, leaves)))


def fused_sort(cfg: FusedCfg, x: torch.Tensor, leaves: Sequence[torch.Tensor] = ()):
    """One-launch sort of (B, n) rows: ``(values, payload_outs)``."""
    failpoint("fused.launch.sort")
    res = _FusedSort.apply(cfg, x, *leaves)
    return res[0], tuple(res[1:])


# ---------------------------------------------------------------------------
# merge of two or more lists
# ---------------------------------------------------------------------------

Run = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]]


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: FusedCfg, run: Run, *tensors: torch.Tensor):
        k = len(cfg.lens)
        lists, leaves = tensors[:k], tensors[k:]
        want = bool(leaves) and any(ctx.needs_input_grad)
        if cfg.use_mxu:
            out, perm, pouts = _lanes_apart(
                lambda lv, wp: run(lists, lv, want_perm=wp), leaves, want)
        else:
            out, perm, pouts = run(lists, leaves, want_perm=want)
        ctx.cfg = cfg
        ctx.save_for_backward(perm, *tensors)
        return (out,) + tuple(pouts)

    @staticmethod
    def backward(ctx, ct_out, *ct_pouts):
        perm, *tensors = ctx.saved_tensors
        k = len(ctx.cfg.lens)
        lists, leaves = tensors[:k], tensors[k:]
        if perm is None:
            perm = merge_order(ctx.cfg, lists)
        ct_cat = _scatter_rows(ct_out, perm, torch.cat(lists, dim=-1))
        ct_lists = ((None,) * k if ct_cat is None
                    else torch.split(ct_cat, [t.shape[1] for t in lists], dim=1))
        return (None, None, *ct_lists,
                *(_scatter_rows(c, perm, leaf) for c, leaf in zip(ct_pouts, leaves)))


def fused_merge_k(cfg: FusedCfg, lists: Sequence[torch.Tensor],
                  leaves: Sequence[torch.Tensor] = ()):
    """One-launch merge of the sorted lists (B, n_i): ``(values,
    payload_outs)``; the leaves are already concatenated along the list
    axis, (B, sum n_i[, F]). Two lists of a ``merge`` config run kernel
    row 1, anything else kernel row 8 on ``kway_schedule(cfg.lens)``."""
    failpoint("fused.launch.merge_k")
    if len(lists) == 2 and cfg.op == "merge":
        from repro_torch.kernels.loms_merge import loms_merge2

        def run(ls, lv, want_perm):
            return loms_merge2(ls[0], ls[1], lv, network=cfg.network, n_cols=cfg.n_cols,
                               key_dtype=cfg.key_dtype, descending=cfg.descending,
                               want_perm=want_perm, use_mxu=cfg.use_mxu)
    else:
        from repro_torch.kernels.kway import kway_merge
        from repro_torch.networks import kway_schedule

        def run(ls, lv, want_perm):
            return kway_merge(torch.cat(list(ls), dim=-1), kway_schedule(cfg.lens), lv,
                              lens=cfg.lens, key_dtype=cfg.key_dtype,
                              descending=cfg.descending, want_perm=want_perm,
                              use_mxu=cfg.use_mxu)

    res = _Merge.apply(cfg, run, *lists, *leaves)
    return res[0], tuple(res[1:])
