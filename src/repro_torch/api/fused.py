"""The fused single-launch rungs of ``merge`` and ``sort`` (counterpart of
``repro.api.fused``).

On the reference's accelerator a ``repro.sort`` that fits its budget is
one launch of the fused sort kernel (row 2), and a ``repro.merge`` of two
lists that fits is one launch of the 2-way merge kernel (row 1): the
total-order key encode on load, the descending reversal, the payload
lanes and the decode on store all happen inside it. :func:`fused_sort`
and :func:`fused_merge_k` are those rungs, each differentiable: a
``torch.autograd.Function`` whose backward scatters the cotangents through
the permutation. With payload lanes the permutation is the kernel's own
(the payload gather is a concrete linear map, and a column device's tie
order need not be a stable argsort's); values-only, backward recomputes
it with one stable argsort of the keys, the subgradient convention of a
sort. The TPU had no backward kernel, so backward is plain torch.

A k-way list (three or more) raises ``NotImplementedError``: it runs
kernel row 8, which is not ported (ROADMAP Queue 2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import encode_key_values, key_transformable, take_along

from .spec import SortSpec


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a ``SortSpec.dtype`` name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def fused_eligible(spec: SortSpec) -> bool:
    """Whether the kernels run a sort or a 2-way merge as one fused
    launch: the loms network, not ``stable``, and within the reference's
    routing budget (a merge also needs a common column count)."""
    from repro_torch.streaming.planner import fits_vmem, sort_fits_vmem

    if spec.network != "loms" or spec.stable:
        return False
    if spec.op == "sort":
        return sort_fits_vmem(spec.total, dtype=dtype_of(spec.dtype))
    if spec.op == "merge":
        return not spec.ragged2 and fits_vmem(spec.lengths[0], spec.lengths[1],
                                              dtype=dtype_of(spec.dtype))
    return False


@dataclasses.dataclass(frozen=True)
class FusedCfg:
    """The static knobs of one fused call (the reference's ``FusedCfg``
    without ``block_batch``, ``use_mxu``, ``block`` and ``k``, which no
    fused merge or sort of the port reads)."""

    op: str
    lens: Tuple[int, ...]
    key_dtype: Optional[torch.dtype]  # the float dtype encoded, None: raw keys
    descending: bool = False
    n_cols: int = 2
    network: str = "loms"


def fused_cfg_for(spec: SortSpec, batch: int, dtype: torch.dtype) -> Optional[FusedCfg]:
    """The config of one eligible sort or merge (None if ineligible)."""
    from repro_torch.streaming.planner import plan_op

    if spec.op not in ("sort", "merge") or not fused_eligible(spec):
        return None
    key_dtype = (dtype if spec.nan_policy == "last" and key_transformable(dtype)
                 else None)
    plan = plan_op("sort" if spec.op == "sort" else "merge2", spec.lengths,
                   batch=batch, dtype=dtype)
    loms = plan.kind == "loms"
    return FusedCfg(op=spec.op, lens=tuple(spec.lengths), key_dtype=key_dtype,
                    descending=spec.descending, n_cols=plan.n_cols if loms else 2,
                    network=plan.network if loms else "loms")


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
# fused sort
# ---------------------------------------------------------------------------


class _FusedSort(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: FusedCfg, x: torch.Tensor, *leaves: torch.Tensor):
        from repro_torch.kernels.sort import loms_sort

        # with payload lanes under autograd, backward needs the kernel's own
        # permutation; otherwise the kernel writes none
        out, perm, pouts = loms_sort(x, leaves, network=cfg.network,
                                     key_dtype=cfg.key_dtype, descending=cfg.descending,
                                     want_perm=bool(leaves) and any(ctx.needs_input_grad))
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
    res = _FusedSort.apply(cfg, x, *leaves)
    return res[0], tuple(res[1:])


# ---------------------------------------------------------------------------
# 2-way merge (the fused rung, and the streaming rung of ops.merge)
# ---------------------------------------------------------------------------

Run = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]]


class _Merge2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: FusedCfg, run: Run, a: torch.Tensor, b: torch.Tensor,
                *leaves: torch.Tensor):
        out, perm, pouts = run(a, b, leaves,
                               want_perm=bool(leaves) and any(ctx.needs_input_grad))
        ctx.cfg = cfg
        ctx.save_for_backward(a, b, perm, *leaves)
        return (out,) + tuple(pouts)

    @staticmethod
    def backward(ctx, ct_out, *ct_pouts):
        a, b, perm, *leaves = ctx.saved_tensors
        if perm is None:
            perm = merge_order(ctx.cfg, (a, b))
        ct_a = ct_b = None
        ct_cat = _scatter_rows(ct_out, perm, torch.cat([a, b], dim=-1))
        if ct_cat is not None:
            ct_a, ct_b = ct_cat[:, :a.shape[1]], ct_cat[:, a.shape[1]:]
        return (None, None, ct_a, ct_b,
                *(_scatter_rows(c, perm, leaf) for c, leaf in zip(ct_pouts, leaves)))


def merge2_with_grad(cfg: FusedCfg, run: Run, a: torch.Tensor, b: torch.Tensor,
                     leaves: Sequence[torch.Tensor] = ()):
    """``run(a, b, leaves, want_perm=...) -> (out, perm, payload_outs)``
    made differentiable: ``(values, payload_outs)``."""
    res = _Merge2.apply(cfg, run, a, b, *leaves)
    return res[0], tuple(res[1:])


def fused_merge_k(cfg: FusedCfg, lists: Sequence[torch.Tensor],
                  leaves: Sequence[torch.Tensor] = ()):
    """One-launch merge of two lists: ``(values, payload_outs)``; the
    leaves are already concatenated along the list axis, (B, m + n[, F])."""
    if len(lists) != 2 or cfg.op != "merge":
        raise NotImplementedError(
            "a k-way merge runs kernel row 8 (_kway_kernel), which is not "
            "ported (ROADMAP Queue 2)")
    from repro_torch.kernels.loms_merge import loms_merge2

    def run(a, b, lv, want_perm):
        return loms_merge2(a, b, lv, network=cfg.network, n_cols=cfg.n_cols,
                           key_dtype=cfg.key_dtype, descending=cfg.descending,
                           want_perm=want_perm)

    return merge2_with_grad(cfg, run, lists[0], lists[1], leaves)
