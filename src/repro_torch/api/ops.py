"""Public sorting-library entry points of the port.

Counterpart of ``repro.api.ops``. This slice carries ``topk`` as the
reference's fused rung runs it (``repro.api.fused.fused_topk``,
``src/repro/api/fused.py:332``): last axis of a 2-D tensor, descending,
``nan_policy="last"``, the key transform inside the kernels, the router
kernel for an axis of at most 512 and the vocab kernels above, int32
indices with -1 on pad slots. The planner's block choice is the
reference's heuristic, so the merge tree is the reference's too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk import (
    ROUTER_TOPK_MAX,
    plan_block,
    router_topk,
    topk_tiles,
    vocab_topk,
)

__all__ = ["topk", "topk_block"]


def topk_block(n: int, k: int) -> int:
    """The block the fused rung uses for a top-k over an axis of ``n``."""
    return topk_tiles(1, n, block=plan_block(n, k))[0]


def topk(x: torch.Tensor, k: int, *, descending: bool = True,
         nan_policy: str = "last") -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis of a (rows, n) float tensor,
    descending: ``(values, int32 indices)``.

    NaNs rank above +inf, -0.0 below +0.0, and among equal values the
    higher index comes first, exactly as the reference's kernels order
    them. Runs on the tensor's device: the CUDA kernels for a card
    tensor, their plain versions for a CPU tensor."""
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
        return router_topk(x, k, block=block)
    return vocab_topk(x, k, block=block)
