"""Plain torch oracles for the kernels (counterpart of
``repro.kernels.ref``): what a correct merge, sort, top-k or median
returns, whatever the tie order."""
from __future__ import annotations

from typing import Tuple

import torch


def merge2_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted merge of two sorted lists = sort of the concatenation."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def merge_k_ref(x: torch.Tensor) -> torch.Tensor:
    """k-way merge oracle on the concatenated input."""
    return torch.sort(x, dim=-1).values


def topk_ref(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k values and int32 indices (``torch.topk``)."""
    v, i = torch.topk(x, k, dim=-1)
    return v, i.to(torch.int32)


def median_ref(x: torch.Tensor) -> torch.Tensor:
    """Median of an odd number of values along the last axis."""
    n = x.shape[-1]
    if n % 2 != 1:
        raise ValueError(f"median_ref takes an odd count, got {n}")
    return torch.sort(x, dim=-1).values[..., n // 2]
