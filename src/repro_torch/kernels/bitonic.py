"""The Batcher bitonic aliases (counterpart of ``repro.kernels.bitonic``):
the ``bitonic`` network family run by the shared merge and sort kernels
(rows 1 and 2), ``network="bitonic"``."""
from __future__ import annotations

from typing import Sequence

import torch

from .loms_merge import loms_merge2
from .sort import loms_sort


def bitonic_merge2(a: torch.Tensor, b: torch.Tensor, **kwargs):
    """Merge the sorted rows ``a`` (B, m) and ``b`` (B, n), pow2 total,
    with the ``bitonic`` family: ``loms_merge2(..., network="bitonic")``
    (its return convention)."""
    return loms_merge2(a, b, network="bitonic", **kwargs)


def bitonic_sort(x: torch.Tensor, payloads: Sequence[torch.Tensor] = (), **kwargs):
    """Full sort with the ``bitonic`` family:
    ``loms_sort(..., network="bitonic")`` (its return convention)."""
    return loms_sort(x, payloads, network="bitonic", **kwargs)
