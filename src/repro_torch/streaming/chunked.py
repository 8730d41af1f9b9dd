"""The streaming 2-way merge: sorted rows of any length at a fixed tile
(counterpart of ``repro.streaming.chunked``, its 2-way grid mode).

:func:`chunked_merge` equals ``sort(concat([a, b], -1))`` on NaN-free
rows of any length, batched or not, in one launch of the grid merge
(kernel row 9). The reference's legacy one-launch-per-tile loop
(``mode="loop"``) and the k-way ``chunked_merge_k`` are not ported
(ROADMAP Queue 1, item 6; the k-way merge needs kernel row 8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grid_merge import grid_chunked_merge2
from .planner import plan_chunked


def _as_batched(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten the leading axes into one batch axis."""
    if x.ndim == 1:
        return x[None, :], ()
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def chunked_merge(a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None,
                  mode: str = "grid") -> torch.Tensor:
    """Streaming 2-way merge of ascending ``a`` (..., Na) and ``b``
    (..., Nb) into (..., Na + Nb). ``tile`` defaults to the planner's
    (``plan_chunked``)."""
    if mode == "loop":
        raise NotImplementedError(
            "chunked_merge(mode='loop'), the one-launch-per-tile loop, is not "
            "ported (ROADMAP Queue 1, item 6); the default mode='grid' is")
    if mode != "grid":
        raise ValueError(f"mode must be 'grid' or 'loop', got {mode!r}")
    a2, lead = _as_batched(a)
    b2, lead_b = _as_batched(b)
    if lead != lead_b:
        raise ValueError(f"leading shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, na = a2.shape
    nb = b2.shape[-1]
    t = int(tile if tile is not None else
            plan_chunked(na, nb, batch=bsz, dtype=a2.dtype).tile)
    t = max(2, t - (t % 2))
    out = grid_chunked_merge2(a2.contiguous(), b2.contiguous(), tile=t)
    return out.reshape(lead + (na + nb,)) if lead else out[0]
