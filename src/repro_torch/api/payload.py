"""Tie stabilisation for ``stable=True`` (counterpart of
``repro.api.payload.stabilize_ties``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import scatter_along, take_along

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
    v_i, v_j = vals[..., :, None], vals[..., None, :]
    p_i, p_j = pos[..., :, None], pos[..., None, :]
    ahead = (v_j > v_i) if descending else (v_j < v_i)
    rank = (ahead | ((v_j == v_i) & (p_j < p_i))).sum(dim=-1)
    return scatter_along(vals, -1, rank), scatter_along(perm, -1, rank)
