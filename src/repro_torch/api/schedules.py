"""The schedule executor route of ``merge_k`` and ``median_of_lists``
(counterpart of ``repro.api.schedules``, its k-way merge and median).

The paper's devices run as plain torch ops on whatever device the
tensors lie: the LOMS k-way merge, the MWMS baseline, a binary tree of
2-way LOMS merges, and the two-stage LOMS (or MWMS) median. The last axis
is the sorted axis; leading axes are batch. It is the only route that
carries a payload through any device, which ``stable=True`` and payload
merges past the kernel's budget need. The schedule executor of ``sort``,
``topk``, ragged 2-way merges and ``median9`` is not ported (ROADMAP
Queue 1, item 4).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import loms as _loms
from repro_torch.core import mwms as _mwms
from repro_torch.core.networks import apply_schedule, apply_schedule_with_payload


def merge(a: torch.Tensor, b: torch.Tensor, n_cols: int = 2,
          payload: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """2-way LOMS merge of two ascending lists along the last axis (the
    device the tree kind is built of)."""
    sched = _loms.loms_2way(a.shape[-1], b.shape[-1], n_cols)
    x = torch.cat([a, b], dim=-1)
    if payload is None:
        return apply_schedule(sched, x)
    return apply_schedule_with_payload(sched, x, torch.cat(list(payload), dim=-1))


def merge_k(lists: Sequence[torch.Tensor], kind: str = "loms",
            payload: Optional[Sequence[torch.Tensor]] = None):
    """k-way merge of ascending lists. ``kind``: loms | mwms | tree.
    Returns the values, or ``(values, payload)`` with one."""
    lens = tuple(int(t.shape[-1]) for t in lists)
    if kind in ("loms", "mwms"):
        sched = _loms.loms_kway(lens) if kind == "loms" else _mwms.mwms_kway(lens)
        x = torch.cat(list(lists), dim=-1)
        if payload is None:
            return apply_schedule(sched, x)
        return apply_schedule_with_payload(sched, x, torch.cat(list(payload), dim=-1))
    if kind == "tree":  # a binary tree of 2-way LOMS merges (the prior-art pattern)
        items = list(lists)
        pls = list(payload) if payload is not None else None
        while len(items) > 1:
            nxt, npl = [], []
            for i in range(0, len(items) - 1, 2):
                if pls is None:
                    nxt.append(merge(items[i], items[i + 1]))
                else:
                    v, p = merge(items[i], items[i + 1], payload=(pls[i], pls[i + 1]))
                    nxt.append(v)
                    npl.append(p)
            if len(items) % 2:
                nxt.append(items[-1])
                if pls is not None:
                    npl.append(pls[-1])
            items, pls = nxt, (npl if pls is not None else None)
        return items[0] if payload is None else (items[0], pls[0])
    raise ValueError(f"unknown merge_k kind {kind!r}")


def median_of_lists(lists: Sequence[torch.Tensor], kind: str = "loms") -> torch.Tensor:
    """Median of k equal odd-length sorted lists after the device's first
    stages (two for LOMS)."""
    lens = tuple(int(t.shape[-1]) for t in lists)
    sched, pos = _loms.loms_median(lens) if kind == "loms" else _mwms.mwms_median(lens)
    return apply_schedule(sched, torch.cat(list(lists), dim=-1))[..., pos]
