"""Per-segment plain reference of the segmented ops.

Counterpart of ``repro.segmented.reference``: one stable argsort per
segment of its total-order keys (bit-flipped for descending), values
gathered from the raw input at the order. It is the oracle the tests hold
the class path against, and the answer of a segment op whose class path
failed (``repro_torch.api.ops._segmented_degrade``). ``zero_ties``
(``nan_policy="unsafe"``) ties -0.0 and +0.0, as the class path does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.common import (encode_key_values, flip_keys, key_transformable,
                                        tie_signed_zeros)


def _seg_order(seg: torch.Tensor, descending: bool, zero_ties: bool = False) -> torch.Tensor:
    keys = encode_key_values(seg) if key_transformable(seg.dtype) else seg
    if zero_ties:
        keys = tie_signed_zeros(keys)
    if descending:
        keys = flip_keys(keys)
    return torch.argsort(keys, stable=True)


def _cat(parts, like):
    return torch.cat(parts) if parts else like[:0]


def ref_segment_sort(values: torch.Tensor, offsets: Tuple[int, ...], *,
                     descending: bool = False, zero_ties: bool = False,
                     payload_lanes: Sequence[torch.Tensor] = ()):
    """Per-segment sort: ``(values, perm, payload_outs)``."""
    outs, perms = [], []
    pouts = [[] for _ in payload_lanes]
    for o0, o1 in zip(offsets, offsets[1:]):
        seg = values[o0:o1]
        order = (_seg_order(seg, descending, zero_ties) if o1 - o0 > 1 else
                 torch.zeros((o1 - o0,), dtype=torch.long, device=values.device))
        outs.append(seg[order])
        perms.append(order.to(torch.int32))
        for i, lane in enumerate(payload_lanes):
            pouts[i].append(lane[o0:o1][order])
    perm = _cat(perms, torch.zeros((0,), dtype=torch.int32, device=values.device))
    return (_cat(outs, values), perm,
            tuple(_cat(p, lane) for p, lane in zip(pouts, payload_lanes)))


def ref_segment_merge(a: torch.Tensor, b: torch.Tensor,
                      offsets_a: Tuple[int, ...], offsets_b: Tuple[int, ...], *,
                      descending: bool = False, zero_ties: bool = False,
                      payload_lanes: Sequence[torch.Tensor] = ()):
    """Per-segment 2-way merge of sorted runs; payload lanes in the merged
    CSR layout. Returns ``(values, perm, payload_outs, out_offsets)``."""
    out_offsets = tuple(x + y for x, y in zip(offsets_a, offsets_b))
    outs, perms = [], []
    pouts = [[] for _ in payload_lanes]
    for s in range(len(offsets_a) - 1):
        seg = torch.cat([a[offsets_a[s]:offsets_a[s + 1]],
                         b[offsets_b[s]:offsets_b[s + 1]]])
        order = (_seg_order(seg, descending, zero_ties) if seg.shape[0] > 1 else
                 torch.zeros(seg.shape, dtype=torch.long, device=a.device))
        outs.append(seg[order])
        perms.append(order.to(torch.int32))
        o0 = out_offsets[s]
        for i, lane in enumerate(payload_lanes):
            pouts[i].append(lane[o0:o0 + seg.shape[0]][order])
    perm = _cat(perms, torch.zeros((0,), dtype=torch.int32, device=a.device))
    return (_cat(outs, a), perm,
            tuple(_cat(p, lane) for p, lane in zip(pouts, payload_lanes)), out_offsets)


def ref_segment_topk(values: torch.Tensor, offsets: Tuple[int, ...],
                     ks: Tuple[int, ...], *, descending: bool = True,
                     zero_ties: bool = False, payload_lanes: Sequence[torch.Tensor] = ()):
    """Per-segment top-k: ``(values, idx, payload_outs, out_offsets)``."""
    outs, idxs = [], []
    pouts = [[] for _ in payload_lanes]
    out_offsets = [0]
    for s, (o0, o1) in enumerate(zip(offsets, offsets[1:])):
        cnt = min(int(ks[s]), o1 - o0)
        out_offsets.append(out_offsets[-1] + cnt)
        if cnt == 0:
            continue
        seg = values[o0:o1]
        order = _seg_order(seg, descending, zero_ties)[:cnt]
        outs.append(seg[order])
        idxs.append(order.to(torch.int32))
        for i, lane in enumerate(payload_lanes):
            pouts[i].append(lane[o0:o1][order])
    idx = _cat(idxs, torch.zeros((0,), dtype=torch.int32, device=values.device))
    return (_cat(outs, values), idx,
            tuple(_cat(p, lane) for p, lane in zip(pouts, payload_lanes)),
            tuple(out_offsets))
