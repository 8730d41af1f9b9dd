"""Size-class bucketing over static CSR segment offsets (a copy of
``repro.segmented.bucketing``, pure Python and numpy).

A segment of length L lands in the class of width ``ceil_pow2(L)``;
classes wider than ``max_width`` spill, grouped by exact length. The
gather and scatter maps between the flat CSR layout and each class's
dense ``(n_segments, width)`` tile are numpy constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import ceil_pow2


def normalize_offsets(offsets) -> Tuple[int, ...]:
    """Validate CSR offsets into a static int tuple. They size networks
    and launches, so they are host values: a card tensor is copied to the
    host here."""
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.detach().cpu().numpy()
    offs = tuple(int(o) for o in np.asarray(offsets).reshape(-1))
    if len(offs) < 1:
        raise ValueError("segment_offsets needs at least one entry")
    if offs[0] != 0:
        raise ValueError(f"segment_offsets must start at 0, got {offs[0]}")
    if any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"segment_offsets must be non-decreasing: {offs}")
    return offs


def segment_lengths(offsets: Tuple[int, ...]) -> np.ndarray:
    return np.diff(np.asarray(offsets, np.int64)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SizeClass:
    """One bucket: every member segment rounds up to the same pow2 width."""

    width: int  # pow2 class width (dense tile lane count)
    seg_ids: Tuple[int, ...]  # member segment indices, ascending
    lens: Tuple[int, ...]  # true member lengths (0 < len <= width)

    @property
    def n(self) -> int:
        return len(self.seg_ids)


def bucket_segments(
    lengths: np.ndarray, max_width: int
) -> Tuple[List[SizeClass], List[SizeClass]]:
    """Group segments into pow2 size classes.

    Returns ``(classes, spill)``: ``classes`` hold every segment whose
    class width fits ``max_width`` (one Pallas launch each); ``spill``
    groups the longer segments by *exact* length (equal-length spill
    segments batch into one streaming/executor call). Empty segments are
    dropped — they produce no output and must never reach a network.
    """
    by_width: Dict[int, List[int]] = {}
    spill_by_len: Dict[int, List[int]] = {}
    for sid, ln in enumerate(np.asarray(lengths).tolist()):
        ln = int(ln)
        if ln == 0:
            continue
        w = ceil_pow2(ln)
        if w <= max_width:
            by_width.setdefault(w, []).append(sid)
        else:
            spill_by_len.setdefault(ln, []).append(sid)
    lengths = np.asarray(lengths)
    classes = [
        SizeClass(width=w, seg_ids=tuple(ids),
                  lens=tuple(int(lengths[i]) for i in ids))
        for w, ids in sorted(by_width.items())
    ]
    spill = [
        SizeClass(width=ln, seg_ids=tuple(ids), lens=(ln,) * len(ids))
        for ln, ids in sorted(spill_by_len.items())
    ]
    return classes, spill


def bucket_merge_pairs(
    lens_a: np.ndarray, lens_b: np.ndarray, max_width: int
) -> Tuple[List[Tuple[SizeClass, SizeClass]], List[Tuple[SizeClass, SizeClass]]]:
    """Bucket per-segment (a, b) merge pairs by the pow2 class of each run.

    A pair where either run is empty still routes through the class of the
    pair — the kernels handle len 0 by mask — but a pair whose *combined*
    class width exceeds ``max_width`` spills (grouped by exact lengths).
    """
    by_key: Dict[Tuple[int, int], List[int]] = {}
    spill_by_len: Dict[Tuple[int, int], List[int]] = {}
    la = np.asarray(lens_a)
    lb = np.asarray(lens_b)
    for sid in range(len(la)):
        a, b = int(la[sid]), int(lb[sid])
        if a == 0 and b == 0:
            continue
        wa, wb = ceil_pow2(a), ceil_pow2(b)
        if wa + wb <= max_width:
            by_key.setdefault((wa, wb), []).append(sid)
        else:
            spill_by_len.setdefault((a, b), []).append(sid)

    def pair(key, ids, exact):
        ka, kb = key
        return (
            SizeClass(width=ka, seg_ids=tuple(ids),
                      lens=tuple(int(la[i]) for i in ids) if not exact
                      else (ka,) * len(ids)),
            SizeClass(width=kb, seg_ids=tuple(ids),
                      lens=tuple(int(lb[i]) for i in ids) if not exact
                      else (kb,) * len(ids)),
        )

    classes = [pair(k, ids, False) for k, ids in sorted(by_key.items())]
    spill = [pair(k, ids, True) for k, ids in sorted(spill_by_len.items())]
    return classes, spill


def gather_map(offsets: Sequence[int], cls: SizeClass,
               sentinel: int) -> np.ndarray:
    """(n, width) int32 indices from the class tile into the flat CSR
    array extended with one trailing pad slot at ``sentinel`` (= N)."""
    n, w = cls.n, cls.width
    idx = np.full((n, w), sentinel, np.int32)
    lane = np.arange(w)
    for r, (sid, ln) in enumerate(zip(cls.seg_ids, cls.lens)):
        off = offsets[sid]
        idx[r, :ln] = off + lane[:ln]
    return idx


def scatter_map(out_offsets: Sequence[int], cls: SizeClass, width: int,
                counts: Optional[Sequence[int]] = None,
                trash: Optional[int] = None) -> np.ndarray:
    """(n, width) int32 flat output positions for the class tile's valid
    prefix; invalid lanes route to the ``trash`` slot (default: the total
    output length, i.e. one past the last real element).

    ``counts`` overrides the per-row valid count (top-k truncation);
    otherwise the segment's true length is used.
    """
    if trash is None:
        trash = int(out_offsets[-1])
    n = cls.n
    idx = np.full((n, width), trash, np.int32)
    lane = np.arange(width)
    for r, (sid, ln) in enumerate(zip(cls.seg_ids, cls.lens)):
        cnt = int(counts[r]) if counts is not None else int(ln)
        cnt = min(cnt, width)
        idx[r, :cnt] = int(out_offsets[sid]) + lane[:cnt]
    return idx
