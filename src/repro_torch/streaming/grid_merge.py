"""The one-launch streaming 2-way merge (kernel row 9).

Counterpart of ``repro.streaming.grid_merge``: :func:`grid_chunked_merge2`
replaces the reference's function of that name (``_grid_merge2_kernel``,
``src/repro/streaming/grid_merge.py:43``). It merges the ascending rows
``a`` (B, Na) and ``b`` (B, Nb) into (B, Na + Nb), values only.

The TPU kernel walks each row's output tiles in order with the FLiMS
carry in VMEM. :func:`grid_chunked_merge2_plain` runs that carry loop
step by step: each stream padded past its tail with one tile of the
dtype's maximum; the prologue merges the first tile of each stream and
emits the lower half; every later step refills the stream whose
last-loaded value is smaller (``a`` on ties), merges the tile with the
carry by the family's merge program, emits the lower half and keeps the
upper half. A CUDA tensor goes to ``grid_merge2_kernel``
(``csrc/grid_merge.cu``), a merge-path merge: on keys the sorted multiset
is unique, so any correct merge gives the carry loop's bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_tail_sorted, take_along
from repro_torch.kernels.launch import KEY_CODE, check_rc, cuda_checks, library, stream
from repro_torch.kernels.topk import LAUNCHES
from repro_torch.networks import merge_program, merge_runs


def _check(a, b, tile):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"the grid merge takes (B, Na) and (B, Nb), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"the two rows need one dtype, got {a.dtype}, {b.dtype}")
    if tile < 2 or tile % 2:
        raise ValueError(f"tile must be even and >= 2, got {tile}")


def grid_chunked_merge2_plain(a: torch.Tensor, b: torch.Tensor, *, tile: int = 512,
                              network: str = "loms") -> torch.Tensor:
    """Plain version of ``_grid_merge2_kernel``: the FLiMS carry loop."""
    bsz, na = a.shape
    nb = b.shape[1]
    t = int(tile)
    total = na + nb
    out_tiles = -(-total // t)
    la, lb = (-(-na // t) + 1) * t, (-(-nb // t) + 1) * t  # + one drain tile
    ap, bp = pad_tail_sorted(a, la), pad_tail_sorted(b, lb)
    prog = merge_program(network, t, t)
    lane = torch.arange(t, device=a.device)

    def load(rows, ptr):  # the stream not taken may point past an empty row
        return take_along(rows, 1, torch.clamp(ptr, max=rows.shape[1] - t)[:, None] + lane)

    merged = merge_runs(prog, ap[:, :t], bp[:, :t])
    out = [merged[:, :t]]
    carry = merged[:, t:]
    ptr_a = torch.full((bsz,), t, dtype=torch.long, device=a.device)
    ptr_b = ptr_a.clone()
    last_a, last_b = ap[:, t - 1], bp[:, t - 1]
    for _ in range(1, out_tiles):
        sel_a = last_a <= last_b  # refill the lagging stream
        cur = torch.where(sel_a[:, None], load(ap, ptr_a), load(bp, ptr_b))
        tail = cur[:, t - 1]
        last_a = torch.where(sel_a, tail, last_a)
        last_b = torch.where(sel_a, last_b, tail)
        # pointers stop at the drain tile: an exhausted stream reads pads
        ptr_a = torch.where(sel_a, torch.clamp(ptr_a + t, max=la - t), ptr_a)
        ptr_b = torch.where(sel_a, ptr_b, torch.clamp(ptr_b + t, max=lb - t))
        merged = merge_runs(prog, carry, cur)
        out.append(merged[:, :t])
        carry = merged[:, t:]
    return torch.cat(out, dim=1)[:, :total]


def grid_chunked_merge2(a: torch.Tensor, b: torch.Tensor, *, tile: int = 512,
                        network: str = "loms") -> torch.Tensor:
    """One-launch streaming merge of ascending (B, Na) and (B, Nb): the
    sorted concatenation of each row pair. ``tile`` and ``network`` shape
    the plain version's carry loop; the CUDA kernel's tiles are its own.
    Values only; floats merge as their total-order keys on the card."""
    _check(a, b, int(tile))
    if a.device.type == "cpu":
        return grid_chunked_merge2_plain(a, b, tile=tile, network=network)
    cuda_checks("grid merge", (a, b), a.dtype)
    bsz, na = a.shape
    nb = b.shape[1]
    out = torch.empty((bsz, na + nb), dtype=a.dtype, device=a.device)
    if bsz and na + nb:
        check_rc(library("grid_merge").repro_grid_merge2(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, na, nb, KEY_CODE[a.dtype],
            stream(a)), "grid_merge2")
        LAUNCHES["grid_merge2"] += 1
    return out
