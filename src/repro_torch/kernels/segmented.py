"""Segmented class kernels: one launch per pow2 size class.

Counterpart of ``repro.kernels.segmented``. The bucketer
(:mod:`repro_torch.segmented`) packs every segment whose length rounds up
to the same power of two ``W`` into the rows of a dense ``(S, W)`` tile,
with each row's valid length beside it. One launch then, per row:

  encode total-order int32 keys (floats) -> flip the key bits for
  descending (``~k``) -> put the key-domain +sentinel on the lanes past
  ``lens`` -> run the family's merge tree (sort) or 2-run merge program
  (merge), carrying an int32 position lane -> stable mask compaction of
  the valid lanes (``stable_compact``) -> gather the *raw* values and the
  payload lanes at the positions -> store the ``k_out`` prefix.

Values are gathered, never decoded, so NaN payload bits, -0.0 and +0.0
come out as they went in; ``k_out`` makes per-segment top-k the same
launch as the class sort.

``segment_class_sort`` replaces ``segment_class_sort_pallas``
(``_seg_sort_kernel``, ``src/repro/kernels/segmented.py:97``) and
``segment_class_merge`` replaces ``segment_class_merge_pallas``
(``_seg_merge_kernel``, ``:115``). A CUDA tensor goes to the kernels of
``csrc/segmented.cu`` or raises; a CPU tensor runs the plain versions
below, which are the reference's kernel bodies in torch ops. The
reference's ``use_mxu`` is False on every path the port serves (encoded
keys and int keys take the exact permute), so it has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import (merge_program, merge_runs, pick_merge_cols,
                                  run_sort_program, sort_program)
from .common import (encode_key_values, flip_keys, gather_lanes, sentinel_max,
                     stable_compact)
from . import launch
from .launch import (KEY_CODE, check_rc, cuda_checks, empty_payloads, library,
                     payload_args, program_tensor, sort_prefix, stream)
from .topk import LAUNCHES

#: widest class a sort launch takes (the reference's cutover, see
#: ``segmented.core.max_class_width``) and widest merge pair
SORT_MAX_WIDTH = 1024
MERGE_MAX_WIDTH = 2048
Result = Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]


def _prep_keys(x: torch.Tensor, lens: torch.Tensor, *, flip: bool):
    """values -> masked network keys and the lane index of every input:
    floats are encoded, int32 is taken raw."""
    keys = encode_key_values(x) if x.dtype.is_floating_point else x
    if flip:
        keys = flip_keys(keys)
    lane = torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device).expand(x.shape)
    sent = torch.full_like(keys, sentinel_max(keys.dtype))  # the key-domain +sentinel
    return torch.where(lane < lens, keys, sent), lane


def _store_prefix(pos, x_vals, payloads, k_out, want_perm, seg_pos=None) -> Result:
    out = gather_lanes(pos, x_vals)[:, :k_out]
    perm = (pos if seg_pos is None else seg_pos)[:, :k_out] if want_perm else None
    return out, perm, tuple(gather_lanes(pos, p)[:, :k_out] for p in payloads)


def _check_class(dense: torch.Tensor, lens: torch.Tensor, payloads, width: int):
    s = dense.shape[0]
    if dense.ndim != 2:
        raise ValueError(f"a class tile is (S, W), got {tuple(dense.shape)}")
    if lens.shape != (s, 1):
        raise ValueError(f"lens must be (S, 1) = ({s}, 1), got {tuple(lens.shape)}")
    for p in payloads:
        if p.ndim not in (2, 3) or p.shape[:2] != (s, width):
            raise ValueError(f"payload lane of shape {tuple(p.shape)} does not "
                             f"match the tile ({s}, {width}[, F])")


def segment_class_sort_plain(dense, lens, payloads=(), *, k_out=None,
                             network="loms", flip=False,
                             want_perm=False) -> Result:
    """Plain version of ``_seg_sort_kernel`` (``segmented.py:97``)."""
    w = dense.shape[1]
    k_out = w if k_out is None else int(k_out)
    lens = lens.to(torch.int32)
    keys, lane = _prep_keys(dense, lens, flip=flip)
    keys, pos = run_sort_program(sort_program(network, w), keys, lane)
    keys, pos = stable_compact(pos < lens, keys, pos)
    return _store_prefix(pos, dense, payloads, k_out, want_perm)


def segment_class_merge_plain(dense_a, dense_b, lens_a, lens_b, payloads=(), *,
                              k_out=None, network="loms",
                              flip=False, want_perm=False,
                              n_cols: Optional[int] = None) -> Result:
    """Plain version of ``_seg_merge_kernel`` (``segmented.py:115``)."""
    wa, wb = dense_a.shape[1], dense_b.shape[1]
    k_out = wa + wb if k_out is None else int(k_out)
    n_cols = pick_merge_cols(wa, wb) if n_cols is None else int(n_cols)
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    ka, lane_a = _prep_keys(dense_a, lens_a, flip=flip)
    kb, lane_b = _prep_keys(dense_b, lens_b, flip=flip)
    prog = merge_program(network, wa, wb, n_cols if network == "loms" else None)
    keys, pos = merge_runs(prog, ka, kb, payload=(lane_a, wa + lane_b))
    valid = torch.where(pos < wa, pos < lens_a, pos - wa < lens_b)
    keys, pos = stable_compact(valid, keys, pos)
    seg_pos = torch.where(pos < wa, pos, lens_a + (pos - wa))
    return _store_prefix(pos, torch.cat([dense_a, dense_b], dim=1), payloads,
                         k_out, want_perm, seg_pos=seg_pos)


def _alloc_outputs(dense, payloads, s, k_out):
    out = torch.empty((s, k_out), dtype=dense.dtype, device=dense.device)
    perm = torch.empty((s, k_out), dtype=torch.int32, device=dense.device)
    return out, perm, empty_payloads(payloads, s, k_out)


def segment_class_sort(dense: torch.Tensor, lens: torch.Tensor,
                       payloads: Sequence[torch.Tensor] = (), *,
                       k_out: Optional[int] = None, network: str = "loms",
                       flip: bool = False, want_perm: bool = False) -> Result:
    """One size-class sort launch: every row of ``dense`` (S, W), W a
    power of two, sorted on its own, valid prefix first; ``lens`` (S, 1)
    int32. Returns ``(out, perm | None, payload_outs)`` of width
    ``k_out``: raw values gathered at the permutation, within-row input
    positions, payload lanes (S, W[, F]) gathered alike. Lanes past a
    row's length are what the network left there (the CSR scatter never
    reads them)."""
    payloads = tuple(payloads)
    s, w = dense.shape
    if w < 1 or w & (w - 1) or w > SORT_MAX_WIDTH:
        raise ValueError(f"class width {w} must be a power of two <= {SORT_MAX_WIDTH}")
    k_out = w if k_out is None else int(k_out)
    if not 1 <= k_out <= w:
        raise ValueError(f"k_out={k_out} out of range [1, {w}]")
    _check_class(dense, lens, payloads, w)
    if dense.device.type == "cpu":
        return segment_class_sort_plain(dense, lens, payloads, k_out=k_out,
                                        network=network, flip=flip,
                                        want_perm=want_perm)
    lens = lens.to(torch.int32).contiguous()
    cuda_checks("class kernels", (dense, lens) + payloads, dense.dtype, len(payloads))
    prog = program_tensor(dense.device, "sort", network, w)
    out, perm, pouts = _alloc_outputs(dense, payloads, s, k_out)
    if s:
        n, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("segmented").repro_seg_sort(
            dense.data_ptr(), lens.data_ptr(), prog.data_ptr(), out.data_ptr(),
            perm.data_ptr(), n, ins, po, rb, s, w, k_out,
            KEY_CODE[dense.dtype], int(flip), sort_prefix(network, w), launch.SORT_LANES,
            stream(dense)), "seg_sort")
        LAUNCHES["seg_sort"] += 1
    return out, (perm if want_perm else None), pouts


def segment_class_merge(dense_a: torch.Tensor, dense_b: torch.Tensor,
                        lens_a: torch.Tensor, lens_b: torch.Tensor,
                        payloads: Sequence[torch.Tensor] = (), *,
                        k_out: Optional[int] = None, network: str = "loms",
                        flip: bool = False, want_perm: bool = False,
                        n_cols: Optional[int] = None) -> Result:
    """One size-class 2-way merge launch: row ``s`` merges the sorted runs
    ``a[s, :lens_a[s]]`` and ``b[s, :lens_b[s]]``. ``perm`` is in segment
    coordinates (b's positions continue at the valid ``lens_a``); payload
    lanes come in dense ``[a | b]`` coordinates of width Wa + Wb."""
    payloads = tuple(payloads)
    s, wa = dense_a.shape
    wb = dense_b.shape[1]
    for w in (wa, wb):
        if w < 1 or w & (w - 1):
            raise ValueError(f"class widths must be powers of two, got ({wa}, {wb})")
    if wa + wb > MERGE_MAX_WIDTH:
        raise ValueError(f"merge pair ({wa}, {wb}) exceeds {MERGE_MAX_WIDTH}")
    if dense_b.shape[0] != s or dense_b.dtype != dense_a.dtype:
        raise ValueError("the two runs need the same rows and dtype")
    total = wa + wb
    k_out = total if k_out is None else int(k_out)
    if not 1 <= k_out <= total:
        raise ValueError(f"k_out={k_out} out of range [1, {total}]")
    _check_class(dense_a, lens_a, (), wa)
    _check_class(dense_b, lens_b, (), wb)
    for p in payloads:
        if p.ndim not in (2, 3) or p.shape[:2] != (s, total):
            raise ValueError(f"payload lane of shape {tuple(p.shape)} does not "
                             f"match the merged tile ({s}, {total}[, F])")
    n_cols = pick_merge_cols(wa, wb) if n_cols is None else int(n_cols)
    if dense_a.device.type == "cpu":
        return segment_class_merge_plain(
            dense_a, dense_b, lens_a, lens_b, payloads, k_out=k_out,
            network=network, flip=flip, want_perm=want_perm, n_cols=n_cols)
    lens_a = lens_a.to(torch.int32).contiguous()
    lens_b = lens_b.to(torch.int32).contiguous()
    cuda_checks("class kernels", (dense_a, dense_b, lens_a, lens_b) + payloads,
                dense_a.dtype, len(payloads))
    prog = program_tensor(dense_a.device, "merge", network, wa, wb,
                          n_cols if network == "loms" else None)
    out, perm, pouts = _alloc_outputs(dense_a, payloads, s, k_out)
    if s:
        n, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("segmented").repro_seg_merge(
            dense_a.data_ptr(), dense_b.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), prog.data_ptr(), out.data_ptr(), perm.data_ptr(),
            n, ins, po, rb, s, wa, wb, k_out, KEY_CODE[dense_a.dtype],
            int(flip), stream(dense_a)), "seg_merge")
        LAUNCHES["seg_merge"] += 1
    return out, (perm if want_perm else None), pouts
