"""Segmented class kernels: one launch per pow2 size class.

Counterpart of ``repro.kernels.segmented``. The bucketer
(:mod:`repro_torch.segmented`) packs every segment whose length rounds up
to the same power of two ``W`` into the rows of a dense ``(S, W)`` tile,
with each row's valid length beside it. One launch then, per row:

  encode total-order int32 keys (floats; under ``nan_policy="unsafe"``
  -0.0 takes +0.0's key, ``zero_ties``) -> flip the key bits for
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
below, which are the reference's kernel bodies in torch ops. The class
merge takes its kernel by program and shape, never as a fallback: a
single-level program (loms with at most 16 columns, s2ms) whose row, raw
values and payload lanes fit a CTA's shared memory runs
``seg_merge_rows_kernel`` on the row-merge executor of
``csrc/merge_rows.cuh`` (its decomposition on the CPU:
:func:`seg_merge_rows_emulated`), the pair-stage families and the rest
``seg_merge_kernel``. The
reference's ``use_mxu`` is False on every path the port serves (encoded
keys and int keys take the exact permute), so it has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import (merge_program, merge_runs, pick_merge_cols,
                                  run_sort_program, sort_program)
from .common import (encode_key_values, flip_keys, gather_lanes, sentinel_max,
                     stable_compact, tie_signed_zeros)
from . import launch
from .launch import (KEY_CODE, check_rc, cuda_checks, empty_payloads, library,
                     payload_args, program_tensor, sort_prefix, stream)
from .loms_merge import (column_merges_emulated, lane_bytes, row_ranks_emulated,
                         row_sorts_emulated, rows_fit, tile_cols)
from .topk import LAUNCHES

#: widest class a sort launch takes (the reference's cutover, see
#: ``segmented.core.max_class_width``) and widest merge pair
SORT_MAX_WIDTH = 1024
MERGE_MAX_WIDTH = 2048
Result = Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]


def _prep_keys(x: torch.Tensor, lens: torch.Tensor, *, flip: bool,
               zero_ties: bool = False):
    """values -> masked network keys and the lane index of every input:
    floats are encoded (``zero_ties``: -0.0 with +0.0's key), int32 is
    taken raw."""
    keys = x
    if x.dtype.is_floating_point:
        keys = encode_key_values(x)
        keys = tie_signed_zeros(keys) if zero_ties else keys
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
                             want_perm=False, zero_ties=False) -> Result:
    """Plain version of ``_seg_sort_kernel`` (``segmented.py:97``)."""
    w = dense.shape[1]
    k_out = w if k_out is None else int(k_out)
    lens = lens.to(torch.int32)
    keys, lane = _prep_keys(dense, lens, flip=flip, zero_ties=zero_ties)
    keys, pos = run_sort_program(sort_program(network, w), keys, lane)
    keys, pos = stable_compact(pos < lens, keys, pos)
    return _store_prefix(pos, dense, payloads, k_out, want_perm)


def segment_class_merge_plain(dense_a, dense_b, lens_a, lens_b, payloads=(), *,
                              k_out=None, network="loms",
                              flip=False, want_perm=False,
                              n_cols: Optional[int] = None, zero_ties=False) -> Result:
    """Plain version of ``_seg_merge_kernel`` (``segmented.py:115``)."""
    wa, wb = dense_a.shape[1], dense_b.shape[1]
    k_out = wa + wb if k_out is None else int(k_out)
    n_cols = pick_merge_cols(wa, wb) if n_cols is None else int(n_cols)
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    ka, lane_a = _prep_keys(dense_a, lens_a, flip=flip, zero_ties=zero_ties)
    kb, lane_b = _prep_keys(dense_b, lens_b, flip=flip, zero_ties=zero_ties)
    prog = merge_program(network, wa, wb, n_cols if network == "loms" else None)
    keys, pos = merge_runs(prog, ka, kb, payload=(lane_a, wa + lane_b))
    valid = torch.where(pos < wa, pos < lens_a, pos - wa < lens_b)
    keys, pos = stable_compact(valid, keys, pos)
    seg_pos = torch.where(pos < wa, pos, lens_a + (pos - wa))
    return _store_prefix(pos, torch.cat([dense_a, dense_b], dim=1), payloads,
                         k_out, want_perm, seg_pos=seg_pos)


def seg_merge_rows_emulated(dense_a, dense_b, lens_a, lens_b, payloads=(), *,
                            k_out=None, network="loms", flip=False,
                            n_cols: Optional[int] = None, threads: int = 32) -> Result:
    """``seg_merge_rows_kernel``'s decomposition on the CPU at ``threads``
    threads a row: keys with the sentinel INT32_MAX past each run's length,
    each thread's diagonal search and merge steps and the row sorts of the
    single-level program (``loms_merge`` :func:`column_merges_emulated`,
    and :func:`row_sorts_emulated`, or :func:`row_ranks_emulated` where the
    row has more threads than stack rows); then the valid-first compaction as the
    kernel computes it, only in the rows where a valid key ties the
    sentinel (int32 keys; with fewer than 32 threads a row, in every row of
    such a row's warp): thread t of the row counts the valid lanes of its
    span [t * per, (t + 1) * per) and an exclusive scan over the threads
    places them; elsewhere the merged order, sorted by key with the
    sentinel lanes last, is valid-first already. Then the ``k_out`` prefix:
    raw values and payload rows gathered at the lanes, positions in segment
    coordinates. For the tests; equals :func:`segment_class_merge_plain`
    (``perm`` always returned)."""
    s_, wa = dense_a.shape
    wb = dense_b.shape[1]
    L = wa + wb
    k_out = L if k_out is None else int(k_out)
    cols = tile_cols(network, wa, wb, pick_merge_cols(wa, wb) if n_cols is None
                     else int(n_cols), False)
    if not cols:
        raise ValueError(f"{network} is not a single-level program of at most 16 columns")
    lens_a, lens_b = lens_a.to(torch.int64), lens_b.to(torch.int64)
    ka, lane_a = _prep_keys(dense_a, lens_a, flip=flip)
    kb, lane_b = _prep_keys(dense_b, lens_b, flip=flip)
    sent = torch.iinfo(torch.int32).max
    tie = torch.zeros((s_,), dtype=torch.bool)
    if dense_a.dtype == torch.int32:  # float keys never encode to the sentinel
        tie = (((ka == sent) & (lane_a < lens_a)).any(-1)
               | ((kb == sent) & (lane_b < lens_b)).any(-1))
        if threads < 32:  # a warp's rows compact together
            per_warp = 32 // threads
            pad = torch.cat([tie, torch.zeros((-s_) % per_warp, dtype=torch.bool)])
            tie = pad.view(-1, per_warp).any(-1).repeat_interleave(per_warp)[:s_]
    nt = threads
    stack_k, stack_e = column_merges_emulated(torch.cat([ka, kb], -1).to(torch.int64), wa,
                                              cols, -(-L // nt))
    if cols > 1 and nt > L // cols:  # more threads than stack rows: counted ranks
        lane = row_ranks_emulated(stack_k, stack_e)
    else:
        _, lane = row_sorts_emulated(stack_k, stack_e,
                                     dense_a.dtype in (torch.bfloat16, torch.float16))
    valid = torch.where(lane < wa, lane < lens_a, lane - wa < lens_b).to(torch.int64)
    per = -(-L // nt)
    owner = torch.arange(L) // per
    count = torch.zeros((s_, nt), dtype=torch.int64).index_add_(1, owner, valid)
    total = count.sum(-1, keepdim=True)
    start = torch.cumsum(count, -1) - count  # the scan: valid lanes before each thread
    run = torch.cumsum(valid, -1) - valid
    before = start[:, owner] + run - run[:, owner * per]  # ... and before each lane
    j = torch.arange(L)
    dest = torch.where(valid.bool(), before, total + j - before)
    dest = torch.where(tie[:, None], dest, j)
    lane = torch.zeros_like(lane).scatter_(1, dest, lane)[:, :k_out]
    out = gather_lanes(lane, torch.cat([dense_a, dense_b], dim=1))
    perm = torch.where(lane < wa, lane, lens_a + (lane - wa)).to(torch.int32)
    return out, perm, tuple(gather_lanes(lane, p) for p in payloads)


def _mode(flip: bool, zero_ties: bool) -> int:
    """The kernels' key mode (``csrc/segmented.cu`` ``class_key``)."""
    return int(flip) | 2 * int(zero_ties)


def _alloc_outputs(dense, payloads, s, k_out):
    out = torch.empty((s, k_out), dtype=dense.dtype, device=dense.device)
    perm = torch.empty((s, k_out), dtype=torch.int32, device=dense.device)
    return out, perm, empty_payloads(payloads, s, k_out)


def segment_class_sort(dense: torch.Tensor, lens: torch.Tensor,
                       payloads: Sequence[torch.Tensor] = (), *,
                       k_out: Optional[int] = None, network: str = "loms",
                       flip: bool = False, want_perm: bool = False,
                       zero_ties: bool = False) -> Result:
    """One size-class sort launch: every row of ``dense`` (S, W), W a
    power of two, sorted on its own, valid prefix first; ``lens`` (S, 1)
    int32; ``zero_ties`` (float rows, ``nan_policy="unsafe"``): -0.0 and
    +0.0 tie. Returns ``(out, perm | None, payload_outs)`` of width
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
                                        want_perm=want_perm, zero_ties=zero_ties)
    lens = lens.to(torch.int32).contiguous()
    cuda_checks("class kernels", (dense, lens) + payloads, dense.dtype, len(payloads))
    prog = program_tensor(dense.device, "sort", network, w)
    out, perm, pouts = _alloc_outputs(dense, payloads, s, k_out)
    if s:
        n, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("segmented").repro_seg_sort(
            dense.data_ptr(), lens.data_ptr(), prog.data_ptr(), out.data_ptr(),
            perm.data_ptr(), n, ins, po, rb, s, w, k_out,
            KEY_CODE[dense.dtype], _mode(flip, zero_ties), sort_prefix(network, w),
            launch.SORT_LANES, stream(dense)), "seg_sort")
        LAUNCHES["seg_sort"] += 1
    return out, (perm if want_perm else None), pouts


def segment_class_merge(dense_a: torch.Tensor, dense_b: torch.Tensor,
                        lens_a: torch.Tensor, lens_b: torch.Tensor,
                        payloads: Sequence[torch.Tensor] = (), *,
                        k_out: Optional[int] = None, network: str = "loms",
                        flip: bool = False, want_perm: bool = False,
                        n_cols: Optional[int] = None, zero_ties: bool = False) -> Result:
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
            network=network, flip=flip, want_perm=want_perm, n_cols=n_cols,
            zero_ties=zero_ties)
    lens_a = lens_a.to(torch.int32).contiguous()
    lens_b = lens_b.to(torch.int32).contiguous()
    cuda_checks("class kernels", (dense_a, dense_b, lens_a, lens_b) + payloads,
                dense_a.dtype, len(payloads))
    out, perm, pouts = _alloc_outputs(dense_a, payloads, s, k_out)
    cols = tile_cols(network, wa, wb, n_cols, False)
    if not rows_fit(wa, wb, dense_a.element_size(), lane_bytes(payloads),
                    launch.MERGE_ROW_THREADS):
        cols = 0  # the row and its payload lanes pass a CTA's shared memory
    if s:
        n, ins, po, rb = payload_args(payloads, pouts)
        if cols:  # a single-level program: the row-merge executor
            check_rc(library("segmented").repro_seg_merge_rows(
                dense_a.data_ptr(), dense_b.data_ptr(), lens_a.data_ptr(),
                lens_b.data_ptr(), out.data_ptr(), perm.data_ptr(), n, ins, po, rb, s, wa,
                wb, cols, launch.MERGE_ROW_THREADS, k_out, KEY_CODE[dense_a.dtype],
                _mode(flip, zero_ties), stream(dense_a)), "seg_merge_rows")
        else:
            prog = program_tensor(dense_a.device, "merge", network, wa, wb,
                                  n_cols if network == "loms" else None)
            check_rc(library("segmented").repro_seg_merge(
                dense_a.data_ptr(), dense_b.data_ptr(), lens_a.data_ptr(),
                lens_b.data_ptr(), prog.data_ptr(), out.data_ptr(), perm.data_ptr(),
                n, ins, po, rb, s, wa, wb, k_out, KEY_CODE[dense_a.dtype],
                _mode(flip, zero_ties), stream(dense_a)), "seg_merge")
        LAUNCHES["seg_merge"] += 1
    return out, (perm if want_perm else None), pouts
