"""The batched 2-way List Offset merge (kernel row 1).

Counterpart of ``repro.kernels.loms_merge``: :func:`loms_merge2` replaces
``loms_merge2_pallas`` (``_loms2_kernel``, ``src/repro/kernels/
loms_merge.py:49``). It merges the sorted rows ``a`` (B, m) and ``b``
(B, n) into (B, m + n) by ``merge_program(network, m, n, n_cols)``:

  descending: both rows reversed on load -> floats: the total-order int32
  key (``key_dtype``) -> a position lane indexing the original orientation
  of ``concat(a, b)`` -> the merge program -> keys decoded on store ->
  descending: output and positions reversed -> payload lanes
  (B, m + n[, F]) gathered at the positions.

A CUDA tensor goes to ``loms_merge2_kernel`` (``csrc/merge.cu``) or
raises; in the key mode, a single-level program of at most 16 columns
(s2ms, the loms column device) whose row passes a CTA's shared memory
goes to ``merge_tile_kernel`` instead, which cuts the column stack into
tiles of rows, a CTA each (``launch.MERGE_TILE`` forces a tile size, and
the tiled kernel, on every row such a program merges). A CPU tensor runs
:func:`loms_merge2_plain`, the reference's kernel body in torch ops.
``use_mxu`` is the reference's raw-float mode (float rows without
``key_dtype``, the values-only wrapper's mode): raw float comparisons and
the rule of the one-hot matrix permute (``common.onehot_permute``) at
every column-device permute.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import merge_program, merge_runs
from .common import (canonical_nan, check_mode, decode_key_values, encode_key_values,
                     gather_lanes)
from . import launch
from .launch import (KEY_CODE, check_rc, cuda_checks, empty_payloads, library,
                     payload_args, program_tensor, stream)
from .topk import LAUNCHES

Result = Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]

#: words a lane of the merge kernel holds (keys, positions and their
#: second buffers; the raw-float mode also its landed-bad counts and
#: vector flags)
LANE_WORDS = {False: 4, True: 6}
#: shared memory a CTA may opt in to; a longer row runs in global scratch
SMEM_BYTES = 232_448
#: CTAs that walk over the rows in the global-scratch case (two an SM)
SCRATCH_CTAS_PER_SM = 2
#: widest column device of the tiled kernel (a row of C sorted in registers)
TILE_MAX_COLS = 16


def tile_cols(network: str, m: int, n: int, n_cols: int, use_mxu: bool) -> int:
    """The column count C of the program if the tiled kernel can run it
    (the key mode, a single level of columns: s2ms C = 1, loms C <= 16,
    both runs non-empty), else 0."""
    if use_mxu or m <= 0 or n <= 0:
        return 0
    if network == "s2ms":
        return 1
    if network == "loms" and n_cols <= TILE_MAX_COLS:
        return n_cols
    return 0


def _check(a, b, payloads, network, n_cols, key_dtype, use_mxu):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"merge2 takes (B, m) and (B, n), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"the two rows need one dtype, got {a.dtype}, {b.dtype}")
    bsz, m = a.shape
    n = b.shape[1]
    if network == "loms" and (m % n_cols or n % n_cols):
        raise ValueError(f"n_cols={n_cols} must divide both runs ({m}, {n})")
    check_mode(a.dtype, key_dtype, use_mxu, len(payloads))
    for p in payloads:
        if p.ndim not in (2, 3) or p.shape[:2] != (bsz, m + n):
            raise ValueError(f"payload lane of shape {tuple(p.shape)} does not "
                             f"match ({bsz}, {m + n}[, F])")


def loms_merge2_plain(a: torch.Tensor, b: torch.Tensor,
                      payloads: Sequence[torch.Tensor] = (), *, network: str = "loms",
                      n_cols: int = 2, key_dtype: Optional[torch.dtype] = None,
                      descending: bool = False, want_perm: bool = False,
                      use_mxu: bool = False) -> Result:
    """Plain version of ``_loms2_kernel`` (``loms_merge.py:49``)."""
    bsz, m = a.shape
    n = b.shape[1]
    if descending:  # the merge itself is ascending
        a, b = a.flip(-1), b.flip(-1)
    if key_dtype is not None:
        a, b = encode_key_values(a), encode_key_values(b)
    ia = torch.arange(m, dtype=torch.int32, device=a.device)
    ib = torch.arange(n, dtype=torch.int32, device=a.device)
    if descending:  # positions index the original orientation of concat(a, b)
        ia, ib = ia.flip(0), ib.flip(0)
    pa, pb = ia.expand(bsz, m), (ib + m).expand(bsz, n)
    prog = merge_program(network, m, n, n_cols if network == "loms" else None)
    out, perm = merge_runs(prog, a, b, payload=(pa, pb), use_mxu=use_mxu)
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    if descending:
        out, perm = out.flip(-1), perm.flip(-1)
    if use_mxu:  # the kernel's NaN (torch's CPU ops rewrite bf16 NaN bits)
        out = canonical_nan(out)
    pouts = tuple(gather_lanes(perm, p) for p in payloads)
    return out, (perm if want_perm else None), pouts


def loms_merge2(a: torch.Tensor, b: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                *, network: str = "loms", n_cols: int = 2,
                key_dtype: Optional[torch.dtype] = None, descending: bool = False,
                want_perm: bool = False, use_mxu: bool = False) -> Result:
    """Merge the sorted rows ``a`` (B, m) and ``b`` (B, n) -> (B, m + n).

    ``network`` names a registered family; for loms ``n_cols`` must divide
    m and n. ``key_dtype`` (the rows' float dtype) merges floats as their
    total-order keys (NaN last, -0.0 below +0.0) and decodes on store;
    int32 rows are keys already. ``use_mxu`` (float rows without
    ``key_dtype``): the reference's raw-float mode. ``descending``: the
    rows, and the output,
    are descending. ``payloads``: (B, m + n[, F]) lanes, the two lists'
    payloads concatenated, returned permuted. Returns ``(out, perm | None,
    payload_outs)``; ``perm`` holds positions in ``concat(a, b)``."""
    payloads = tuple(payloads)
    _check(a, b, payloads, network, n_cols, key_dtype, use_mxu)
    if a.device.type == "cpu":
        return loms_merge2_plain(a, b, payloads, network=network, n_cols=n_cols,
                                 key_dtype=key_dtype, descending=descending,
                                 want_perm=want_perm, use_mxu=use_mxu)
    cuda_checks("merge kernel", (a, b) + payloads, a.dtype, len(payloads))
    bsz, m = a.shape
    n = b.shape[1]
    total = m + n
    out = torch.empty((bsz, total), dtype=a.dtype, device=a.device)
    perm = (torch.empty((bsz, total), dtype=torch.int32, device=a.device)
            if want_perm else None)
    pouts = empty_payloads(payloads, bsz, total)
    cols = tile_cols(network, m, n, n_cols, use_mxu)
    if bsz and total and cols and (launch.MERGE_TILE > 0
                                   or total * 4 * LANE_WORDS[False] > SMEM_BYTES):
        npay, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("merge").repro_merge_tiles(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if perm is None else perm.data_ptr(), npay, ins, po, rb, bsz, m, n, cols,
            launch.MERGE_TILE, KEY_CODE[a.dtype], int(descending), stream(a)), "merge_tiles")
        LAUNCHES["loms_merge2"] += 1
    elif bsz and total:
        prog = program_tensor(a.device, "merge", network, m, n,
                              n_cols if network == "loms" else None)
        scratch, ctas = None, 0
        words = LANE_WORDS[use_mxu]
        if total * 4 * words > SMEM_BYTES:
            sms = torch.cuda.get_device_properties(a.device).multi_processor_count
            ctas = min(bsz, SCRATCH_CTAS_PER_SM * sms)
            scratch = torch.empty(ctas * words * total, dtype=torch.int32, device=a.device)
        npay, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("merge").repro_loms_merge2(
            a.data_ptr(), b.data_ptr(), prog.data_ptr(), out.data_ptr(),
            None if perm is None else perm.data_ptr(), npay, ins, po, rb,
            None if scratch is None else scratch.data_ptr(), ctas, bsz, m, n,
            KEY_CODE[a.dtype], int(use_mxu), int(descending), stream(a)), "loms_merge2")
        LAUNCHES["loms_merge2"] += 1
    return out, perm, pouts
