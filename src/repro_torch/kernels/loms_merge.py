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

A CUDA tensor goes to one of three kernels of ``csrc/merge.cu`` by
program and shape, or raises (no route falls back to another):

* a single-level program of at most 16 columns in the key mode (s2ms, the
  loms column device; :func:`tile_cols`) on a row that fits a CTA's
  shared memory with its payload lanes (:func:`rows_fit`):
  ``merge_rows_kernel``, the row-merge executor of ``csrc/merge_rows.cuh``
  (a few threads a row, a warp, or a few warps on wide rows;
  ``launch.MERGE_ROW_THREADS`` forces the threads a row), whose
  decomposition :func:`merge_rows_emulated` runs on the CPU;
* the same program on a longer row: ``merge_tile_kernel``, which cuts the
  column stack into tiles of rows, a CTA each (``launch.MERGE_TILE``
  forces a tile size, and the tiled kernel, on every row such a program
  merges);
* every other program (the pair-stage families, loms past 16 columns)
  and the raw-float mode: ``loms_merge2_kernel`` on the simple executor.

A CPU tensor runs :func:`loms_merge2_plain`, the reference's kernel body
in torch ops.
``use_mxu`` is the reference's raw-float mode (float rows without
``key_dtype``, the values-only wrapper's mode): raw float comparisons and
the rule of the one-hot matrix permute (``common.onehot_permute``) at
every column-device permute.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import builtin_family, merge_program, merge_runs
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


def rows_fit(m: int, n: int, value_bytes: int, lane_bytes: Sequence[int],
             threads: int = 0) -> bool:
    """Whether the row-merge executor (``csrc/merge_rows.cuh``) holds a row
    of m + n lanes in a CTA's shared memory: three int32 words a lane, the
    two raw runs (``value_bytes`` each value) and each payload lane
    (``lane_bytes`` an element), each padded to 16 bytes. A CTA holds a
    warp of rows of ``threads`` threads (0: the fewest its plan gives such
    a row, ``rows_plan``) or more rows within 48 KB."""
    width = m + n
    if not threads:
        threads = 4
        while threads < 256 and width > 16 * threads:
            threads *= 2
    pad16 = lambda b: (b + 15) & ~15  # noqa: E731
    row = (12 * ((width + 3) & ~3) + pad16(m * value_bytes) + pad16(n * value_bytes)
           + sum(pad16(width * b) for b in lane_bytes))
    return max(48 * 1024, max(1, 32 // threads) * row) + 64 <= SMEM_BYTES


def lane_bytes(payloads: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """Bytes of one element of each payload lane (B, L[, F])."""
    return tuple(math.prod(p.shape[2:]) * p.element_size() for p in payloads)


def tile_cols(network: str, m: int, n: int, n_cols: int, use_mxu: bool) -> int:
    """The column count C of the program if the tiled kernel can run it
    (the key mode, a single level of columns: s2ms C = 1, loms C <= 16,
    both runs non-empty, the name holding its built-in family), else 0."""
    if use_mxu or m <= 0 or n <= 0 or not builtin_family(network):
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


def _bitonic(words: torch.Tensor) -> torch.Tensor:
    """``bitonic_sort`` (``csrc/program.cuh``) over the last axis, a power
    of two: step (K, J) pairs word i with i ^ J, the lower word keeping the
    smaller where K is the width or bit K of i is clear."""
    n = words.shape[-1]
    i = torch.arange(n)
    k = 2
    while k <= n:
        up = torch.ones(n, dtype=torch.bool) if k == n else (i & k) == 0
        j = k // 2
        while j:
            other = words[..., i ^ j]
            keep_min = ((i & j) == 0) == up
            words = torch.where(keep_min, torch.minimum(words, other),
                                torch.maximum(words, other))
            j //= 2
        k *= 2
    return words


def column_merges_emulated(keys: torch.Tensor, m: int, cols: int, items: int):
    """``column_merges`` (``csrc/merge_rows.cuh``) on (B, m + n) int64 keys
    in the ascending problem's lane order (lo, then hi): thread u of a row
    makes ``items`` consecutive rows of column u % C by a diagonal search
    under the tie rule (F[f] goes out before S[s - 1 - f] iff F[f] <=
    S[s - 1 - f]) and merge steps. Returns the (B, R, C) stack: keys, and
    the lanes they came from."""
    bsz, L = keys.shape
    n, C = L - m, cols
    R = L // C
    len_f, len_s = (n // C, m // C) if C > 1 else (m, n)
    u = torch.arange(C * -(-R // items))
    c, r0 = u % C, (u // C) * items
    f0 = m + C - 1 - c if C > 1 else torch.zeros_like(u)  # F[i] at lane f0 + C i
    s0 = c if C > 1 else torch.full_like(u, m)

    def at(lane):
        return torch.gather(keys, 1, lane.expand(bsz, -1))

    lo = (r0 - len_s).clamp(min=0).expand(bsz, -1).clone()
    hi = r0.clamp(max=len_f).expand(bsz, -1).clone()
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi) >> 1
        go = at(f0 + C * mid.clamp(0, len_f - 1)) <= at(s0 + C * (r0 - 1 - mid).clamp(0, len_s - 1))
        lo = torch.where(act & go, mid + 1, lo)
        hi = torch.where(act & ~go, mid, hi)
    i_f, i_s = lo, r0 - lo
    stack_k = torch.zeros((bsz, L), dtype=torch.int64)
    stack_e = torch.zeros((bsz, L), dtype=torch.int64)
    for q in range(items):
        live = r0 + q < R
        lf, ls = f0 + C * i_f.clamp(max=len_f - 1), s0 + C * i_s.clamp(max=len_s - 1)
        vf, vs = at(lf), at(ls)
        take_f = (i_f < len_f) & ((i_s >= len_s) | (vf <= vs))
        d = ((r0 + q) * C + c)[live]
        stack_k[:, d] = torch.where(take_f, vf, vs)[:, live]
        stack_e[:, d] = torch.where(take_f, lf, ls)[:, live]
        i_f = torch.where(take_f, i_f + 1, i_f)
        i_s = torch.where(take_f, i_s, i_s + 1)
    return stack_k.view(bsz, R, C), stack_e.view(bsz, R, C)


def row_sorts_emulated(stack_k: torch.Tensor, stack_e: torch.Tensor, narrow: bool):
    """``sort_stack_row``: each stack row's C words packed with the column
    (key << 32 | c; 16-bit keys: 17 key bits << 13 | c, the sentinel
    INT32_MAX above every key), padded to a power of two with the largest
    word, sorted by the network; the lanes read again by column. Returns
    (B, R * C) keys and lanes in output order."""
    bsz, R, C = stack_k.shape
    if C == 1:
        return stack_k.reshape(bsz, R), stack_e.reshape(bsz, R)
    col = torch.arange(C)
    if narrow:
        k17 = torch.where(stack_k == torch.iinfo(torch.int32).max, 65536, stack_k + 32768)
        words, pad, shift = (k17 << 13) | col, 0xFFFFFFFF, 13
    else:
        words, pad, shift = (stack_k << 32) | col, torch.iinfo(torch.int64).max, 32
    s = 1 << (C - 1).bit_length()
    words = _bitonic(torch.cat([words, torch.full((bsz, R, s - C), pad)], -1))[..., :C]
    key = words >> shift
    if narrow:
        key = torch.where(key == 65536, torch.iinfo(torch.int32).max, key - 32768)
    lane = torch.gather(stack_e, -1, words & ((1 << shift) - 1))
    return key.reshape(bsz, R * C), lane.reshape(bsz, R * C)


def row_ranks_emulated(stack_k: torch.Tensor, stack_e: torch.Tensor) -> torch.Tensor:
    """``rank_rows``: each lane's stable rank in its stack row of C counted
    (the keys below it, and the equal ones in the columns before it), its
    lane written to that slot. Returns the (B, R * C) lanes in output
    order."""
    bsz, R, C = stack_k.shape
    col = torch.arange(C)
    k, kk = stack_k[..., :, None], stack_k[..., None, :]
    rank = ((kk < k) | ((kk == k) & (col[None, :] < col[:, None]))).sum(-1)
    lanes = torch.zeros_like(stack_e).scatter_(-1, rank, stack_e)
    return lanes.reshape(bsz, R * C)


def merge_rows_emulated(a: torch.Tensor, b: torch.Tensor,
                        payloads: Sequence[torch.Tensor] = (), *, cols: int,
                        key_dtype: Optional[torch.dtype] = None, descending: bool = False,
                        threads: int = 32) -> Result:
    """``merge_rows_kernel``'s decomposition on the CPU at ``threads``
    threads a row: the runs as keys in the ascending problem's lane order,
    each thread's diagonal search and merge steps
    (:func:`column_merges_emulated`, ceil((m + n) / threads) rows a
    thread), the row sorts of C words
    (:func:`row_sorts_emulated`), positions in the original concat(a, b),
    the output and positions reversed for descending, payloads gathered. For
    the tests; equals :func:`loms_merge2_plain` of the single-level program
    of ``cols`` columns (``perm`` always returned)."""
    m, L = a.shape[1], a.shape[1] + b.shape[1]
    ka = (encode_key_values(a) if key_dtype is not None else a).to(torch.int64)
    kb = (encode_key_values(b) if key_dtype is not None else b).to(torch.int64)
    if descending:
        ka, kb = ka.flip(-1), kb.flip(-1)
    stack_k, stack_e = column_merges_emulated(torch.cat([ka, kb], -1), m, cols,
                                              -(-L // threads))
    key, lane = row_sorts_emulated(stack_k, stack_e,
                                   key_dtype in (torch.bfloat16, torch.float16))
    if descending:
        pos = torch.where(lane < m, m - 1 - lane, m + (L - 1 - lane))
        key, pos = key.flip(-1), pos.flip(-1)
    else:
        pos = lane
    out = key.to(torch.int32)
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    pos = pos.to(torch.int32)
    return out, pos, tuple(gather_lanes(pos, p) for p in payloads)


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
    tiled = (launch.MERGE_TILE > 0 or total * 4 * LANE_WORDS[False] > SMEM_BYTES
             or not rows_fit(m, n, a.element_size(), lane_bytes(payloads),
                             launch.MERGE_ROW_THREADS))
    if bsz and total and cols:
        npay, ins, po, rb = payload_args(payloads, pouts)
        pm = None if perm is None else perm.data_ptr()
        if tiled:
            check_rc(library("merge").repro_merge_tiles(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), pm, npay, ins, po, rb, bsz, m, n,
                cols, launch.MERGE_TILE, KEY_CODE[a.dtype], int(descending), stream(a)),
                "merge_tiles")
        else:
            check_rc(library("merge").repro_merge_rows(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), pm, npay, ins, po, rb, bsz, m, n,
                cols, launch.MERGE_ROW_THREADS, KEY_CODE[a.dtype], int(descending), stream(a)),
                "merge_rows")
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
