"""The fused single-launch sort (kernel row 2).

Counterpart of ``repro.kernels.sort``: :func:`loms_sort` replaces
``loms_sort_pallas`` (``_sort_kernel``, ``src/repro/kernels/sort.py:57``).
Every row of ``x`` (B, n) is sorted by the family's merge tree:

  floats: the total-order int32 key (``key_dtype``) -> pad to
  ``ceil_pow2(n)`` with the key type's maximum -> the ``sort_program``
  levels, carrying a position lane -> with a position lane: stable
  valid-first compaction by ``pos < n`` -> the first n keys decoded ->
  descending: output and positions reversed (so tied values come out in
  descending position: a reversal, not the class sort's ``~key``) ->
  payload lanes (B, n[, F]) gathered at the positions.

``use_mxu`` is the reference's raw-float mode (float rows without
``key_dtype``, the values-only wrapper's mode): the levels compare the
raw floats (NaN compares false, -0.0 ties +0.0), pads are the dtype's
finite maximum, and every column-device permute follows the rule of the
reference's one-hot matrix permute (``common.onehot_permute``).

A CUDA tensor goes to ``loms_sort_kernel`` (``csrc/sort.cu``) or raises;
a CPU tensor runs :func:`loms_sort_plain`, the reference's kernel body in
torch ops.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.networks import run_sort_program, sort_program
from .common import (canonical_nan, ceil_pow2, check_mode, decode_key_values,
                     encode_key_values, gather_lanes, sentinel_max, stable_compact)
from . import launch
from .launch import (KEY_CODE, check_rc, cuda_checks, empty_payloads, library,
                     payload_args, program_tensor, sort_prefix, stream)
from .topk import LAUNCHES

Result = Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]

#: widest padded row the CUDA kernel holds in shared memory (128 KB)
MAX_WIDTH = 8192


def loms_sort_plain(x: torch.Tensor, payloads: Sequence[torch.Tensor] = (), *,
                    network: str = "loms", key_dtype: Optional[torch.dtype] = None,
                    descending: bool = False, want_perm: bool = False,
                    use_mxu: bool = False) -> Result:
    """Plain version of ``_sort_kernel`` (``sort.py:57``)."""
    bsz, n = x.shape
    keys = encode_key_values(x) if key_dtype is not None else x
    npad = ceil_pow2(n)
    if npad != n:
        keys = torch.cat([keys, keys.new_full((bsz, npad - n), sentinel_max(keys.dtype))],
                         dim=1)
    need_pos = bool(payloads) or want_perm
    pos = (torch.arange(npad, dtype=torch.int32, device=x.device).expand(bsz, npad)
           if need_pos else None)
    keys, pos = run_sort_program(sort_program(network, npad), keys, pos, use_mxu)
    if need_pos and npad != n:
        # the column devices make no cross-run tie promise, so a pad that
        # ties a genuine maximum may sit in the live prefix: the mask decides
        keys, pos = stable_compact(pos < n, keys, pos)
    out = keys[:, :n]
    perm = pos[:, :n] if need_pos else None
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    if descending:
        out = out.flip(-1)
        perm = None if perm is None else perm.flip(-1)
    if use_mxu:  # the kernel's NaN (torch's CPU ops rewrite bf16 NaN bits)
        out = canonical_nan(out)
    pouts = tuple(gather_lanes(perm, p) for p in payloads)
    return out, (perm if want_perm else None), pouts


def loms_sort(x: torch.Tensor, payloads: Sequence[torch.Tensor] = (), *,
              network: str = "loms", key_dtype: Optional[torch.dtype] = None,
              descending: bool = False, want_perm: bool = False,
              use_mxu: bool = False) -> Result:
    """Sort every row of ``x`` (B, n) in one launch.

    ``network`` names a registered family (its sort tree runs at
    ``ceil_pow2(n)``). ``key_dtype`` (the rows' float dtype) sorts floats
    as their total-order keys (NaN last, -0.0 below +0.0) and decodes on
    store; int32 rows are keys already. ``use_mxu`` (float rows without
    ``key_dtype``): the reference's raw-float mode. ``payloads``: (B,
    n[, F]) lanes returned permuted. Returns ``(out, perm | None,
    payload_outs)``; ``perm`` holds input positions."""
    payloads = tuple(payloads)
    if x.ndim != 2:
        raise ValueError(f"sort takes (B, n), got {tuple(x.shape)}")
    bsz, n = x.shape
    check_mode(x.dtype, key_dtype, use_mxu, len(payloads))
    for p in payloads:
        if p.ndim not in (2, 3) or p.shape[:2] != (bsz, n):
            raise ValueError(f"payload lane of shape {tuple(p.shape)} does not "
                             f"match ({bsz}, {n}[, F])")
    if x.device.type == "cpu":
        return loms_sort_plain(x, payloads, network=network, key_dtype=key_dtype,
                               descending=descending, want_perm=want_perm,
                               use_mxu=use_mxu)
    width = ceil_pow2(n)
    if width > MAX_WIDTH:
        raise ValueError(f"the CUDA sort takes rows up to {MAX_WIDTH}, got {n}")
    cuda_checks("sort kernel", (x,) + payloads, x.dtype, len(payloads))
    out = torch.empty_like(x)
    perm = torch.empty((bsz, n), dtype=torch.int32, device=x.device) if want_perm else None
    pouts = empty_payloads(payloads, bsz, n)
    if bsz and n:
        prog = program_tensor(x.device, "sort", network, width)
        npay, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("sort").repro_loms_sort(
            x.data_ptr(), prog.data_ptr(), out.data_ptr(),
            None if perm is None else perm.data_ptr(), npay, ins, po, rb, bsz, n,
            width, sort_prefix(network, width), KEY_CODE[x.dtype], int(use_mxu),
            int(descending), launch.SORT_LANES, stream(x)), "loms_sort")
        LAUNCHES["loms_sort"] += 1
    return out, perm, pouts
