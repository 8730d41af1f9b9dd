"""Blockwise LOMS top-k: CUDA kernels for the card, plain versions beside them.

Counterpart of ``repro.kernels.topk``. Two paths, as in the reference:

* ``router_topk`` — last axis E <= ``ROUTER_TOPK_MAX``: one kernel ranks
  each ``block``-wide group (the N-sorter) and runs the whole tree of
  truncated descending merges.
* ``vocab_topk`` — a large axis (the 151,936-wide vocabulary): the phase-1
  kernel writes a sorted top-min(k, block) list per (row, vocab block);
  then one merge-level launch per tree level merges pairs of lists. The
  block count is rounded up to a power of two, so the tree is the
  reference's.

Both take float32, bfloat16 or float16 and fuse the total-order key
transform (encode on load, decode on store), which is what the reference's
fused rung runs (``key_dtype`` set, ``use_mxu=False``). Indices are int32;
pad slots carry -1.

A CUDA tensor goes to the kernel (``csrc/topk.cu``) or raises; a CPU
tensor runs the plain version. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import (
    decode_key_values,
    encode_key_values,
    key_transformable,
    merge2_sorted,
    sort_nsorter,
)
from .launch import check_rc, library, stream

#: largest last-axis size the single-kernel router path handles
ROUTER_TOPK_MAX = 512
#: widest list a merge level stages in shared memory (32 KiB of keys)
MERGE_MAX_LEN = 4096
#: widest phase-1 block (one thread per slot)
PHASE1_MAX_BLOCK = 1024

_KEY_PAD = torch.iinfo(torch.int32).min
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches per kernel (the kernels of ``segmented.py``,
#: ``loms_merge.py``, ``sort.py``, ``kway.py`` and ``streaming/grid_merge.py``
#: count here too); incremented only where a kernel launches
LAUNCHES: Dict[str, int] = {"router_topk": 0, "vocab_phase1": 0,
                            "vocab_merge_level": 0, "seg_sort": 0,
                            "seg_merge": 0, "loms_merge2": 0, "loms_sort": 0,
                            "grid_merge2": 0, "kway_merge": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan_block(n: int, k: int) -> int:
    """The reference planner's heuristic block (``plan_topk``,
    ``streaming/planner.py:258``): about the next power of two >= k,
    clamped to [16, 128] and to n, halved while it leaves a remainder."""
    block = int(min(max(16, 1 << max(k - 1, 1).bit_length()), 128, n))
    while n % block and block > 16:
        block //= 2
    return block


def topk_tiles(bsz: int, e: int, *, block: int = 0,
               block_batch: int = 8) -> Tuple[int, int]:
    """Resolve the (block, block_batch) tile pair for the top-k kernels
    (copied from ``repro.kernels.ops.topk_tiles``): block_batch halves
    until it divides the batch, and the router block shrinks until it
    divides the axis. The CUDA kernels do not tile the batch; the block
    fixes the merge tree and so is kept."""
    bb = max(block_batch, 1)
    while bsz % bb:
        bb //= 2
    bb = max(bb, 1)
    if e <= ROUTER_TOPK_MAX:
        blk = block or max(16, min(64, e))
        while e % blk:
            blk -= 1
    else:
        blk = block or 128
    return blk, bb


def vocab_blocks(v: int, block: int) -> int:
    """Vocab block count, rounded up to a power of two (``topk.py:171``)."""
    nblk = -(-v // block)
    return 1 << (nblk - 1).bit_length()


def vocab_levels(v: int, block: int) -> int:
    """Merge-level launches of one ``vocab_topk`` call."""
    return (vocab_blocks(v, block) - 1).bit_length()


# ---------------------------------------------------------------------------
# plain versions (the reference's kernel bodies, written in torch ops)
# ---------------------------------------------------------------------------


def _merge_desc(av, ai, bv, bi, keep):
    """Merge two descending lists, keep the top ``keep`` (descending)."""
    mv, mi = merge2_sorted(av.flip(-1), bv.flip(-1),
                           payload=(ai.flip(-1), bi.flip(-1)))
    return mv.flip(-1)[..., :keep], mi.flip(-1)[..., :keep]


def router_topk_plain(x: torch.Tensor, k: int, block: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``router_topk_kernel`` (``topk.py:60``)."""
    keys = encode_key_values(x)
    t, e = keys.shape
    g = e // block
    idx = torch.arange(e, dtype=torch.int32, device=x.device).expand(t, e)
    kk = min(k, block)
    vs, is_ = sort_nsorter(keys.reshape(t, g, block), idx.reshape(t, g, block))
    vs, is_ = vs.flip(-1)[..., :kk], is_.flip(-1)[..., :kk]
    while vs.shape[-2] > 1:
        if vs.shape[-2] % 2:
            vs = torch.cat([vs, torch.full_like(vs[..., :1, :], _KEY_PAD)], dim=-2)
            is_ = torch.cat([is_, torch.full_like(is_[..., :1, :], -1)], dim=-2)
        kk = min(k, 2 * kk)
        vs, is_ = _merge_desc(vs[..., 0::2, :], is_[..., 0::2, :],
                              vs[..., 1::2, :], is_[..., 1::2, :], kk)
    return decode_key_values(vs[..., 0, :k], x.dtype), is_[..., 0, :k]


def vocab_phase1_plain(x: torch.Tensor, k: int, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``vocab_phase1_kernel`` (``topk.py:122``): (B, V)
    -> int32 keys and indices (B, nblk, min(k, block)); with a single
    block the keys come back decoded, as the reference's do."""
    bsz, v = x.shape
    nblk = vocab_blocks(v, block)
    vp = nblk * block
    keys = encode_key_values(x)
    keys = torch.cat([keys, keys.new_full((bsz, vp - v), _KEY_PAD)], dim=-1)
    idx = torch.arange(vp, dtype=torch.int32, device=x.device)
    idx = torch.where(idx < v, idx, -1).expand(bsz, vp)
    kk = min(k, block)
    vs, is_ = sort_nsorter(keys.reshape(bsz, nblk, block),
                           idx.reshape(bsz, nblk, block))
    vs, is_ = vs.flip(-1)[..., :kk], is_.flip(-1)[..., :kk]
    if nblk == 1:
        vs = decode_key_values(vs, x.dtype)
    return vs, is_


def vocab_merge_level_plain(keys: torch.Tensor, idx: torch.Tensor, k: int,
                            decode_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one ``vocab_merge_level_kernel`` launch
    (``topk.py:142``): (B, 2g, len) -> (B, g, min(k, 2 len))."""
    keep = min(k, 2 * keys.shape[-1])
    vs, is_ = _merge_desc(keys[:, 0::2], idx[:, 0::2], keys[:, 1::2],
                          idx[:, 1::2], keep)
    if decode_dtype is not None:
        vs = decode_key_values(vs, decode_dtype)
    return vs, is_


def vocab_topk_plain(x: torch.Tensor, k: int, block: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole vocab path (phase 1 + merge levels)."""
    vs, is_ = vocab_phase1_plain(x, k, block)
    while vs.shape[1] > 1:
        last = vs.shape[1] == 2
        vs, is_ = vocab_merge_level_plain(vs, is_, k, x.dtype if last else None)
    return vs[:, 0, :k], is_[:, 0, :k]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor, k: int, k_max: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"top-k takes a 2-D (rows, axis) tensor, got {tuple(x.shape)}")
    if not key_transformable(x.dtype):
        raise TypeError(f"top-k takes float32, bfloat16 or float16, not {x.dtype}")
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} out of range [1, {k_max}]")


def _check_cuda(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError("the CUDA top-k kernels take a contiguous tensor")
    if x.shape[0] * x.shape[1] >= 2 ** 31:
        raise ValueError(f"tensor of shape {tuple(x.shape)} is too large")


def router_topk(x: torch.Tensor, k: int, *, block: int = 32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over the last axis of (T, E), E <= 512, E % block == 0.

    Replaces ``router_topk_pallas`` (``src/repro/kernels/topk.py:88``)."""
    _check_input(x, k, x.shape[-1])
    t, e = x.shape
    if e > ROUTER_TOPK_MAX or e % block:
        raise ValueError(f"router top-k needs E <= {ROUTER_TOPK_MAX} and "
                         f"E % block == 0 (E={e}, block={block})")
    if x.device.type == "cpu":
        return router_topk_plain(x, k, block)
    if x.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {x.device}")
    _check_cuda(x)
    v = torch.empty((t, k), dtype=x.dtype, device=x.device)
    i = torch.empty((t, k), dtype=torch.int32, device=x.device)
    if t:
        check_rc(library("topk").repro_router_topk(
            x.data_ptr(), v.data_ptr(), i.data_ptr(), t, e, k, block,
            _DTYPE_CODE[x.dtype], stream(x)), "router_topk")
        LAUNCHES["router_topk"] += 1
    return v, i


def vocab_phase1(x: torch.Tensor, k: int, block: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the vocab top-k (replaces ``_phase1_kernel``): (B, V) ->
    int32 keys and indices (B, nblk, min(k, block)), nblk a power of two;
    with a single block the values come back decoded."""
    _check_input(x, k, MERGE_MAX_LEN)
    if x.device.type == "cpu":
        return vocab_phase1_plain(x, k, block)
    if x.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {x.device}")
    _check_cuda(x)
    if not 1 <= block <= PHASE1_MAX_BLOCK:
        raise ValueError(f"vocab top-k needs block <= {PHASE1_MAX_BLOCK}, not {block}")
    bsz, v = x.shape
    nblk, kk = vocab_blocks(v, block), min(k, block)
    single = nblk == 1
    idx = torch.empty((bsz, nblk, kk), dtype=torch.int32, device=x.device)
    out = torch.empty((bsz, nblk, kk), dtype=x.dtype if single else torch.int32,
                      device=x.device)
    if bsz:
        check_rc(library("topk").repro_vocab_phase1(
            x.data_ptr(), out.data_ptr(), out.data_ptr(), idx.data_ptr(), bsz, v,
            nblk, block, kk, int(single), _DTYPE_CODE[x.dtype], stream(x)),
            "vocab_phase1")
        LAUNCHES["vocab_phase1"] += 1
    return out, idx


def vocab_merge_level(keys: torch.Tensor, idx: torch.Tensor, k: int,
                      decode_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of the vocab merge tree (replaces ``_merge_level_kernel``):
    int32 keys and indices (B, 2g, len) -> (B, g, min(k, 2 len)), decoded
    to ``decode_dtype`` when it is given (the last level)."""
    if decode_dtype is not None and not key_transformable(decode_dtype):
        raise TypeError(f"cannot decode keys to {decode_dtype}")
    if keys.device.type == "cpu":
        return vocab_merge_level_plain(keys, idx, k, decode_dtype)
    if keys.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {keys.device}")
    if (keys.dtype != torch.int32 or idx.dtype != torch.int32 or keys.ndim != 3
            or keys.shape != idx.shape or keys.shape[1] % 2):
        raise ValueError("a merge level takes int32 keys and indices of one "
                         "shape (B, 2g, len)")
    if not (keys.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the CUDA top-k kernels take contiguous tensors")
    bsz, g, ln = keys.shape[0], keys.shape[1] // 2, keys.shape[2]
    if ln > MERGE_MAX_LEN:
        raise ValueError(f"merge lists of {ln} exceed {MERGE_MAX_LEN}")
    keep = min(k, 2 * ln)
    dev = keys.device
    oidx = torch.empty((bsz, g, keep), dtype=torch.int32, device=dev)
    out = torch.empty((bsz, g, keep), dtype=decode_dtype or torch.int32, device=dev)
    if bsz * g:
        check_rc(library("topk").repro_vocab_merge_level(
            keys.data_ptr(), idx.data_ptr(), out.data_ptr(), out.data_ptr(),
            oidx.data_ptr(), bsz * g, ln, keep, int(decode_dtype is not None),
            _DTYPE_CODE.get(decode_dtype, 0), stream(keys)), "vocab_merge_level")
        LAUNCHES["vocab_merge_level"] += 1
    return out, oidx


def vocab_topk(x: torch.Tensor, k: int, *, block: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over a large last axis (B, V); V need not be a
    block multiple. Replaces ``vocab_topk_pallas``
    (``src/repro/kernels/topk.py:155``): one phase-1 launch, then one
    merge-level launch per tree level. As in the reference, k may exceed
    V: the slots past the real candidates are pads."""
    vs, is_ = vocab_phase1(x, k, block)
    while vs.shape[1] > 1:
        last = vs.shape[1] == 2
        vs, is_ = vocab_merge_level(vs, is_, k, x.dtype if last else None)
    return vs[:, 0, :k], is_[:, 0, :k]
