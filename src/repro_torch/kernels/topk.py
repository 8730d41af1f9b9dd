"""Blockwise LOMS top-k: CUDA kernels for the card, plain versions beside them.

Counterpart of ``repro.kernels.topk``. Two paths, as in the reference:

* ``router_topk`` — last axis E <= ``ROUTER_TOPK_MAX``: one kernel ranks
  each ``block``-wide group (the N-sorter) and runs the whole tree of
  truncated descending merges.
* ``vocab_topk`` — a large axis (the 151,936-wide vocabulary): the phase-1
  kernel writes a sorted top-min(k, block) list per (row, vocab block);
  then the merge tree merges pairs of lists level by level. The block
  count is rounded up to a power of two, so the tree is the reference's.
  The reference launches once a level; the port's ``vocab_merge_tree``
  merges groups of levels (:func:`vocab_merge_plan`), each CTA an aligned
  subtree of lists in shared memory, and the last CTA of each row the
  rest: one launch at the serving shapes (:func:`tree_launches`).
  :func:`vocab_merge_tree_emulated` runs that decomposition on the CPU for
  the tests.

Both take float32, bfloat16 or float16 and fuse the total-order key
transform (encode on load, decode on store), which is what the reference's
fused rung runs (``key_dtype`` set, ``use_mxu=False``). Indices are int32;
pad slots carry -1.

A CUDA tensor goes to the kernel (``csrc/topk.cu``) or raises; a CPU
tensor runs the plain version. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import (
    decode_key_values,
    encode_key_values,
    key_transformable,
    merge2_sorted,
    sort_nsorter,
)
from . import launch
from .launch import check_rc, library, stream

#: largest last-axis size the single-kernel router path handles
ROUTER_TOPK_MAX = 512
#: longest list of the merge tree (k at most)
MERGE_MAX_LEN = 4096
#: (key, index) pairs a CTA of the merge tree holds in each of its two
#: shared-memory buffers (2 x 64 KiB; ``csrc/topk.cu`` TREE_MAX_SMEM)
TREE_MAX_PAIRS = 8192
#: outputs a thread of the merge tree merges at a time (``TREE_IPT``)
TREE_IPT = 4
#: threads of a CTA of the merge tree (a multiple of 32, at most 1024)
TREE_THREADS = 512
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
    """Levels of the merge tree of one ``vocab_topk`` call."""
    return (vocab_blocks(v, block) - 1).bit_length()


def vocab_merge_plan(lists: int, ln: int, k: int, group: int = 0) -> Tuple[int, ...]:
    """The tree levels each pass of the merge tree runs, for ``lists``
    lists (a power of two) of ``ln``: each pass takes the largest aligned
    subtrees that fit a CTA's shared memory (2^g lists of the pass's list
    length hold at most ``TREE_MAX_PAIRS``), so that the last pass, one
    CTA a row, has the fewest levels left. ``group`` (a power of two)
    forces subtrees of that many lists on every pass but the last."""
    levels = (lists - 1).bit_length()
    if group:
        g = group.bit_length() - 1
        if group < 2 or group != 1 << g:
            raise ValueError(f"a merge-tree group is a power of two >= 2, not {group}")
        plan = (g,) * (levels // g) + ((levels % g,) if levels % g else ())
    else:
        plan, n, left = [], ln, levels
        while left:
            g = 1
            while g < left and n << (g + 1) <= TREE_MAX_PAIRS:
                g += 1
            plan.append(g)
            left -= g
            for _ in range(g):
                n = min(k, 2 * n)
        plan = tuple(plan)
    n = ln
    for g in plan:
        if n << g > TREE_MAX_PAIRS:
            raise ValueError(f"lists of {ln} (k {k}) do not fit the merge tree's shared "
                             f"memory at the plan {plan}")
        for _ in range(g):
            n = min(k, 2 * n)
    return plan


def tree_launches(plan: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """The launches of a plan as (levels a CTA merges, levels the last CTA
    of each row merges after them): the last two passes share a launch."""
    if len(plan) < 2:
        return tuple((g, 0) for g in plan)
    return tuple((g, 0) for g in plan[:-2]) + ((plan[-2], plan[-1]),)


def vocab_merge_launches(v: int, block: int, k: int) -> int:
    """Merge-tree launches of one ``vocab_topk`` call (none for one block)."""
    return len(tree_launches(vocab_merge_plan(vocab_blocks(v, block), min(k, block), k,
                                              launch.VOCAB_GROUP)))


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


def vocab_merge_tree_plain(keys: torch.Tensor, idx: torch.Tensor, k: int,
                           decode_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge tree: ``vocab_merge_level_plain``
    chained, (B, L, len) -> (B, 1, len'), the last level decoded."""
    while keys.shape[1] > 1:
        last = keys.shape[1] == 2
        keys, idx = vocab_merge_level_plain(keys, idx, k, decode_dtype if last else None)
    return keys, idx


def _pack(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(key, index) as the kernel's 64-bit words, key high: their order is
    the tree's (by key, then the higher index first)."""
    return keys.long() * (1 << 32) + (idx.long() & 0xFFFFFFFF)


def _path_level(a: torch.Tensor, b: torch.Tensor, keep: int, ipt: int) -> torch.Tensor:
    """``merge_level`` on (..., ln) words: runs of ``ipt`` outputs, each a
    merge path along its diagonal (a[p] before b[q] only if a[p] > b[q])
    and serial steps."""
    ln = a.shape[-1]
    d = (torch.arange(-(-keep // ipt)) * ipt).expand(a.shape[:-1] + (-1,))

    def at(t, j):
        return torch.gather(t, -1, torch.clamp(j, 0, ln - 1))

    lo, hi = torch.clamp(d - ln, min=0), torch.clamp(d, max=ln)
    for _ in range(ln.bit_length() + 1):
        mid = (lo + hi) // 2
        go = lo < hi
        take = at(a, mid) > at(b, d - 1 - mid)
        lo = torch.where(go & take, mid + 1, lo)
        hi = torch.where(go & ~take, mid, hi)
    ia, ib = lo, d - lo
    out = a.new_zeros(a.shape[:-1] + (d.shape[-1] * ipt,))
    for j in range(ipt):
        ta = (ia < ln) & ((ib >= ln) | (at(a, ia) > at(b, ib)))
        out[..., j::ipt] = torch.where(ta, at(a, ia), at(b, ib))
        ia, ib = ia + ta.long(), ib + (~ta).long()
    return out[..., :keep]


def _warp_level(a: torch.Tensor, b: torch.Tensor, keep: int) -> torch.Tensor:
    """``warp_level`` on (..., ln) words, keep = ln or 2 ln: the bitonic
    sequence of a and b reversed (their word-wise maxima when keep = ln),
    then the merge network's compare-exchanges, stride keep/2 down to 1,
    the larger word to the lower slot."""
    v = (torch.maximum(a, b.flip(-1)) if keep == a.shape[-1]
         else torch.cat([a, b.flip(-1)], -1))
    s = keep // 2
    while s:
        w = v.reshape(v.shape[:-1] + (keep // (2 * s), 2, s))
        v = torch.stack([torch.maximum(w[..., 0, :], w[..., 1, :]),
                         torch.minimum(w[..., 0, :], w[..., 1, :])], -2).reshape(v.shape)
        s //= 2
    return v


def vocab_merge_tree_emulated(keys: torch.Tensor, idx: torch.Tensor, k: int,
                              decode_dtype=None, *, group: int = 0,
                              threads: int = TREE_THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA merge tree's decomposition on the CPU: each pass of the plan
    takes aligned subtrees of lists, and each level merges pairs of the
    packed (key, index) words: in registers where the lengths allow (the
    bitonic network of ``warp_level``: keep of 32 to 256, ln = keep or
    keep / 2, powers of two), else by runs of ``ipt`` outputs (sized, as
    the kernel does, so that a CTA of ``threads`` covers its pairs in about
    one pass), each a merge path along its diagonal and serial steps. For
    the tests; equals :func:`vocab_merge_tree_plain`."""
    bsz, lists, ln = keys.shape
    words = _pack(keys, idx)
    for g in vocab_merge_plan(lists, ln, k, group):
        for lvl in range(g):  # a pass's subtrees are the tree's aligned pairs
            keep = min(k, 2 * ln)
            a, b = words[:, 0::2], words[:, 1::2]
            if ln & (ln - 1) == 0 and keep in (ln, 2 * ln) and keep in (32, 64, 128, 256):
                words = _warp_level(a, b, keep)
            else:
                pairs_cta = 1 << (g - lvl - 1)
                ipt = 1
                while ipt < TREE_IPT and pairs_cta * keep > ipt * threads:
                    ipt *= 2
                words = _path_level(a, b, keep, ipt)
            ln = keep
    keys, idx = (words >> 32).to(torch.int32), (words & 0xFFFFFFFF).to(torch.int32)
    if decode_dtype is not None:
        keys = decode_key_values(keys, decode_dtype)
    return keys, idx


def vocab_topk_plain(x: torch.Tensor, k: int, block: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole vocab path (phase 1 + merge levels)."""
    vs, is_ = vocab_phase1_plain(x, k, block)
    vs, is_ = vocab_merge_tree_plain(vs, is_, k, x.dtype)
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


#: per device, the per-row tickets of the merge tree's last CTA (the
#: newest last): zero between launches, as each launch leaves them; never
#: freed, so that a CUDA graph that captured one keeps it
_TICKETS: Dict[str, List[torch.Tensor]] = {}


def _tickets(device, rows: int) -> torch.Tensor:
    kept = _TICKETS.setdefault(str(device), [])
    if not kept or kept[-1].numel() < rows:
        kept.append(torch.zeros(max(rows, 1024), dtype=torch.int32, device=device))
    return kept[-1]


def vocab_merge_tree_launch(keys: torch.Tensor, idx: torch.Tensor, k: int, levels: int,
                            tail_levels: int = 0, decode_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``vocab_merge_tree_kernel``: subtrees of 2^levels lists,
    then (``tail_levels`` > 0) the rest of each row's tree by its last CTA.
    (B, L, len) -> (B, L >> (levels + tail_levels), len'). Counts a launch."""
    bsz, lists, ln = keys.shape
    mid = ln
    for _ in range(levels):
        mid = min(k, 2 * mid)
    out_len = mid
    for _ in range(tail_levels):
        out_len = min(k, 2 * out_len)
    groups = bsz * (lists >> levels)
    shape = (bsz, lists >> (levels + tail_levels), out_len)
    oidx = torch.empty(shape, dtype=torch.int32, device=keys.device)
    out = torch.empty(shape, dtype=decode_dtype or torch.int32, device=keys.device)
    skey = sidx = tickets = None
    if tail_levels:
        skey = torch.empty(groups * mid, dtype=torch.int32, device=keys.device)
        sidx = torch.empty_like(skey)
        tickets = _tickets(keys.device, groups >> tail_levels)
    if groups:
        check_rc(library("topk").repro_vocab_merge_tree(
            keys.data_ptr(), idx.data_ptr(), out.data_ptr(), out.data_ptr(),
            oidx.data_ptr(), *(None if t is None else t.data_ptr()
                               for t in (skey, sidx, tickets)),
            groups, ln, k, levels, tail_levels, int(decode_dtype is not None),
            TREE_THREADS, _DTYPE_CODE.get(decode_dtype, 0), stream(keys)),
            "vocab_merge_tree")
        LAUNCHES["vocab_merge_level"] += 1
    return out, oidx


def vocab_merge_tree(keys: torch.Tensor, idx: torch.Tensor, k: int,
                     decode_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vocab merge tree (replaces the launches of ``_merge_level_kernel``,
    one a level): int32 keys and indices (B, L, len), L a power of two ->
    (B, 1, len'), each level keeping min(k, 2 len), decoded to
    ``decode_dtype`` when it is given. The launches of
    :func:`tree_launches` of :func:`vocab_merge_plan`: one at the serving
    shapes. The last CTA of a row is found by tickets kept per device, so
    two trees must not run at once on two streams of one card."""
    if decode_dtype is not None and not key_transformable(decode_dtype):
        raise TypeError(f"cannot decode keys to {decode_dtype}")
    if keys.device.type == "cpu":
        return vocab_merge_tree_plain(keys, idx, k, decode_dtype)
    if keys.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {keys.device}")
    if (keys.dtype != torch.int32 or idx.dtype != torch.int32 or keys.ndim != 3
            or keys.shape != idx.shape or keys.shape[1] & (keys.shape[1] - 1)):
        raise ValueError("the merge tree takes int32 keys and indices of one shape "
                         "(B, L, len), L a power of two")
    if not (keys.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the CUDA top-k kernels take contiguous tensors")
    if keys.shape[2] > MERGE_MAX_LEN:
        raise ValueError(f"merge lists of {keys.shape[2]} exceed {MERGE_MAX_LEN}")
    steps = tree_launches(vocab_merge_plan(keys.shape[1], keys.shape[2], k,
                                           launch.VOCAB_GROUP))
    for n, (levels, tail) in enumerate(steps):
        keys, idx = vocab_merge_tree_launch(keys, idx, k, levels, tail,
                                            decode_dtype if n == len(steps) - 1 else None)
    return keys, idx


def vocab_topk(x: torch.Tensor, k: int, *, block: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over a large last axis (B, V); V need not be a
    block multiple. Replaces ``vocab_topk_pallas``
    (``src/repro/kernels/topk.py:155``): one phase-1 launch, then the
    merge tree (:func:`vocab_merge_launches` launches). As in the
    reference, k may exceed V: the slots past the real candidates are
    pads."""
    vs, is_ = vocab_phase1(x, k, block)
    if vs.shape[1] > 1:
        vs, is_ = vocab_merge_tree(vs, is_, k, x.dtype)
    return vs[:, 0, :k], is_[:, 0, :k]
