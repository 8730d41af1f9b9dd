"""Blockwise LOMS top-k: CUDA kernels for the card, plain versions beside them.

Counterpart of ``repro.kernels.topk``. Two paths, as in the reference:

* ``router_topk`` — last axis E <= ``ROUTER_TOPK_MAX``: one kernel sorts
  each ``block``-wide group and runs the whole tree of truncated
  descending merges, several rows a CTA.
* ``vocab_topk`` — a large axis (the 151,936-wide vocabulary): the phase-1
  kernel writes a sorted top-min(k, block) list per (row, vocab block);
  then the merge tree merges pairs of lists level by level. The block
  count is rounded up to a power of two, so the tree is the reference's.
  The reference launches once a level; the port's ``vocab_merge_tree``
  merges groups of levels (:func:`vocab_merge_plan`), each CTA an aligned
  subtree of lists in shared memory, and the last CTA of each row the
  rest: one launch at the serving shapes (:func:`tree_launches`).

Both kernels sort a block as one bitonic network over unique packed
words (key high, the slot's position low; :func:`_block_words`), padded
to a power of two; phase 1 fills its padding blocks without sorting them.
:func:`vocab_phase1_emulated`, :func:`router_topk_emulated` and
:func:`vocab_merge_tree_emulated` run the kernels' decompositions on the
CPU for the tests.

Both take float32, bfloat16 or float16 and fuse the total-order key
transform (encode on load, decode on store), which is what the reference's
fused rung runs (``key_dtype`` set, ``use_mxu=False``); and int32, whose
values are the keys, as the reference's fused rung runs integers
(``key_dtype=None``, ``use_mxu=False``): a pad (``INT32_MIN``) then ties
a genuine ``INT32_MIN``, and comes first among those, as a slot past the
row's end. Indices are int32; pad slots carry -1.

``zero_ties`` (``nan_policy="unsafe"``, where the reference compares raw
floats and permutes them by its one-hot matrix product): -0.0 takes
+0.0's key, so the two tie, and a zero comes out as that permute puts it
out (:func:`signed_zero_rule`).

A CUDA tensor goes to the kernel (``csrc/topk.cu``) or raises; a CPU
tensor runs the plain version. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .common import (
    SIGNED_ZERO_LANES,
    decode_key_values,
    encode_key_values,
    key_transformable,
    merge2_sorted,
    sort_nsorter,
    tie_signed_zeros,
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
#: widest phase-1 block (``csrc/topk.cu`` sorts blocks of 256 and more in
#: shared memory, narrower ones in a warp's registers)
PHASE1_MAX_BLOCK = 1024
#: threads of a CTA of the router kernel (``ROUTER_THREADS``)
ROUTER_THREADS = 256

_KEY_PAD = torch.iinfo(torch.int32).min
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}

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


def signed_zero_rule(block: int, k: int, lists: int) -> bool:
    """Whether a tree over ``lists`` lists of blocks of ``block`` puts out
    -0.0 for the zeros of a row whose every value has its sign bit set,
    under ``zero_ties``. The reference permutes raw floats by its one-hot
    product at every block sort (``block`` lanes) and merge (two lists),
    and that permute keeps a zero's sign only in a vector of at most
    :data:`SIGNED_ZERO_LANES` lanes that all have the sign bit set
    (``common.onehot_permute``); anywhere else a zero becomes +0.0, and
    a lane without the sign bit makes every later vector's zeros +0.0.
    The merges' vectors grow up the tree, so a zero keeps its sign exactly
    when the block and the last vector (the root's merge of two lists, or
    the block itself) are that short and every value of the row (the
    reference's pads, the dtype minimum, included) has its sign bit
    set."""
    if block > SIGNED_ZERO_LANES:
        return False
    if lists <= 1:
        return True
    ln = min(k, block)
    for _ in range((lists - 1).bit_length() - 1):
        ln = min(k, 2 * ln)
    return 2 * ln <= SIGNED_ZERO_LANES


def _signed_zeros(keys: torch.Tensor, neg_rows: torch.Tensor) -> torch.Tensor:
    """Zero keys of the rows ``neg_rows`` (rows, ...) made -0.0's key."""
    neg = neg_rows.reshape(neg_rows.shape + (1,) * (keys.ndim - 1))
    return torch.where(neg & (keys == 0), torch.full_like(keys, -1), keys)


def _all_signed(x: torch.Tensor) -> torch.Tensor:
    """(rows,): every value of the row has its sign bit set."""
    return torch.signbit(x.float()).all(dim=-1)


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


def _keys(x: torch.Tensor, zero_ties: bool) -> torch.Tensor:
    """The kernels' keys on load: int32 values as they are, floats encoded;
    ``zero_ties`` (``nan_policy="unsafe"``): -0.0 with +0.0's key, so that
    the two tie as raw floats do."""
    if x.dtype == torch.int32:
        return x
    keys = encode_key_values(x)
    return tie_signed_zeros(keys) if zero_ties else keys


def _decode(keys: torch.Tensor, dtype) -> torch.Tensor:
    """The kernels' store: keys decoded to a float ``dtype``; int32 keys
    are the values."""
    return keys if dtype == torch.int32 else decode_key_values(keys, dtype)


def router_topk_plain(x: torch.Tensor, k: int, block: int, zero_ties: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``router_topk_kernel`` (``topk.py:60``)."""
    keys = _keys(x, zero_ties)
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
    out = vs[..., 0, :k]
    if zero_ties and x.dtype != torch.int32 and signed_zero_rule(block, k, g):
        out = _signed_zeros(out, _all_signed(x))
    return _decode(out, x.dtype), is_[..., 0, :k]


def vocab_phase1_plain(x: torch.Tensor, k: int, block: int, zero_ties: bool = False,
                       signs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``vocab_phase1_kernel`` (``topk.py:122``): (B, V)
    -> int32 keys and indices (B, nblk, min(k, block)); with a single
    block the keys come back decoded, as the reference's do (with
    ``zero_ties``, signed as :func:`signed_zero_rule` says). ``signs``
    (int32 (B,)): set to 1 where a row holds a value without the sign bit
    (what the merge tree's store reads)."""
    bsz, v = x.shape
    nblk = vocab_blocks(v, block)
    vp = nblk * block
    keys = _keys(x, zero_ties)
    keys = torch.cat([keys, keys.new_full((bsz, vp - v), _KEY_PAD)], dim=-1)
    idx = torch.arange(vp, dtype=torch.int32, device=x.device)
    idx = torch.where(idx < v, idx, -1).expand(bsz, vp)
    kk = min(k, block)
    vs, is_ = sort_nsorter(keys.reshape(bsz, nblk, block),
                           idx.reshape(bsz, nblk, block))
    vs, is_ = vs.flip(-1)[..., :kk], is_.flip(-1)[..., :kk]
    if signs is not None:
        signs |= (~_all_signed(x)).to(torch.int32)
    if nblk == 1:
        if zero_ties and x.dtype != torch.int32 and signed_zero_rule(block, k, 1):
            vs = _signed_zeros(vs, _all_signed(x))
        vs = _decode(vs, x.dtype)
    return vs, is_


def vocab_merge_level_plain(keys: torch.Tensor, idx: torch.Tensor, k: int,
                            decode_dtype=None, signs: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one ``vocab_merge_level_kernel`` launch
    (``topk.py:142``): (B, 2g, len) -> (B, g, min(k, 2 len)). ``signs``
    (the store of the tree's last level): zeros of the rows where it is 0
    come out -0.0."""
    keep = min(k, 2 * keys.shape[-1])
    vs, is_ = _merge_desc(keys[:, 0::2], idx[:, 0::2], keys[:, 1::2],
                          idx[:, 1::2], keep)
    if signs is not None:
        vs = _signed_zeros(vs, signs == 0)
    if decode_dtype is not None:
        vs = decode_key_values(vs, decode_dtype)
    return vs, is_


def vocab_merge_tree_plain(keys: torch.Tensor, idx: torch.Tensor, k: int,
                           decode_dtype=None, signs: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge tree: ``vocab_merge_level_plain``
    chained, (B, L, len) -> (B, 1, len'), the last level decoded (and
    signed by ``signs``)."""
    while keys.shape[1] > 1:
        last = keys.shape[1] == 2
        keys, idx = vocab_merge_level_plain(keys, idx, k, decode_dtype if last else None,
                                            signs if last else None)
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


def _tree_level(words: torch.Tensor, ln: int, k: int, pairs_cta: int,
                threads: int) -> torch.Tensor:
    """One level of ``merge_levels`` on (..., lists, ln) words: each pair of
    lists merged into min(k, 2 ln), in registers where the lengths allow
    (the bitonic network of ``warp_level``: keep of 32 to 256, ln = keep or
    keep / 2, powers of two), else by runs of ``ipt`` outputs (sized, as the
    kernel does, so that a CTA of ``threads`` covers its ``pairs_cta``
    pairs in about one pass), each a merge path along its diagonal and
    serial steps."""
    keep = min(k, 2 * ln)
    a, b = words[..., 0::2, :], words[..., 1::2, :]
    if ln & (ln - 1) == 0 and keep in (ln, 2 * ln) and keep in (32, 64, 128, 256):
        return _warp_level(a, b, keep)
    ipt = 1
    while ipt < TREE_IPT and pairs_cta * keep > ipt * threads:
        ipt *= 2
    return _path_level(a, b, keep, ipt)


def _unpack(words: torch.Tensor, decode_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, index) words back to int32 keys (decoded to ``decode_dtype``
    when it is given) and int32 indices."""
    keys, idx = (words >> 32).to(torch.int32), (words & 0xFFFFFFFF).to(torch.int32)
    if decode_dtype is not None:
        keys = decode_key_values(keys, decode_dtype)
    return keys, idx


def vocab_merge_tree_emulated(keys: torch.Tensor, idx: torch.Tensor, k: int,
                              decode_dtype=None, *, group: int = 0,
                              threads: int = TREE_THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA merge tree's decomposition on the CPU: each pass of the plan
    takes aligned subtrees of lists, and each level merges pairs of the
    packed (key, index) words as ``merge_levels`` does
    (:func:`_tree_level`). For the tests; equals
    :func:`vocab_merge_tree_plain`."""
    bsz, lists, ln = keys.shape
    words = _pack(keys, idx)
    for g in vocab_merge_plan(lists, ln, k, group):
        for lvl in range(g):  # a pass's subtrees are the tree's aligned pairs
            words = _tree_level(words, ln, k, 1 << (g - lvl - 1), threads)
            ln = words.shape[-1]
    return _unpack(words, decode_dtype)


def sort_slots(block: int) -> int:
    """Width of the network that sorts a block (``csrc/topk.cu``
    ``net_width``): the next power of two, at least 16."""
    return max(16, 1 << max(block - 1, 0).bit_length())


def _block_words(keys: torch.Tensor, pos: torch.Tensor, real: torch.Tensor,
                 vpad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block sort's words (``make_word``): int32 keys and positions ->
    for 16-bit keys (sign-extended int16) the int32 word key << 16 |
    position, for f32 keys (int64 ``keys``) the int64 word key << 32 |
    position; slots not ``real`` become the pad word, below every real one.
    With ``vpad`` (int32 rows' slots past V in the block), the int32 word
    key << 32 | position + 1, the slots ``vpad`` the key ``INT32_MIN``."""
    if vpad is not None:
        keys = torch.where(vpad, torch.full_like(keys, _KEY_PAD), keys)
        words = (keys.long() << 32) | (pos.long() + 1)
        real = real | vpad
        pad = torch.iinfo(torch.int64).min
    elif keys.dtype == torch.int64:
        words = (keys << 32) | pos.long()
        pad = torch.iinfo(torch.int64).min
    else:  # the 16-bit key's bits, shifted into the high half, wrap into int32
        words = (((keys.long() & 0xFFFF) << 16) | pos.long()).to(torch.int32)
        pad = _KEY_PAD
    return torch.where(real, words, torch.full_like(words, pad))


def _word_fields(words: torch.Tensor, base, v: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``word_key`` / ``word_index``: (int32 key, int32 base + position);
    (INT32_MIN, -1) for the pad word. ``v`` (int32 words, position + 1):
    an index past ``v`` is -1."""
    wide = words.dtype == torch.int64
    pad = words == (torch.iinfo(torch.int64).min if wide else _KEY_PAD)
    key = (words >> 32) if wide else (words >> 16)
    pos = (words & 0xFFFFFFFF) if wide else (words & 0xFFFF)
    if v is not None:
        pos = pos - 1
    key = torch.where(pad, torch.full_like(key, _KEY_PAD), key).to(torch.int32)
    idx = torch.where(pad, torch.full_like(pos, -1), pos + base)
    if v is not None:
        idx = torch.where(idx >= v, -1, idx)
    return key, idx.to(torch.int32)


def _bitonic_desc(words: torch.Tensor) -> torch.Tensor:
    """``block_sort`` / ``cta_sort`` on (..., n) words, n a power of two:
    the bitonic network in its mirror form, stage by stage in the kernels'
    order. Merge ``size`` compares word i first with its mirror i ^ (size -
    1), then with i ^ s for s = size / 4 .. 1; the lower word of each pair
    (bit s of i clear) keeps the larger. In the kernel word i is slot i % 4
    of the lane i // 4 of its block's lanes: partners within 4 are a lane's
    own slots, the others shuffles across lanes; the same exchanges."""
    n = words.shape[-1]
    i = torch.arange(n)
    size = 2
    while size <= n:
        s = size // 2
        while s:
            other = words[..., i ^ (size - 1 if s == size // 2 else s)]
            words = torch.where((i & s) == 0, torch.maximum(words, other),
                                torch.minimum(words, other))
            s //= 2
        size *= 2
    return words


def _sorted_blocks(keys: torch.Tensor, v: int, block: int, blocks: int, kk: int,
                   global_pos: bool, x_int: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``blocks`` blocks of each row of ``keys`` (rows, >= v;
    int32 keys of 16-bit floats, or f32 keys widened to int64), each
    padded to :func:`sort_slots` words (slots past ``block`` and past
    ``v``: pads), sorted by :func:`_bitonic_desc`, cut to ``kk``: int32
    keys and indices (rows, blocks, kk). The words' positions are the
    slot's in its block (phase 1) or in the row (``global_pos``: the
    router). ``x_int``: int32 rows, their values the keys (int32 words,
    the pads past V the key ``INT32_MIN`` and the index -1)."""
    bp = sort_slots(block)
    p = torch.arange(bp)
    base = torch.arange(blocks)[:, None] * block
    pos = base + p
    real = (p < block) & (pos < v)
    int_keys = keys.dtype == torch.int32 and x_int
    vpad = ((p < block) & (pos >= v)).expand(keys.shape[0], -1, -1) if int_keys else None
    kx = keys[:, torch.clamp(pos, max=max(v - 1, 0))]
    words = _block_words(kx, pos if global_pos else p.expand_as(pos), real, vpad)
    words = _bitonic_desc(words)[..., :kk]
    return _word_fields(words, 0 if global_pos else base, v if int_keys else None)


def vocab_phase1_emulated(x: torch.Tensor, k: int, block: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vocab_phase1_kernel``'s decomposition on the CPU: the real blocks
    (ceil(V / block) a row) sorted as packed words by the kernel's network,
    the padding blocks up to the power-of-two count filled with (INT32_MIN,
    -1). For the tests; equals :func:`vocab_phase1_plain`."""
    bsz, v = x.shape
    nblk, kk = vocab_blocks(v, block), min(k, block)
    real = min(nblk, -(-v // block))
    out = torch.full((bsz, nblk, kk), _KEY_PAD, dtype=torch.int32)
    idx = torch.full((bsz, nblk, kk), -1, dtype=torch.int32)
    x_int = x.dtype == torch.int32
    if real:
        keys = x if x_int else encode_key_values(x)
        if x.dtype == torch.float32:
            keys = keys.long()  # the 64-bit words of f32 keys
        out[:, :real], idx[:, :real] = _sorted_blocks(keys, v, block, real, kk, False, x_int)
    if nblk == 1:
        out = _decode(out, x.dtype)
    return out, idx


def router_topk_emulated(x: torch.Tensor, k: int, block: int, *, rows_per_cta: int = 1,
                         threads: int = ROUTER_THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``router_topk_kernel``'s decomposition on the CPU: each block sorted
    as packed words (positions in the row) by the kernel's network and cut
    to min(k, block); the list count padded up front to a power of two
    with lists of pads; the levels of ``merge_levels`` on (key, index)
    words, ``rows_per_cta`` trees a CTA of ``threads``. For the tests;
    equals :func:`router_topk_plain`."""
    t, e = x.shape
    g, kk = e // block, min(k, block)
    levels = (g - 1).bit_length()
    x_int = x.dtype == torch.int32
    keys = x if x_int else encode_key_values(x)
    if x.dtype == torch.float32:
        keys = keys.long()
    words = _pack(*_sorted_blocks(keys, e, block, g, kk, True, x_int))
    pad = _pack(torch.tensor(_KEY_PAD), torch.tensor(-1))
    words = torch.cat([words, pad.expand(t, (1 << levels) - g, kk)], dim=1)
    ln = kk
    for lvl in range(levels):
        words = _tree_level(words, ln, k, rows_per_cta << (levels - lvl - 1), threads)
        ln = words.shape[-1]
    keys, idx = _unpack(words[:, 0], _decode_dtype(x.dtype))
    return keys, idx


def _vocab_signs(x: torch.Tensor, k: int, block: int, zero_ties: bool
                 ) -> Optional[torch.Tensor]:
    """The per-row sign flags phase 1 hands the merge tree's store, where
    the tree can put out -0.0 (:func:`signed_zero_rule`); else None."""
    nblk = vocab_blocks(x.shape[1], block)
    if not zero_ties or x.dtype == torch.int32 or nblk == 1 \
            or not signed_zero_rule(block, k, nblk):
        return None
    return torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)


def _decode_dtype(dtype):
    """What the merge tree decodes its keys to: floats; int32 keys are
    the values (None)."""
    return None if dtype == torch.int32 else dtype


def vocab_topk_plain(x: torch.Tensor, k: int, block: int = 128, zero_ties: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole vocab path (phase 1 + merge levels)."""
    signs = _vocab_signs(x, k, block, zero_ties)
    vs, is_ = vocab_phase1_plain(x, k, block, zero_ties, signs)
    vs, is_ = vocab_merge_tree_plain(vs, is_, k, _decode_dtype(x.dtype), signs)
    return vs[:, 0, :k], is_[:, 0, :k]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor, k: int, k_max: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"top-k takes a 2-D (rows, axis) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"top-k takes float32, bfloat16, float16 or int32, not {x.dtype}")
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} out of range [1, {k_max}]")


def _check_cuda(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError("the CUDA top-k kernels take a contiguous tensor")
    if x.shape[0] * x.shape[1] >= 2 ** 31:
        raise ValueError(f"tensor of shape {tuple(x.shape)} is too large")


def router_topk(x: torch.Tensor, k: int, *, block: int = 32, zero_ties: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over the last axis of (T, E), E <= 512, E % block == 0;
    ``zero_ties``: -0.0 and +0.0 tie (``nan_policy="unsafe"``), and zeros
    are signed by :func:`signed_zero_rule`.

    Replaces ``router_topk_pallas`` (``src/repro/kernels/topk.py:88``)."""
    _check_input(x, k, x.shape[-1])
    t, e = x.shape
    if e > ROUTER_TOPK_MAX or e % block:
        raise ValueError(f"router top-k needs E <= {ROUTER_TOPK_MAX} and "
                         f"E % block == 0 (E={e}, block={block})")
    if x.device.type == "cpu":
        return router_topk_plain(x, k, block, zero_ties)
    if x.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {x.device}")
    _check_cuda(x)
    v = torch.empty((t, k), dtype=x.dtype, device=x.device)
    i = torch.empty((t, k), dtype=torch.int32, device=x.device)
    if t:
        negz = zero_ties and x.dtype != torch.int32 and signed_zero_rule(block, k, e // block)
        check_rc(library("topk").repro_router_topk(
            x.data_ptr(), v.data_ptr(), i.data_ptr(), t, e, k, block,
            int(zero_ties) | 2 * int(negz), _DTYPE_CODE[x.dtype], stream(x)), "router_topk")
        LAUNCHES["router_topk"] += 1
    return v, i


def vocab_phase1(x: torch.Tensor, k: int, block: int, zero_ties: bool = False,
                 signs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the vocab top-k (replaces ``_phase1_kernel``): (B, V) ->
    int32 keys and indices (B, nblk, min(k, block)), nblk a power of two;
    with a single block the values come back decoded. ``signs`` (int32
    (B,), zeros): set to 1 where a row holds a value without the sign bit,
    for the merge tree's store (:func:`signed_zero_rule`)."""
    _check_input(x, k, MERGE_MAX_LEN)
    if x.device.type == "cpu":
        return vocab_phase1_plain(x, k, block, zero_ties, signs)
    if x.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {x.device}")
    _check_cuda(x)
    if not 1 <= block <= PHASE1_MAX_BLOCK:
        raise ValueError(f"vocab top-k needs block <= {PHASE1_MAX_BLOCK}, not {block}")
    bsz, v = x.shape
    nblk, kk = vocab_blocks(v, block), min(k, block)
    if bsz * nblk * kk >= 2 ** 31:
        raise ValueError(f"phase-1 lists of shape {(bsz, nblk, kk)} are too large")
    single = nblk == 1
    idx = torch.empty((bsz, nblk, kk), dtype=torch.int32, device=x.device)
    out = torch.empty((bsz, nblk, kk), dtype=x.dtype if single else torch.int32,
                      device=x.device)
    negz = single and zero_ties and x.dtype != torch.int32 and signed_zero_rule(block, k, 1)
    if bsz:
        check_rc(library("topk").repro_vocab_phase1(
            x.data_ptr(), out.data_ptr(), out.data_ptr(), idx.data_ptr(),
            None if signs is None else signs.data_ptr(), bsz, v, nblk, block, kk,
            int(single), int(zero_ties) | 2 * int(negz), _DTYPE_CODE[x.dtype], stream(x)),
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
                            tail_levels: int = 0, decode_dtype=None,
                            signs: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``vocab_merge_tree_kernel``: subtrees of 2^levels lists,
    then (``tail_levels`` > 0) the rest of each row's tree by its last CTA.
    (B, L, len) -> (B, L >> (levels + tail_levels), len'). ``signs``: as
    :func:`vocab_merge_tree` (the tree's last launch). Counts a launch."""
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
                               for t in (skey, sidx, tickets, signs)),
            groups, ln, k, levels, tail_levels, int(decode_dtype is not None),
            TREE_THREADS, _DTYPE_CODE.get(decode_dtype, 0), stream(keys)),
            "vocab_merge_tree")
        LAUNCHES["vocab_merge_level"] += 1
    return out, oidx


def vocab_merge_tree(keys: torch.Tensor, idx: torch.Tensor, k: int,
                     decode_dtype=None, signs: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vocab merge tree (replaces the launches of ``_merge_level_kernel``,
    one a level): int32 keys and indices (B, L, len), L a power of two ->
    (B, 1, len'), each level keeping min(k, 2 len), decoded to
    ``decode_dtype`` when it is given; ``signs`` (int32 (B,), phase 1's):
    the zeros of the rows where it is 0 come out -0.0. The launches of
    :func:`tree_launches` of :func:`vocab_merge_plan`: one at the serving
    shapes. The last CTA of a row is found by tickets kept per device, so
    two trees must not run at once on two streams of one card."""
    if decode_dtype is not None and not key_transformable(decode_dtype):
        raise TypeError(f"cannot decode keys to {decode_dtype}")
    if keys.device.type == "cpu":
        return vocab_merge_tree_plain(keys, idx, k, decode_dtype, signs)
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
        last = n == len(steps) - 1
        keys, idx = vocab_merge_tree_launch(keys, idx, k, levels, tail,
                                            decode_dtype if last else None,
                                            signs if last else None)
    return keys, idx


def vocab_topk(x: torch.Tensor, k: int, *, block: int = 128, zero_ties: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over a large last axis (B, V); V need not be a
    block multiple. Replaces ``vocab_topk_pallas``
    (``src/repro/kernels/topk.py:155``): one phase-1 launch, then the
    merge tree (:func:`vocab_merge_launches` launches). As in the
    reference, k may exceed V: the slots past the real candidates are
    pads. ``zero_ties``: -0.0 and +0.0 tie (``nan_policy="unsafe"``), and
    zeros are signed by :func:`signed_zero_rule`."""
    signs = _vocab_signs(x, k, block, zero_ties)
    vs, is_ = vocab_phase1(x, k, block, zero_ties, signs)
    if vs.shape[1] > 1:
        vs, is_ = vocab_merge_tree(vs, is_, k, _decode_dtype(x.dtype), signs)
    return vs[:, 0, :k], is_[:, 0, :k]
