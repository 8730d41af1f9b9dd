"""The pair-sort decompositions of kernel rows 8 and 1, held on the CPU.

Row 8 (``csrc/kway.cu``) runs every class of a schedule by the executor
its wiring word names (``kernels/kway.py`` ``executor``): a group of at
most 8 cells by one thread's register sort of the packed (key, j) pairs,
j the cell's index in the group's idx order (an S2MS group only where its
runs are sorted, else by the search); a wider N-sorter by a warp's
bitonic sort (9..128 cells), or a merge of its even and odd cells (the
last bitonic level) where a vote finds both chains sorted; an S2MS group
of equal power-of-two runs by the warp sort from the level above its
runs, the odd runs loaded reversed; other S2MS groups by a binary search
of each other run. A
stage reads one buffer and writes the other, the cells no group holds
copied across. Here a torch emulation walks the kernel's own wiring words
(``encode_wiring``: stages, pass lists, executor words, the descending
reversal folded in) and runs each executor as the kernel does: the
bitonic network's step order, directions and min/max choice on the
packed pairs (the 64-bit pair with the position beside j, or the 32-bit
pair of a 16-bit key, the position read again from the cell j names),
the binary search loop, the counted rank. It is held bit-equal, keys and
positions, to ``kway_merge_plain`` for every schedule of chip_smoke.py's
phases 2 and 3f (LOMS 3 x 7, 3 x 8, 4 x 64, 5 x 5, 8 x 128, 8 x 181,
(100, 50, 25), the two-stage devices, the 3 x 7 and 5 x 7 medians and
their center-cell readouts, MWMS 3 x 7), both orders, int32, bf16 and f32
keys, on lists with heavy ties, NaN, ±inf, ±0.0 and INT32_MAX keys.

Row 1 (``csrc/merge.cu`` ``merge_tile_kernel``) cuts a single-level merge
program's output into tiles of rows of its column stack, a CTA each: a
merge-path diagonal search per column at the tile's first row (the
program's tie rule: the first run wins ties), the columns' segments
merged, each row of C sorted by (key, column). A torch emulation of that
decomposition, at forced small tiles, is held bit-equal to
``loms_merge2_plain`` at (65,536 + 32) on few rows, (1000, 24), (512,
512) and (8, 8), the s2ms and loms families, both orders, with ties and
INT32_MAX keys. Tolerance: none, bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mwms_kway
from repro_torch.kernels.common import (decode_key_values, encode_key_values, ranks_sort)
from repro_torch.kernels.kway import (E_MERGE, E_RANK, E_SEARCH, E_THREAD, E_WARP,
                                      encode_wiring, kway_merge_plain)
from repro_torch.kernels.ops import median_readout
from repro_torch.networks import kway_schedule, median_schedule

INT32_MAX = np.iinfo(np.int32).max
PAIR_MAX = {False: np.iinfo(np.int64).max, True: 0xFFFFFFFF}


# ---------------------------------------------------------------------------
# row 8
# ---------------------------------------------------------------------------


def _bitonic(v: torch.Tensor, k0: int = 2) -> torch.Tensor:
    """program.cuh ``bitonic_sort`` from level k0 on every row of the last
    axis (a power of two wide): steps (k, j) in the kernel's order, lane i
    paired with i ^ j, ascending where k is the width or i & k == 0, the
    lower lane of an ascending pair keeping the min."""
    s = v.shape[-1]
    i = torch.arange(s)
    k = 2
    while k <= s:
        j = k >> 1
        while k >= k0 and j > 0:
            o = v[..., i ^ j]
            up = (i & k) == 0 if k < s else torch.ones_like(i, dtype=torch.bool)
            keep_min = ((i & j) == 0) == up
            v = torch.where(keep_min, torch.minimum(v, o), torch.maximum(v, o))
            j >>= 1
        k <<= 1
    return v


def _pack(keys, j, pos, narrow):
    """``cell_pair``: (key, j) as an int64 that orders like the kernel's
    word; the 64-bit pair carries the position beside j."""
    keys = keys.to(torch.int64)
    if narrow:
        return (torch.where(keys == INT32_MAX, 65536, keys + 32768) << 13) | j
    return (keys << 32) | (j << 16) | pos.to(torch.int64)


def _unpack(v, narrow):
    """-> (key, j, position or None)"""
    if narrow:
        k = (v >> 13) - 32768
        return torch.where(k == 32768, INT32_MAX, k), v & 8191, None
    return v >> 32, (v >> 16) & 0xFFFF, v & 0xFFFF


def _load_order(s, n, ex, runs):
    """The group index j each of the s sorted places loads, and the block
    b of the expected sorted runs (kway.cu warp_sort): E_MERGE the even
    cells up, then the odd cells down; an S2MS E_WARP its runs, the odd
    ones reversed; else none (b = 1)."""
    i = torch.arange(s)
    if ex == E_MERGE:
        return torch.where(i < s // 2, 2 * i, 2 * (s - 1 - i) + 1), s // 2
    run = runs[0] if (ex == E_WARP and runs) else 1
    return torch.where((i & run) != 0, (i | (run - 1)) - (i & (run - 1)), i), run


def _blocks_sorted(v, b):
    """The warp's vote: every block of b places sorted, ascending where the
    place's bit b is clear, descending where it is set (per group)."""
    i = torch.arange(v.shape[-1] - 1)
    inner = ((i + 1) & (b - 1)) != 0
    up = (i & b) == 0
    a, c = v[..., :-1], v[..., 1:]
    good = torch.where(up, a <= c, a >= c) | ~inner
    return good.all(dim=-1)


def _pair_sort(vals, pvals, n, ex, runs, narrow):
    """The E_THREAD, E_WARP and E_MERGE executors on (B, G, n) groups: the
    keys and positions at sorted places 0..n-1."""
    if ex == E_THREAD:
        s, b = (2 if n <= 2 else 4 if n <= 4 else 8), 1
        jj = torch.arange(s)
    else:
        s = 32 * (1 if n <= 32 else 2 if n <= 64 else 4)
        jj, b = _load_order(s, n, ex, runs)
    live = jj < n
    jc = torch.where(live, jj, 0)
    v = _pack(vals[..., jc], jc.to(torch.int64), pvals[..., jc], narrow)
    v = torch.where(live, v, torch.tensor(PAIR_MAX[narrow], dtype=torch.int64))
    sorted_v = _bitonic(v)
    if b > 1:  # from level 2b where the vote passes
        sorted_v = torch.where(_blocks_sorted(v, b)[..., None], _bitonic(v, 2 * b), sorted_v)
    key, j, pos = _unpack(sorted_v[..., :n], narrow)
    if pos is None:  # the narrow pair: the position read again at j
        pos = torch.gather(pvals.to(torch.int64), -1, j)
    return key, pos


def _runs_sorted(vals, runs):
    """E_THREAD's check of an S2MS group: every run non-decreasing."""
    offs = np.cumsum((0,) + tuple(runs))
    ok = torch.ones(vals.shape[:-1], dtype=torch.bool)
    for s in range(len(runs)):
        r = vals[..., offs[s]:offs[s + 1]]
        ok &= (r[..., 1:] >= r[..., :-1]).all(dim=-1)
    return ok


def _search_ranks(vals, runs):
    """E_SEARCH: own index plus each other run's count, by the kernel's
    binary search loop (<= for an earlier run, < for a later one)."""
    offs = np.cumsum((0,) + tuple(runs))
    ranks = torch.zeros(vals.shape, dtype=torch.int64)
    for s in range(len(runs)):
        key = vals[..., offs[s]:offs[s + 1]]
        r = torch.arange(runs[s]).expand(key.shape).clone()
        for u in range(len(runs)):
            if u == s:
                continue
            run = vals[..., offs[u]:offs[u + 1]]
            lo = torch.zeros(key.shape, dtype=torch.int64)
            hi = torch.full(key.shape, runs[u], dtype=torch.int64)
            while bool((lo < hi).any()):
                act = lo < hi
                mid = (lo + hi) >> 1
                v = torch.gather(run, -1, torch.where(act, mid, 0).reshape(
                    run.shape[:-1] + (-1,))).reshape(key.shape)
                go = (v <= key) if u < s else (v < key)
                lo = torch.where(act & go, mid + 1, lo)
                hi = torch.where(act & ~go, mid, hi)
            r = r + lo
        ranks[..., offs[s]:offs[s + 1]] = r
    return ranks


def _class_cells(words, o, ng, n, ex):
    """A class's (G, n) cells from the kernel's layout of them (E_THREAD
    transposed, E_WARP lane-major in 32 x ER words a group), and the
    offset past them."""
    if ex == E_THREAD:
        return torch.from_numpy(words[o:o + ng * n].reshape(n, ng).T.copy()), o + ng * n
    if ex in (E_WARP, E_MERGE):
        s = 32 * (1 if n <= 32 else 2 if n <= 64 else 4)
        er, i = s // 32, np.arange(n)
        cells = words[o:o + ng * s].reshape(ng, s)[:, (i % er) * 32 + i // er]
        return torch.from_numpy(cells.copy()), o + ng * s
    return torch.from_numpy(words[o:o + ng * n].reshape(ng, n)), o + ng * n


def kway_emulated(x, sched, *, n_stages=None, lens=None, key_dtype=None, descending=False):
    """Row 8's key mode as the kernel runs it, from its wiring words."""
    words = encode_wiring(sched, n_stages, lens, descending).astype(np.int64)
    size, n_in, n_out, n_st = (int(w) for w in words[:4])
    src = torch.from_numpy(words[4:4 + size])
    o = 4 + size
    narrow = key_dtype in (torch.bfloat16, torch.float16)
    keys = (encode_key_values(x) if key_dtype is not None else x).to(torch.int64)
    live = src >= 0
    sc = torch.where(live, src, 0)
    k = torch.where(live, keys[:, sc], 0)
    p = torch.where(live, sc, 0).expand(k.shape).clone()
    for _ in range(n_st):
        n_cls, n_pass = int(words[o]), int(words[o + 1])
        passed = torch.from_numpy(words[o + 2:o + 2 + n_pass])
        o += 2 + n_pass
        kb = torch.full_like(k, -(1 << 40))  # every cell is written once below
        pb = torch.full_like(p, -1)
        kb[:, passed], pb[:, passed] = k[:, passed], p[:, passed]
        for _ in range(n_cls):
            ng, n, ex, nr = (int(w) for w in words[o:o + 4])
            runs = tuple(int(r) for r in words[o + 4:o + 4 + nr])
            o += 4 + nr
            idx, o = _class_cells(words, o, ng, n, ex)
            vals, pvals = k[:, idx], p[:, idx]
            if ex in (E_THREAD, E_WARP, E_MERGE):
                key, pos = _pair_sort(vals, pvals, n, ex, runs, narrow)
                if ex == E_THREAD and runs:  # where a run is not sorted: the search
                    rank = _search_ranks(vals, runs)
                    dst = torch.gather(idx.expand(vals.shape), -1, rank)
                    sk, sp = kb.clone(), pb.clone()
                    bidx = torch.arange(k.shape[0])[:, None, None]
                    sk[bidx, dst], sp[bidx, dst] = vals, pvals
                    ok = _runs_sorted(vals, runs)[..., None]
                    key = torch.where(ok, key, sk[:, idx])
                    pos = torch.where(ok, pos, sp[:, idx])
                kb[:, idx], pb[:, idx] = key, pos
                continue
            assert ex == (E_SEARCH if nr else E_RANK)
            rank = _search_ranks(vals, runs) if nr else ranks_sort(vals).to(torch.int64)
            dst = torch.gather(idx.expand(vals.shape), -1, rank)
            bidx = torch.arange(k.shape[0])[:, None, None]
            kb[bidx, dst], pb[bidx, dst] = vals, pvals
        assert bool((pb >= 0).all()), "a cell no class and no pass list writes"
        k, p = kb, pb
    gather = torch.from_numpy(words[o:o + n_out])
    assert o + n_out == len(words)
    out, perm = k[:, gather].to(torch.int32), p[:, gather].to(torch.int32)
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    return out, perm


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _lists(rows, lens, dtype, seed, descending):
    """Sorted lists (total order of the keys) of heavy ties; floats with
    NaN, ±inf and ±0.0; int32 with INT32_MAX keys (chunked_merge_k's fill)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        if dtype == torch.int32:
            v = rng.integers(-3, 4, (rows, n)).astype(np.int32)
            v[rng.random((rows, n)) < 0.15] = INT32_MAX
            t = torch.from_numpy(v)
            keys = t
        else:
            v = (rng.integers(-3, 4, (rows, n)) * 0.5).astype(np.float32)
            for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
                v[rng.random((rows, n)) < frac] = val
            t = torch.from_numpy(v).to(dtype)
            keys = encode_key_values(t)
        order = torch.argsort(keys, dim=-1, stable=True)
        if descending:
            order = order.flip(-1)
        out.append(torch.gather(_bits(t), 1, order).view(dtype))
    return torch.cat(out, dim=1)


def _median(lens):
    med, pos = median_schedule(lens)
    return med, median_readout(med, pos)


SCHEDULES = {  # the schedules of chip_smoke.py's phases 2 and 3f
    "3x7": lambda: kway_schedule((7, 7, 7)),
    "3x8": lambda: kway_schedule((3,) * 8),
    "4x64": lambda: kway_schedule((64,) * 4),
    "5x5": lambda: kway_schedule((5,) * 5),
    "8x128": lambda: kway_schedule((128,) * 8),
    "8x181": lambda: kway_schedule((181,) * 8),
    "100_50_25": lambda: kway_schedule((100, 50, 25)),
    "median3x7": lambda: _median((7, 7, 7))[0],
    "median3x7_center": lambda: _median((7, 7, 7))[1],
    "median5x7": lambda: _median((7,) * 5)[0],
    "median5x7_center": lambda: _median((7,) * 5)[1],
    "mwms3x7": lambda: mwms_kway((7, 7, 7)),
}
LENS = {"3x7": (7, 7, 7), "3x8": (3,) * 8, "4x64": (64,) * 4, "5x5": (5,) * 5,
        "8x128": (128,) * 8, "8x181": (181,) * 8, "100_50_25": (100, 50, 25),
        "median3x7": (7, 7, 7), "median3x7_center": (7, 7, 7), "median5x7": (7,) * 5,
        "median5x7_center": (7,) * 5, "mwms3x7": (7, 7, 7)}
MODES = [(torch.int32, False), (torch.bfloat16, True), (torch.float32, False)]


@pytest.fixture(scope="module")
def schedules():
    return {name: make() for name, make in SCHEDULES.items()}


@pytest.mark.parametrize("name", list(SCHEDULES))
@pytest.mark.parametrize("dtype,descending", MODES)
def test_kway_executors_equal_the_plain_version(schedules, name, dtype, descending):
    sched, lens = schedules[name], LENS[name]
    if descending and sched.n_outputs != sched.n_inputs:
        descending = False  # a readout of one cell has no descending order
    rows = 24 if sched.size <= 256 else 8
    x = _lists(rows, lens, dtype, sched.size + 7, descending)
    key = dtype if dtype.is_floating_point else None
    stages = (None, 2) if len(sched.stages) > 2 else (None,)
    for n_stages in stages:
        kw = dict(n_stages=n_stages, lens=lens, key_dtype=key, descending=descending)
        want, want_perm, _ = kway_merge_plain(x, sched, want_perm=True, **kw)
        got, got_perm = kway_emulated(x, sched, **kw)
        assert torch.equal(_bits(got), _bits(want)), (name, dtype, descending, n_stages)
        assert torch.equal(got_perm, want_perm), (name, dtype, descending, n_stages)


def test_wiring_picks_the_executors_the_design_names(schedules):
    """4 x 64 and 8 x 128 take the warp sort in every stage of wide groups
    (their stage-0 S2MS groups are runs of 16) and the one-thread sort in
    their row stages; 3 x 7's stage 0 (runs 3, 2, 2) keeps the search."""
    def execs(sched, raw=False):
        words = encode_wiring(sched, raw=raw).astype(np.int64)
        size, n_st = int(words[0]), int(words[3])
        o, seen = 4 + size, []
        for _ in range(n_st):
            n_cls, n_pass = int(words[o]), int(words[o + 1])
            o += 2 + n_pass
            for _ in range(n_cls):
                ng, n, ex, nr = (int(w) for w in words[o:o + 4])
                seen.append((n, ex))
                _, o = _class_cells(words, o + 4 + nr, ng, n, ex)
        assert o + sched.n_outputs == len(words)
        return seen

    assert execs(schedules["4x64"]) == [(64, E_WARP), (4, E_THREAD), (64, E_MERGE),
                                        (4, E_THREAD)]
    assert execs(schedules["8x128"]) == [(128, E_WARP), (8, E_THREAD), (128, E_MERGE),
                                         (8, E_THREAD), (128, E_MERGE), (8, E_THREAD)]
    assert execs(schedules["3x7"]) == [(7, E_THREAD)] * 3 + [(3, E_THREAD), (2, E_THREAD)]
    assert execs(schedules["100_50_25"])[:3] == [(59, E_SEARCH), (58, E_SEARCH),
                                                 (58, E_SEARCH)]
    assert {ex for _, ex in execs(schedules["8x181"])} == {E_SEARCH, E_THREAD, E_RANK}
    for name, sched in schedules.items():  # the raw-float mode counts every class
        assert {ex for _, ex in execs(sched, raw=True)} <= {E_RANK, E_SEARCH}, name
        if sched.size <= 64:  # a thread a row: no warp sort
            assert not {E_WARP, E_MERGE} & {ex for _, ex in execs(sched)}, name


# ---------------------------------------------------------------------------
# row 1
# ---------------------------------------------------------------------------

TILE_STEPS = 8  # csrc/merge.cu: merge steps a thread, rows of one column


def _diagonal(F, S, s):
    """How many of F lie among the first s outputs of column merge (F, S),
    F winning ties: the kernel's search, lo = max(0, s - |S|), hi =
    min(s, |F|), F[mid] <= S[s - 1 - mid] moves lo past mid. F, S: (B, len)
    keys; s: (P,) starts -> (B, P)."""
    lf, ls = F.shape[1], S.shape[1]
    lo = (s - ls).clamp(min=0).expand(F.shape[0], -1).clone()
    hi = s.clamp(max=lf).expand(F.shape[0], -1).clone()
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi) >> 1
        f = torch.gather(F, 1, torch.where(act, mid, 0).clamp(max=lf - 1))
        g = torch.gather(S, 1, torch.where(act, s - 1 - mid, 0).clamp(0, ls - 1))
        go = f <= g
        lo = torch.where(act & go, mid + 1, lo)
        hi = torch.where(act & ~go, mid, hi)
    return lo


def merge_tiles_emulated(a, b, *, cols, key_dtype=None, descending=False, tile=0):
    """Row 1's tiled kernel: per column, each thread's diagonal search and
    up to TILE_STEPS merge steps, its segments restarting at every tile;
    then each row of C sorted by the (key, column) word, the positions
    read again from the columns."""
    bsz, m = a.shape
    n = b.shape[1]
    L, C = m + n, cols
    R = L // C
    T = tile or TILE_STEPS * 256 // C
    ka = (encode_key_values(a) if key_dtype is not None else a).to(torch.int64)
    kb = (encode_key_values(b) if key_dtype is not None else b).to(torch.int64)
    pa, pb = torch.arange(m), m + torch.arange(n)
    if descending:  # the ascending problem
        ka, kb, pa, pb = ka.flip(-1), kb.flip(-1), pa.flip(-1), pb.flip(-1)
    starts = torch.tensor([s for r0 in range(0, R, T)
                           for s in range(r0, min(R, r0 + T), TILE_STEPS)])
    ends = torch.tensor([min(R, r0 + T) for r0 in range(0, R, T)
                         for _ in range(r0, min(R, r0 + T), TILE_STEPS)])
    colk = torch.zeros((bsz, C, R), dtype=torch.int64)
    colp = torch.zeros((bsz, C, R), dtype=torch.int64)
    for c in range(C):
        if C > 1:
            F, PF, S, PS = kb[:, C - 1 - c::C], pb[C - 1 - c::C], ka[:, c::C], pa[c::C]
        else:
            F, PF, S, PS = ka, pa, kb, pb
        lf, ls = F.shape[1], S.shape[1]
        i_f = _diagonal(F, S, starts)
        i_s = starts - i_f
        for q in range(TILE_STEPS):
            live = (starts + q < ends).expand(bsz, -1)
            vf = torch.gather(F, 1, i_f.clamp(max=lf - 1))
            vs = torch.gather(S, 1, i_s.clamp(max=ls - 1))
            take_f = (i_f < lf) & ((i_s >= ls) | (vf <= vs))
            key = torch.where(take_f, vf, vs)
            pos = torch.where(take_f, PF[i_f.clamp(max=lf - 1)], PS[i_s.clamp(max=ls - 1)])
            r = (starts + q).clamp(max=R - 1).expand(bsz, -1)
            bi = torch.arange(bsz)[:, None].expand_as(r)
            colk[bi[live], c, r[live]] = key[live]
            colp[bi[live], c, r[live]] = pos[live]
            i_f = torch.where(live & take_f, i_f + 1, i_f)
            i_s = torch.where(live & ~take_f, i_s + 1, i_s)
    narrow = key_dtype in (torch.bfloat16, torch.float16)
    rowk, rowp = colk.transpose(1, 2), colp.transpose(1, 2)  # (B, R, C)
    if C > 1:
        s = 1 << (C - 1).bit_length()
        col = torch.arange(s)
        v = _pack(torch.cat([rowk, torch.zeros(bsz, R, s - C, dtype=torch.int64)], -1),
                  col.expand(bsz, R, s), None, narrow) if narrow else \
            (torch.cat([rowk, torch.zeros(bsz, R, s - C, dtype=torch.int64)], -1) << 32) | col
        v = torch.where(col < C, v, torch.tensor(PAIR_MAX[narrow], dtype=torch.int64))
        v = _bitonic(v)[..., :C]
        if narrow:
            key, c_of, _ = _unpack(v, True)
        else:
            key, c_of = v >> 32, v & 0xFFFFFFFF
        rowk, rowp = key, torch.gather(rowp, -1, c_of)
    out, perm = rowk.reshape(bsz, L).to(torch.int32), rowp.reshape(bsz, L).to(torch.int32)
    if descending:
        out, perm = out.flip(-1), perm.flip(-1)
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    return out, perm


MERGE_SHAPES = ((65_536, 32), (1000, 24), (512, 512), (8, 8))


@pytest.mark.parametrize("m,n", MERGE_SHAPES)
@pytest.mark.parametrize("dtype,descending", MODES)
def test_merge_tiles_equal_the_plain_version(m, n, dtype, descending):
    from repro_torch.kernels.loms_merge import loms_merge2_plain, tile_cols
    from repro_torch.networks import pick_merge_cols

    rows = 2 if m + n > 4096 else 6
    a = _lists(rows, (m,), dtype, m, descending)
    b = _lists(rows, (n,), dtype, n + 1, descending)
    key = dtype if dtype.is_floating_point else None
    for fam in ("loms", "s2ms"):
        n_cols = pick_merge_cols(m, n)
        cols = tile_cols(fam, m, n, n_cols, False)
        assert cols == (n_cols if fam == "loms" else 1)
        want, want_perm, _ = loms_merge2_plain(a, b, network=fam, n_cols=n_cols,
                                               key_dtype=key, descending=descending,
                                               want_perm=True)
        tiles = (3, 0) if m + n > 4096 else (1, 5, 16, 0)
        for tile in tiles:
            got, got_perm = merge_tiles_emulated(a, b, cols=cols, key_dtype=key,
                                                 descending=descending, tile=tile)
            assert torch.equal(_bits(got), _bits(want)), (m, n, fam, tile)
            assert torch.equal(got_perm, want_perm), (m, n, fam, tile)


@pytest.mark.parametrize("n", [9, 33, 64, 100, 128])
@pytest.mark.parametrize("narrow", [False, True])
def test_warp_sorts_sort_any_group(n, narrow):
    """The warp executors are the stable sort of their group by (key, j)
    whatever the data: where the expected runs or chains are sorted the
    vote lets the bitonic sort start high, elsewhere it sorts from level 2
    (unsorted chains, unsorted runs)."""
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-3, 4, (64, 2, n)).astype(np.int64))
    keys[:32] = keys[:32].sort(-1)[0]  # half the rows sorted: every vote passes
    chains = keys.clone()
    chains[32:48, :, 0::2] = chains[32:48, :, 0::2].sort(-1)[0]  # chains sorted, not the row
    chains[32:48, :, 1::2] = chains[32:48, :, 1::2].sort(-1)[0]
    pos = torch.arange(n).expand(keys.shape)
    cases = [(keys, E_WARP, None), (chains, E_MERGE, None)]
    if n in (64, 128):
        cases.append((keys, E_WARP, (16,) * (n // 16)))
    for vals, ex, runs in cases:
        k, p = _pair_sort(vals, pos, n, ex, runs, narrow)
        order = torch.argsort(vals * n + pos, dim=-1)  # (key, j), j = pos here
        assert torch.equal(k, torch.gather(vals, -1, order)), (ex, runs)
        assert torch.equal(p, order), (ex, runs)
