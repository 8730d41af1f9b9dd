"""On-card tests of the port's CUDA kernels (top-k, segmented class sort
and merge, the 2-way merge, the fused sort, the grid merge, the k-way
merge) against their plain versions, in the key mode and in the
reference's raw-float mode (``use_mxu=True``: rows 1, 2 and 8), and the
sort executor of rows 2 and 6 at every lanes-a-thread layout.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

  python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import topk
from repro_torch.kernels import segmented as SK
from repro_torch.kernels import topk as K
from repro_torch.networks import capable_families, pick_merge_cols

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _logits(rows, n, dtype, seed=0):
    """Random rows with many ties and NaN, ±inf, ±0.0 in the first rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (rows, n)) * 0.25).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    if rows > 1:
        x[1, -4:] = [-0.0, 0.0, np.inf, np.nan]
    return torch.from_numpy(x).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a, b):
    (av, ai), (bv, bi) = a, b
    assert torch.equal(_bits(av.cpu()), _bits(bv.cpu()))
    assert torch.equal(ai.cpu(), bi.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,e,k,block", [(64, 256, 16, 16), (64, 128, 8, 16),
                                            (33, 96, 40, 16), (8, 512, 64, 64),
                                            (4, 256, 64, 64)])
def test_router_kernel_matches_plain(cuda, dtype, rows, e, k, block):
    x = _logits(rows, e, dtype).to(cuda)
    _same(K.router_topk(x, k, block=block), K.router_topk_plain(x, k, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,v,k,block", [(4, 151_936, 64, 64), (3, 1000, 16, 16),
                                            (2, 5000, 256, 128), (2, 100, 120, 128)])
def test_vocab_kernels_match_plain(cuda, dtype, rows, v, k, block):
    x = _logits(rows, v, dtype).to(cuda)
    _same(K.vocab_topk(x, k, block=block), K.vocab_topk_plain(x, k, block))


def test_launch_counts(cuda):
    K.reset_launch_counts()
    x = _logits(4, 151_936, torch.bfloat16).to(cuda)
    topk(x, 64)
    topk(x[:, :256].contiguous(), 16)
    assert K.LAUNCHES == {"router_topk": 1, "vocab_phase1": 1,
                          "vocab_merge_level": K.vocab_merge_launches(151_936, 64, 64),
                          "seg_sort": 0, "seg_merge": 0, "loms_merge2": 0,
                          "loms_sort": 0, "grid_merge2": 0, "kway_merge": 0}


@pytest.mark.parametrize("threads", [512, 128])
@pytest.mark.parametrize("group", [0, 2, 4, 32])
@pytest.mark.parametrize("rows,v,k,block", [(1, 151_936, 64, 64), (8, 151_936, 64, 64),
                                            (4, 151_936, 64, 16), (3, 3000, 200, 128),
                                            (2, 151_936, 256, 128), (4, 151_936, 16, 16)])
def test_vocab_merge_tree_matches_plain(cuda, monkeypatch, threads, group, rows, v, k,
                                        block):
    """The tree in its plan's launches and at forced subtrees of 2, 4 and
    32 lists, in CTAs of 512 and 128 threads (other runs a thread),
    against the chained plain levels: values and indices."""
    from repro_torch.kernels import launch

    monkeypatch.setattr(launch, "VOCAB_GROUP", group)
    monkeypatch.setattr(K, "TREE_THREADS", threads)
    x = _logits(rows, v, torch.bfloat16, seed=rows).to(cuda)
    keys, idx = K.vocab_phase1(x, k, block)
    K.reset_launch_counts()
    got = K.vocab_merge_tree(keys, idx, k, torch.bfloat16)
    assert K.LAUNCHES["vocab_merge_level"] == K.vocab_merge_launches(v, block, k)
    _same(got, K.vocab_merge_tree_plain(keys, idx, k, torch.bfloat16))


def test_wrapper_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        K.router_topk(torch.zeros(4, 64, dtype=torch.int32, device=cuda), 4)
    with pytest.raises(ValueError):
        K.vocab_topk(torch.zeros(4, 2048, device=cuda)[:, ::2], 4)


def _class_tile(rows, w, dtype, seed):
    """A class tile with heavy ties; floats also NaN, ±inf and ±0.0."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = rng.integers(-3, 4, (rows, w)).astype(np.int32)
        x[rng.random((rows, w)) < 0.05] = np.iinfo(np.int32).max
        return torch.from_numpy(x)
    x = (rng.integers(-3, 4, (rows, w)) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random((rows, w)) < frac] = val
    return torch.from_numpy(x).to(dtype)


def _lens(rows, w, seed):
    lens = np.random.default_rng(seed).integers(0, w + 1, (rows, 1)).astype(np.int32)
    lens[0], lens[1] = w, 0
    return torch.from_numpy(lens)


def _same_all(want, got):
    for a, b in zip((want[0], want[1]) + tuple(want[2]), (got[0], got[1]) + tuple(got[2])):
        assert torch.equal(_bits(a.cpu()) if a.dtype.is_floating_point else a.cpu(),
                           _bits(b.cpu()) if b.dtype.is_floating_point else b.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("w", [2, 16, 64, 128, 256, 1024])
@pytest.mark.parametrize("flip", [False, True])
def test_seg_sort_kernel_matches_plain(cuda, dtype, w, flip):
    x = _class_tile(21, w, dtype, seed=w)
    lens = _lens(21, w, seed=w + 1)
    pay = (torch.arange(21 * w * 3, dtype=torch.int32).reshape(21, w, 3),
           _class_tile(21, w, torch.bfloat16, seed=w + 2))
    for fam in capable_families("sort", (w,)):
        want = SK.segment_class_sort_plain(x, lens, pay, k_out=max(1, w // 3),
                                           network=fam, flip=flip, want_perm=True)
        got = SK.segment_class_sort(x.to(cuda), lens.to(cuda), [p.to(cuda) for p in pay],
                                    k_out=max(1, w // 3), network=fam, flip=flip,
                                    want_perm=True)
        _same_all(want, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("wa,wb", [(16, 16), (64, 256), (512, 512)])
@pytest.mark.parametrize("flip", [False, True])
def test_seg_merge_kernel_matches_plain(cuda, dtype, wa, wb, flip):
    la, lb = _lens(9, wa, seed=wa), _lens(9, wb, seed=wb + 3)
    a = SK.segment_class_sort_plain(_class_tile(9, wa, dtype, seed=1), la, flip=flip)[0]
    b = SK.segment_class_sort_plain(_class_tile(9, wb, dtype, seed=2), lb, flip=flip)[0]
    pay = (torch.arange(9 * (wa + wb), dtype=torch.int32).reshape(9, wa + wb),)
    for fam in capable_families("merge2", (wa, wb)):
        want = SK.segment_class_merge_plain(a, b, la, lb, pay, network=fam, flip=flip,
                                            want_perm=True)
        got = SK.segment_class_merge(a.to(cuda), b.to(cuda), la.to(cuda), lb.to(cuda),
                                     [p.to(cuda) for p in pay], network=fam, flip=flip,
                                     want_perm=True)
        _same_all(want, got)


def test_segment_topk_launches_one_class_sort(cuda):
    K.reset_launch_counts()
    x = _logits(4, 256, torch.float32).to(cuda).reshape(-1)
    vals, idx, offs = repro_torch.segment_topk(x, (0, 256, 512, 768, 1024), (64, 16, 8, 1))
    want = repro_torch.segment_topk(x.cpu(), (0, 256, 512, 768, 1024), (64, 16, 8, 1))
    assert torch.equal(_bits(vals.cpu()), _bits(want[0])) and torch.equal(idx.cpu(), want[1])
    assert offs == want[2]
    assert K.LAUNCHES["seg_sort"] == 1 and K.LAUNCHES["seg_merge"] == 0


def test_class_kernels_reject_bad_input(cuda):
    with pytest.raises(TypeError):
        SK.segment_class_sort(torch.zeros(2, 8, dtype=torch.float64, device=cuda),
                              torch.zeros(2, 1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        SK.segment_class_sort(torch.zeros(2, 12, device=cuda),
                              torch.zeros(2, 1, dtype=torch.int32, device=cuda))


def _sorted_rows(rows, n, dtype, seed, descending=False):
    """Rows of a class tile in the total order of their keys."""
    from repro_torch.kernels.common import encode_key_values, take_along

    x = _class_tile(rows, n, dtype, seed)
    order = torch.argsort(encode_key_values(x) if dtype.is_floating_point else x,
                          dim=-1, stable=True)
    return take_along(x, 1, order.flip(-1) if descending else order)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("m,n", [(8, 8), (16, 48), (512, 512), (4096, 32), (20_000, 40)])
@pytest.mark.parametrize("desc", [False, True])
def test_loms_merge2_kernel_matches_plain(cuda, dtype, m, n, desc):
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain

    rows = 7
    a = _sorted_rows(rows, m, dtype, 1, desc)
    b = _sorted_rows(rows, n, dtype, 2, desc)
    pay = (torch.arange(rows * (m + n) * 3, dtype=torch.int32).reshape(rows, m + n, 3),
           _class_tile(rows, m + n, torch.bfloat16, seed=3))
    key = dtype if dtype.is_floating_point else None
    fams = capable_families("merge2", (m, n)) if m + n <= 1024 else ("loms",)
    for fam in fams:
        kw = dict(network=fam, n_cols=pick_merge_cols(m, n),
                  key_dtype=key, descending=desc, want_perm=True)
        want = loms_merge2_plain(a, b, pay, **kw)
        got = loms_merge2(a.to(cuda), b.to(cuda), [p.to(cuda) for p in pay], **kw)
        _same_all(want, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n", [1, 2, 37, 128, 1007, 1024])
@pytest.mark.parametrize("desc", [False, True])
def test_loms_sort_kernel_matches_plain(cuda, dtype, n, desc):
    from repro_torch.kernels.common import ceil_pow2
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain

    rows = 9
    x = _class_tile(rows, n, dtype, seed=n)
    pay = (torch.arange(rows * n * 2, dtype=torch.int32).reshape(rows, n, 2),
           _class_tile(rows, n, torch.bfloat16, seed=n + 1))
    key = dtype if dtype.is_floating_point else None
    for fam in capable_families("sort", (ceil_pow2(n),)):
        kw = dict(network=fam, key_dtype=key, descending=desc, want_perm=True)
        want = loms_sort_plain(x, pay, **kw)
        got = loms_sort(x.to(cuda), [p.to(cuda) for p in pay], **kw)
        _same_all(want, got)


@pytest.mark.parametrize("na,nb", [(1000, 300), (37, 0), (0, 5), (4096, 4096),
                                   (100_000, 3)])
def test_grid_merge_kernel_matches_plain(cuda, na, nb):
    """int32 keys with their extremes, and float rows as keys: on rows
    without NaN and without -0.0 tied to +0.0 the card's key merge is the
    plain carry loop's raw-float merge."""
    from repro_torch.streaming.grid_merge import grid_chunked_merge2, grid_chunked_merge2_plain

    for dtype in (torch.int32, torch.float32):
        a = _sorted_rows(3, na, dtype, 5)
        b = _sorted_rows(3, nb, dtype, 6)
        if dtype.is_floating_point:  # finite, no NaN, no -0.0
            a = torch.nan_to_num(a, nan=1.0, posinf=2.0, neginf=-2.0) + 0.0
            b = torch.nan_to_num(b, nan=1.0, posinf=2.0, neginf=-2.0) + 0.0
            a, b = a.sort(-1)[0], b.sort(-1)[0]
        want = grid_chunked_merge2_plain(a, b, tile=64)
        got = grid_chunked_merge2(a.to(cuda), b.to(cuda), tile=64)
        assert torch.equal(_bits(got.cpu()) if dtype.is_floating_point else got.cpu(),
                           _bits(want) if dtype.is_floating_point else want)


@pytest.mark.parametrize("items", [0, 1, 3])
def test_grid_merge_row_views_and_tiles(cuda, monkeypatch, items):
    """Rows read in place from one buffer, merged into a view of another,
    at the kernel's tile and at forced tiles of 256 and 768 outputs."""
    from repro_torch.kernels import launch
    from repro_torch.streaming.grid_merge import (grid_chunked_merge2, grid_chunked_merge2_plain,
                                                  grid_merge2_rows)

    monkeypatch.setattr(launch, "GRID_ITEMS", items)
    buf = torch.cat([_sorted_rows(4, n, torch.int32, n) for n in (1701, 1299, 5000, 3)], 1)
    a, b = buf[:, :1701], buf[:, 1701:3000]
    want = grid_chunked_merge2_plain(a.contiguous(), b.contiguous(), tile=512)
    out = torch.full((4, 2, 3000), 7, dtype=torch.int32, device=cuda)
    gb = buf.to(cuda)
    grid_merge2_rows(gb[:, None, :1701], gb[:, None, 1701:3000], out[:, 1:])
    assert torch.equal(out[:, 1].cpu(), want) and bool((out[:, 0] == 7).all())
    c, d = buf[:, 3000:8000], buf[:, 8000:]
    assert torch.equal(grid_chunked_merge2_plain(c.contiguous(), d.contiguous(), tile=512),
                       grid_chunked_merge2(gb[:, 3000:8000], gb[:, 8000:]).cpu())


@pytest.mark.parametrize("ln,merges", [(1100, 2), (2500, 3), (65_536, 7)])
def test_sort_spill_one_launch_a_level(cuda, ln, merges):
    """The values-only sort spill of c runs of 512 merges one level a
    launch (3 runs: 2 launches, 5: 3, 128: 7), bit-equal to the CPU's."""
    x = _class_tile(2, ln, torch.float32, seed=ln).reshape(-1)
    offs = (0, ln, 2 * ln)
    K.reset_launch_counts()
    got = repro_torch.segment_sort(x.to(cuda), offs)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["seg_sort"], K.LAUNCHES["grid_merge2"]) == (1, merges)
    assert torch.equal(_bits(got.cpu()), _bits(repro_torch.segment_sort(x, offs)))


def test_merge_and_sort_launch_their_kernels(cuda):
    K.reset_launch_counts()
    x = _class_tile(4, 64, torch.float32, seed=0).to(cuda)
    a, b = repro_torch.sort(x[:2]), repro_torch.sort(x[2:])
    got = repro_torch.merge(a, b)
    want = repro_torch.merge(a.cpu(), b.cpu())
    assert torch.equal(_bits(got.cpu()), _bits(want))
    long_a = repro_torch.sort(torch.randn(1, 1000, device=cuda))
    repro_torch.merge(long_a.expand(3, 1000).contiguous().repeat(1, 4).sort(-1)[0],
                      long_a.expand(3, 1000).contiguous().repeat(1, 4).sort(-1)[0])
    assert (K.LAUNCHES["loms_sort"], K.LAUNCHES["loms_merge2"],
            K.LAUNCHES["grid_merge2"]) == (3, 1, 1)


def _sorted_lists(rows, lens, dtype, seed, descending=False):
    """The concatenation of ``len(lens)`` sorted lists, each in the total
    order of its keys."""
    return torch.cat([_sorted_rows(rows, n, dtype, seed + j, descending)
                      for j, n in enumerate(lens)], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("lens", [(7, 7, 7), (3,) * 8, (64,) * 4, (100, 50, 25),
                                  (5,) * 5, (128,) * 8, (181,) * 8])
@pytest.mark.parametrize("desc", [False, True])
def test_kway_kernel_matches_plain(cuda, dtype, lens, desc):
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.networks import kway_schedule

    rows, total = 5, sum(lens)
    x = _sorted_lists(rows, lens, dtype, 11, desc)
    pay = (torch.arange(rows * total * 3, dtype=torch.int32).reshape(rows, total, 3),
           _class_tile(rows, total, torch.bfloat16, seed=4))
    sched = kway_schedule(lens)
    key = dtype if dtype.is_floating_point else None
    for n_stages in (None, 2):
        kw = dict(n_stages=n_stages, lens=lens, key_dtype=key, descending=desc,
                  want_perm=True)
        want = kway_merge_plain(x, sched, pay, **kw)
        got = kway_merge(x.to(cuda), sched, [p.to(cuda) for p in pay], **kw)
        _same_all(want, got)


def test_kway_kernel_runs_mwms_and_median_schedules(cuda):
    from repro_torch.core import mwms_kway
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import median_schedule

    lens = (7, 7, 7)
    x = _sorted_lists(64, lens, torch.int32, 21)
    med, pos = median_schedule(lens)
    for sched in (mwms_kway(lens), med, median_readout(med, pos)):
        want = kway_merge_plain(x, sched, want_perm=True)
        _same_all(want, kway_merge(x.to(cuda), sched, want_perm=True))


def test_merge_k_median_and_chunked_merge_k_launch_row_8(cuda):
    """The library's k-way calls on card tensors equal the same calls on
    the CPU (the plain versions), one row-8 launch each."""
    K.reset_launch_counts()
    lists = [_sorted_rows(6, 7, torch.float32, seed) for seed in range(3)]
    got = repro_torch.merge_k([t.to(cuda) for t in lists])
    assert torch.equal(_bits(got.cpu()), _bits(repro_torch.merge_k(lists)))
    got = repro_torch.median_of_lists([t.to(cuda) for t in lists])
    assert torch.equal(_bits(got.cpu()), _bits(repro_torch.median_of_lists(lists)))
    desc = [_sorted_rows(5, 64, torch.bfloat16, seed, descending=True) for seed in range(4)]
    ids = [torch.arange(5 * 64, dtype=torch.int32).reshape(5, 64) + 1000 * j
           for j in range(4)]
    gv, gp = repro_torch.merge_k([t.to(cuda) for t in desc], descending=True,
                                 payload=[i.to(cuda) for i in ids])
    wv, wp = repro_torch.merge_k(desc, descending=True, payload=ids)
    assert torch.equal(_bits(gv.cpu()), _bits(wv)) and torch.equal(gp.cpu(), wp)
    runs = [_sorted_rows(2, n, torch.int32, n) for n in (1000, 700, 3000)]
    got = repro_torch.chunked_merge_k([t.to(cuda) for t in runs])
    assert torch.equal(got.cpu(), torch.sort(torch.cat(runs, dim=1), dim=1)[0])
    assert K.LAUNCHES["kway_merge"] == 4
    assert sum(K.LAUNCHES.values()) == 4


@pytest.fixture
def sort_lanes():
    """Force the lanes a thread of the sort executor (rows 2 and 6)."""
    from repro_torch.kernels import launch

    old = launch.SORT_LANES
    yield lambda lanes: setattr(launch, "SORT_LANES", lanes)
    launch.SORT_LANES = old


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [8, 64, 100, 1024, 2048, 5000, 8192])
def test_sort_executor_layouts_match_plain(cuda, sort_lanes, lanes, n):
    """Rows 2 and 6 with ER lanes a thread in one or more chunks (2048 to
    8192 wide rows: several chunks), every capable family."""
    from repro_torch.kernels.common import ceil_pow2
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain

    sort_lanes(lanes)
    w = ceil_pow2(n)
    x = _class_tile(5, n, torch.bfloat16, seed=n)
    pay = (torch.arange(5 * n, dtype=torch.int32).reshape(5, n),)
    for fam in capable_families("sort", (w,)):
        for desc in (False, True):
            kw = dict(network=fam, key_dtype=torch.bfloat16, descending=desc,
                      want_perm=True)
            _same_all(loms_sort_plain(x, pay, **kw),
                      loms_sort(x.to(cuda), [p.to(cuda) for p in pay], **kw))
        if w <= 1024:
            xs = _class_tile(5, w, torch.int32, seed=w)
            lens = _lens(5, w, seed=w)
            for flip in (False, True):
                kw = dict(k_out=max(1, w // 2), network=fam, flip=flip, want_perm=True)
                _same_all(SK.segment_class_sort_plain(xs, lens, **kw),
                          SK.segment_class_sort(xs.to(cuda), lens.to(cuda), **kw))


def _special_rows(rows, n, dtype, seed, sort):
    """Rows with -0.0 / +0.0 mixes, all-negative rows with a -0.0, ±inf,
    one and several NaNs (sorted in raw-float order when ``sort``)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (rows, n)) * 0.5).astype(np.float32)
    x[0] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    x[1] = -np.abs(x[1]) - 1.0
    x[1, rng.integers(n)] = -0.0
    x[2, rng.integers(n)] = np.inf
    x[3, rng.integers(n)] = -np.inf
    x[4, rng.integers(n)] = np.nan
    x[5, rng.integers(0, n, 3)] = np.nan
    x[6, 0] = -0.0
    x[7] = -(np.arange(n, dtype=np.float32) + 1.0)
    x[7, 0] = -0.0
    x = np.sort(x, axis=-1) if sort else x
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(4, 4), (32, 32), (64, 32), (1000, 24)])
@pytest.mark.parametrize("desc", [False, True])
def test_raw_float_merge_kernel_matches_plain(cuda, dtype, m, n, desc):
    """Row 1 in the raw-float mode: NaN bits compared too (both sides
    write the canonical NaN)."""
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain

    a, b = _special_rows(12, m, dtype, 1, True), _special_rows(12, n, dtype, 2, True)
    if desc:
        a, b = a.flip(-1).contiguous(), b.flip(-1).contiguous()
    for fam in capable_families("merge2", (m, n)):
        kw = dict(network=fam, n_cols=pick_merge_cols(m, n), use_mxu=True,
                  descending=desc, want_perm=True)
        _same_all(loms_merge2_plain(a, b, **kw), loms_merge2(a.to(cuda), b.to(cuda), **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 37, 1007, 1024])
@pytest.mark.parametrize("want_perm", [False, True])
def test_raw_float_sort_kernel_matches_plain(cuda, dtype, n, want_perm):
    from repro_torch.kernels.common import ceil_pow2
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain

    x = _special_rows(12, n, dtype, n, False)
    for fam in capable_families("sort", (ceil_pow2(n),)):
        for desc in (False, True):
            kw = dict(network=fam, use_mxu=True, descending=desc, want_perm=want_perm)
            want, got = loms_sort_plain(x, **kw), loms_sort(x.to(cuda), **kw)
            assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
            assert (got[1] is None) == (want[1] is None)
            if want_perm:
                assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [(7, 7, 7), (3,) * 8, (64,) * 4])
def test_raw_float_kway_kernel_matches_plain(cuda, dtype, lens):
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import kway_schedule, median_schedule

    x = torch.cat([_special_rows(12, n, dtype, 30 + j, True) for j, n in enumerate(lens)],
                  dim=1)
    scheds = [kway_schedule(lens)]
    if len(set(lens)) == 1 and len(lens) % 2 and lens[0] % 2:
        med, pos = median_schedule(lens)
        scheds += [med, median_readout(med, pos)]
    for sched in scheds:
        for n_stages in (None, 1):
            kw = dict(n_stages=n_stages, use_mxu=True, want_perm=True)
            _same_all(kway_merge_plain(x, sched, **kw), kway_merge(x.to(cuda), sched, **kw))


def test_values_only_wrappers_take_the_raw_float_mode(cuda):
    """``kernels.ops`` on card rows equals the same call on the CPU."""
    from repro_torch.kernels import ops

    a = _special_rows(12, 32, torch.float32, 1, True)
    b = _special_rows(12, 32, torch.float32, 2, True)
    x = _special_rows(12, 1007, torch.bfloat16, 3, False)
    lists = [_special_rows(12, 7, torch.float32, 4 + j, True) for j in range(3)]
    cuda_lists = [t.to(cuda) for t in lists]
    for got, want in ((ops.merge2(a.to(cuda), b.to(cuda)), ops.merge2(a, b)),
                      (ops.sort(x.to(cuda)), ops.sort(x)),
                      (ops.merge_k(cuda_lists), ops.merge_k(lists)),
                      (ops.median_k(cuda_lists), ops.median_k(lists))):
        assert torch.equal(_bits(got.cpu()), _bits(want))


def _one_launch(name, fn):
    """fn() with the launch counts zeroed before: exactly one launch of
    kernel ``name``."""
    K.reset_launch_counts()
    got = fn()
    assert K.LAUNCHES[name] == 1 and sum(K.LAUNCHES.values()) == 1, dict(K.LAUNCHES)
    return got


KWAY_LIBRARY_SCHEDULES = {  # chip_smoke.py phase 3f: (lens, dtype, descending, ids, median)
    "3x7 f32": ((7, 7, 7), torch.float32, False, False, False),
    "3x7 f32 median": ((7, 7, 7), torch.float32, False, False, True),
    "4x64 bf16 desc + ids": ((64,) * 4, torch.bfloat16, True, True, False),
    "8x128 int32": ((128,) * 8, torch.int32, False, False, False),
    "100_50_25 f32": ((100, 50, 25), torch.float32, False, False, False),
    "5x7 f32 median": ((7,) * 5, torch.float32, False, False, True),
}


@pytest.mark.parametrize("name", list(KWAY_LIBRARY_SCHEDULES))
def test_kway_executor_paths_match_plain(cuda, name):
    """Row 8 at the schedules of the library's main paths, in the modes it
    calls them: the schedules of at most 64 cells a thread a row, the
    others G rows a CTA with the warp sorts of their column stages (and of
    4 x 64's and 8 x 128's stage-0 runs of 16); one launch a call."""
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import kway_schedule, median_schedule

    lens, dtype, desc, ids, median = KWAY_LIBRARY_SCHEDULES[name]
    rows, total = 40, sum(lens)
    x = _sorted_lists(rows, lens, dtype, 61, desc)
    pay = ((torch.arange(rows * total, dtype=torch.int32).reshape(rows, total),)
           if ids else ())
    sched = median_readout(*median_schedule(lens)) if median else kway_schedule(lens)
    key = dtype if dtype.is_floating_point else None
    kw = dict(key_dtype=key, want_perm=True)
    if not median:
        kw.update(lens=lens, descending=desc)
    want = kway_merge_plain(x, sched, pay, **kw)
    got = _one_launch("kway_merge", lambda: kway_merge(x.to(cuda), sched,
                                                       [p.to(cuda) for p in pay], **kw))
    _same_all(want, got)


def test_kway_chunked_segments_with_fill_keys(cuda):
    """The chunked_merge_k segment rows: 8 sorted runs of 128 int32 keys,
    each padded with INT32_MAX fill, and genuine INT32_MAX keys."""
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.networks import kway_schedule

    x = _sorted_lists(64, (128,) * 8, torch.int32, 71)
    fill = torch.arange(128)[None, :] >= torch.randint(0, 129, (64 * 8, 1),
                                                       generator=torch.Generator().manual_seed(0))
    x = torch.where(fill.reshape(64, 8, 128), torch.iinfo(torch.int32).max,
                    x.reshape(64, 8, 128)).reshape(64, 1024)
    sched = kway_schedule((128,) * 8)
    want = kway_merge_plain(x, sched, want_perm=True)
    got = _one_launch("kway_merge", lambda: kway_merge(x.to(cuda), sched, want_perm=True))
    _same_all(want, got)


@pytest.fixture
def merge_tile():
    """Force the rows a tile of the tiled 2-way merge (row 1)."""
    from repro_torch.kernels import launch

    old = launch.MERGE_TILE
    yield lambda rows: setattr(launch, "MERGE_TILE", rows)
    launch.MERGE_TILE = old


@pytest.mark.parametrize("tile", [1, 3, 16])
@pytest.mark.parametrize("m,n", [(8, 8), (16, 48), (512, 512), (1000, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_tiled_merge_on_short_rows_matches_plain(cuda, merge_tile, tile, m, n, dtype):
    """Row 1's tiled kernel forced onto short rows at small tiles, so that
    several CTAs share a row: loms and s2ms, both orders, payload lanes;
    one launch a call."""
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain

    merge_tile(tile)
    rows = 6
    pay = (torch.arange(rows * (m + n) * 2, dtype=torch.int32).reshape(rows, m + n, 2),
           _class_tile(rows, m + n, torch.bfloat16, seed=9))
    key = dtype if dtype.is_floating_point else None
    for desc in (False, True):
        a = _sorted_rows(rows, m, dtype, 7, desc)
        b = _sorted_rows(rows, n, dtype, 8, desc)
        for fam in ("loms", "s2ms"):
            kw = dict(network=fam, n_cols=pick_merge_cols(m, n), key_dtype=key,
                      descending=desc, want_perm=True)
            want = loms_merge2_plain(a, b, pay, **kw)
            got = _one_launch("loms_merge2", lambda: loms_merge2(
                a.to(cuda), b.to(cuda), [p.to(cuda) for p in pay], **kw))
            _same_all(want, got)


@pytest.mark.parametrize("desc", [False, True])
def test_tiled_merge_long_row_matches_plain(cuda, desc):
    """(4, 65,536 + 32) f32, past a CTA's shared memory: the plan's tiles,
    int32 ids as a payload; one launch."""
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain

    m, n, rows = 65_536, 32, 4
    a = _sorted_rows(rows, m, torch.float32, 17, desc)
    b = _sorted_rows(rows, n, torch.float32, 18, desc)
    ids = (torch.arange(rows * (m + n), dtype=torch.int32).reshape(rows, m + n),)
    for fam in ("loms", "s2ms"):
        kw = dict(network=fam, n_cols=pick_merge_cols(m, n), key_dtype=torch.float32,
                  descending=desc, want_perm=True)
        want = loms_merge2_plain(a, b, ids, **kw)
        got = _one_launch("loms_merge2", lambda: loms_merge2(
            a.to(cuda), b.to(cuda), [p.to(cuda) for p in ids], **kw))
        _same_all(want, got)


@pytest.mark.parametrize("lens", [(3,) * 8, (64,) * 4, (128,) * 8])
def test_kway_executors_on_unsorted_lists_match_the_emulation(cuda, lens):
    """Lists that break the sorted-input contract, where a warp sort's vote
    fails and it sorts its group from level 2: the kernel equals the CPU
    emulation of its executors (tests/test_torch_kway_pairs.py). (The
    binary searches of an S2MS group, like the reference's counts, give
    colliding ranks on unsorted runs; 3 x 8's runs are single cells.)"""
    from test_torch_kway_pairs import kway_emulated

    from repro_torch.kernels.kway import kway_merge
    from repro_torch.networks import kway_schedule

    sched = kway_schedule(lens)
    x = _class_tile(24, sum(lens), torch.int32, seed=5)
    x[:12] = _sorted_lists(12, lens, torch.int32, 31)  # half the rows keep the contract
    for n_stages in (None, 1):
        want = kway_emulated(x, sched, n_stages=n_stages)
        got = kway_merge(x.to(cuda), sched, n_stages=n_stages, want_perm=True)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
