"""On-card tests of the port's CUDA kernels (top-k, segmented class sort
and merge, the 2-way merge, the fused sort, the grid merge, the k-way
merge) against their plain versions, in the key mode and in the
reference's raw-float mode (``use_mxu=True``: rows 1, 2 and 8), the
sort executor of rows 2 and 6 at every lanes-a-thread layout, the
row-merge executor of rows 1 and 7 at every threads a row, rows 3-7
with -0.0 and +0.0 tied (``zero_ties``, ``nan_policy="unsafe"``; rows
3-5 also where the reference's one-hot permute keeps -0.0), rows 3-5 on
raw int32 keys (``INT32_MIN`` tying the pads), and
``chunked_merge(mode="loop")``, one launch of row 1 a tile.

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
                                            (4, 256, 64, 64), (1, 256, 64, 64),
                                            (4096, 256, 16, 16), (4096, 128, 8, 16),
                                            (5, 320, 40, 64), (6, 384, 5, 64),
                                            (7, 300, 8, 15), (3, 512, 100, 512),
                                            (3, 384, 30, 192), (2, 512, 512, 1)])
def test_router_kernel_matches_plain(cuda, dtype, rows, e, k, block):
    """List counts that are not powers of two (5, 6, 20, 2 at block 192),
    blocks that are not (15, 192), the shared-memory widths (192, 512):
    one launch a call."""
    x = _logits(rows, e, dtype).to(cuda)
    K.reset_launch_counts()
    got = K.router_topk(x, k, block=block)
    assert K.LAUNCHES["router_topk"] == 1
    _same(got, K.router_topk_plain(x, k, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,v,k,block", [(4, 151_936, 64, 64), (8, 151_936, 16, 16),
                                            (4, 151_936, 256, 128), (2, 20_000, 64, 256),
                                            (2, 20_000, 64, 1024), (3, 3000, 8, 100),
                                            (2, 5000, 40, 64), (1, 50, 8, 64),
                                            (2, 1000, 5, 3)])
def test_phase1_kernel_matches_plain(cuda, dtype, rows, v, k, block):
    """Phase 1 alone, lists and padding blocks: the serving shapes, the
    shared-memory widths (256, 1024), blocks that are not powers of two,
    one block (decoded values); one launch a call."""
    x = _logits(rows, v, dtype, seed=v + block).to(cuda)
    K.reset_launch_counts()
    got = K.vocab_phase1(x, k, block)
    assert K.LAUNCHES["vocab_phase1"] == 1
    _same(got, K.vocab_phase1_plain(x, k, block))


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


def _int_rows(rows, n, seed=0):
    """int32 rows heavy in INT32_MIN (which ties the pads), with INT32_MAX."""
    vals = np.array([-2 ** 31, -2 ** 31, -2 ** 31 + 1, -5, 0, 3, 3, 2 ** 31 - 1], np.int64)
    return torch.from_numpy(np.random.default_rng(seed).choice(vals, (rows, n)).astype(np.int32))


@pytest.mark.parametrize("rows,e,k,block", [(64, 256, 16, 16), (33, 96, 96, 32),
                                            (8, 48, 40, 16), (4096, 128, 8, 16),
                                            (4, 512, 300, 256)])
def test_router_kernel_int32_matches_plain(cuda, rows, e, k, block):
    x = _int_rows(rows, e, e + k)
    got = K.router_topk(x.to(cuda), k, block=block)
    assert got[0].dtype == torch.int32
    _same(got, K.router_topk_plain(x, k, block))


@pytest.mark.parametrize("rows,v,k,block", [(4, 151_936, 64, 64), (8, 530, 530, 16),
                                            (4, 700, 1000, 128), (3, 2000, 64, 256),
                                            (2, 600, 64, 1024)])
def test_vocab_kernels_int32_match_plain(cuda, rows, v, k, block):
    x = _int_rows(rows, v, v + k)
    _same(K.vocab_phase1(x.to(cuda), k, block), K.vocab_phase1_plain(x, k, block))
    _same(K.vocab_topk(x.to(cuda), k, block=block), K.vocab_topk_plain(x, k, block))


def _negative_rows(rows, n, dtype, seed=0):
    """Rows of -1.5, -0.5 and -0.0, every third row with +0.0 and 0.5 too."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.5, -0.5, -0.0], np.float32), size=(rows, n))
    x[::3] = rng.choice(np.array([-1.5, -0.5, -0.0, 0.0, 0.5], np.float32), size=x[::3].shape)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("e,block,k", [(6, 6, 3), (8, 4, 2), (24, 3, 1), (16, 4, 3),
                                       (8, 4, 4)])
def test_router_kernel_signed_zeros_match_plain(cuda, dtype, e, block, k):
    x = _negative_rows(4096 if e == 16 else 9, e, dtype, e * k)
    _same(K.router_topk(x.to(cuda), k, block=block, zero_ties=True),
          K.router_topk_plain(x, k, block, zero_ties=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,block,k", [(600, 4, 2), (520, 3, 1), (6, 6, 3), (600, 4, 4)])
def test_vocab_kernels_signed_zeros_match_plain(cuda, dtype, v, block, k):
    x = _negative_rows(9, v, dtype, v + k)
    _same(K.vocab_topk(x.to(cuda), k, block=block, zero_ties=True),
          K.vocab_topk_plain(x, k, block, zero_ties=True))


def test_wrapper_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        K.router_topk(torch.zeros(4, 64, dtype=torch.int16, device=cuda), 4)
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


@pytest.fixture
def row_threads():
    """Force the threads a row of the row-merge executor (rows 1 and 7)."""
    from repro_torch.kernels import launch

    old = launch.MERGE_ROW_THREADS
    yield lambda t: setattr(launch, "MERGE_ROW_THREADS", t)
    launch.MERGE_ROW_THREADS = old


def _extreme_tile(rows, w, dtype, seed):
    """``_class_tile`` whose int32 rows also hold INT32_MIN: a descending
    key ``~INT32_MIN`` ties the class merge's sentinel as INT32_MAX does an
    ascending one."""
    x = _class_tile(rows, w, dtype, seed)
    if dtype == torch.int32:
        x[torch.from_numpy(np.random.default_rng(seed + 1).random((rows, w)) < 0.05)] = \
            np.iinfo(np.int32).min
    return x


@pytest.mark.parametrize("threads", [0, 4, 8, 32, 64, 256])
@pytest.mark.parametrize("m,n,fam,n_cols", [(32, 32, "loms", None), (64, 8, "loms", None),
                                            (5, 3, "s2ms", None), (64, 64, "loms", 16),
                                            (48, 24, "loms", 3), (512, 512, "loms", None),
                                            (1000, 24, "loms", None), (64, 1, "loms", None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int32])
def test_merge_rows_kernel_matches_plain(cuda, row_threads, threads, m, n, fam, n_cols,
                                         dtype):
    """Row 1's shared-memory rows on the row-merge executor at the plan's
    threads a row and at 4, 8, 32, 64 and 256: C = 1, 2, 3 (not a power of
    two), 4, 16, both orders, a 3-D and a bf16 payload lane; one launch a
    call."""
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain

    row_threads(threads)
    rows = 11
    n_cols = pick_merge_cols(m, n) if n_cols is None else n_cols
    pay = (torch.arange(rows * (m + n) * 3, dtype=torch.int32).reshape(rows, m + n, 3),
           _class_tile(rows, m + n, torch.bfloat16, seed=4))
    key = dtype if dtype.is_floating_point else None
    for desc in (False, True):
        a = _sorted_rows(rows, m, dtype, 21, desc)
        b = _sorted_rows(rows, n, dtype, 22, desc)
        kw = dict(network=fam, n_cols=n_cols, key_dtype=key, descending=desc, want_perm=True)
        want = loms_merge2_plain(a, b, pay, **kw)
        got = _one_launch("loms_merge2", lambda: loms_merge2(
            a.to(cuda), b.to(cuda), [p.to(cuda) for p in pay], **kw))
        _same_all(want, got)
        values_only = loms_merge2(a.to(cuda), b.to(cuda), network=fam, n_cols=n_cols,
                                  key_dtype=key, descending=desc)
        assert values_only[1] is None
        assert torch.equal(_bits(values_only[0].cpu()), _bits(want[0]))


@pytest.mark.parametrize("threads", [0, 4, 16, 32, 256])
@pytest.mark.parametrize("wa,wb", [(64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (64, 32),
                                   (64, 64), (1024, 1024), (4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int32])
def test_seg_merge_rows_kernel_matches_plain(cuda, row_threads, threads, wa, wb, dtype):
    """The class merge of the single-level programs (loms, s2ms) on the
    row-merge executor: phase 3d's classes and the widest, lengths from 0
    to full (and all rows full), k_out below and at the width, both
    orders, two payload lanes, int32 keys that tie the sentinel; one launch
    a call."""
    row_threads(threads)
    rows = 13
    pay = (torch.arange(rows * (wa + wb) * 2, dtype=torch.int32).reshape(rows, wa + wb, 2),
           _class_tile(rows, wa + wb, torch.bfloat16, seed=6))
    for full in (False, True):
        la = torch.full((rows, 1), wa, dtype=torch.int32) if full else _lens(rows, wa, wa)
        lb = torch.full((rows, 1), wb, dtype=torch.int32) if full else _lens(rows, wb, wb + 1)
        for flip in (False, True):
            a = SK.segment_class_sort_plain(_extreme_tile(rows, wa, dtype, 1), la, flip=flip)[0]
            b = SK.segment_class_sort_plain(_extreme_tile(rows, wb, dtype, 2), lb, flip=flip)[0]
            for fam in ("loms", "s2ms"):
                for k_out in (wa + wb, max(1, (wa + wb) // 3)):
                    kw = dict(k_out=k_out, network=fam, flip=flip, want_perm=True)
                    want = SK.segment_class_merge_plain(a, b, la, lb, pay, **kw)
                    got = _one_launch("seg_merge", lambda: SK.segment_class_merge(
                        a.to(cuda), b.to(cuda), la.to(cuda), lb.to(cuda),
                        [p.to(cuda) for p in pay], **kw))
                    _same_all(want, got)


def test_seg_merge_pair_families_keep_their_kernel(cuda):
    """The pair-stage families take seg_merge_kernel (run_program), one
    launch a call, bit-equal to the plain version."""
    la, lb = _lens(9, 32, 3), _lens(9, 32, 4)
    a = SK.segment_class_sort_plain(_extreme_tile(9, 32, torch.int32, 1), la)[0]
    b = SK.segment_class_sort_plain(_extreme_tile(9, 32, torch.int32, 2), lb)[0]
    for fam in capable_families("merge2", (32, 32)):
        want = SK.segment_class_merge_plain(a, b, la, lb, network=fam, want_perm=True)
        got = _one_launch("seg_merge", lambda: SK.segment_class_merge(
            a.to(cuda), b.to(cuda), la.to(cuda), lb.to(cuda), network=fam, want_perm=True))
        _same_all(want, got)


def _signed_zeros(rows, n, dtype, seed=0, sort=False):
    """Finite rows that are mostly zeros of both signs (``nan_policy="unsafe"``)."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.5, -0.5, -0.0, 0.0, 0.5, 1.5], np.float32), size=(rows, n),
                   p=[0.1, 0.15, 0.3, 0.3, 0.1, 0.05])
    if sort:
        x = np.sort(x, -1, kind="stable")
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_ties_kernels_match_plain(cuda, dtype):
    """Rows 3-7 with -0.0 given +0.0's key: bit-equal to the plain versions."""
    x = _signed_zeros(64, 256, dtype, seed=1)
    _same(K.router_topk(x.to(cuda), 16, block=16, zero_ties=True),
          K.router_topk_plain(x, 16, 16, zero_ties=True))
    x = _signed_zeros(4, 20_000, dtype, seed=2)
    _same(K.vocab_topk(x.to(cuda), 64, block=128, zero_ties=True),
          K.vocab_topk_plain(x, 64, 128, zero_ties=True))
    x = _signed_zeros(32, 64, dtype, seed=3)
    lens = torch.from_numpy(np.random.default_rng(4).integers(0, 65, (32, 1)).astype(np.int32))
    for flip in (False, True):
        got = SK.segment_class_sort(x.to(cuda), lens.to(cuda), flip=flip, want_perm=True,
                                    zero_ties=True)
        want = SK.segment_class_sort_plain(x, lens, flip=flip, want_perm=True, zero_ties=True)
        _same(got[:2], want[:2])
    a, b = _signed_zeros(32, 64, dtype, 5, sort=True), _signed_zeros(32, 16, dtype, 6, sort=True)
    la = torch.full((32, 1), 64, dtype=torch.int32)
    lb = torch.full((32, 1), 16, dtype=torch.int32)
    got = SK.segment_class_merge(a.to(cuda), b.to(cuda), la.to(cuda), lb.to(cuda),
                                 want_perm=True, zero_ties=True)
    _same(got[:2], SK.segment_class_merge_plain(a, b, la, lb, want_perm=True, zero_ties=True)[:2])


def test_chunked_merge_loop_launches_row_1_a_tile(cuda):
    a = torch.randn(4, 3000, device=cuda).sort(-1)[0]
    b = torch.randn(4, 1000, device=cuda).sort(-1)[0]
    K.reset_launch_counts()
    got = repro_torch.chunked_merge(a, b, tile=512, mode="loop")
    assert K.LAUNCHES["loms_merge2"] == -(-4000 // 512)
    assert torch.equal(_bits(got), _bits(repro_torch.chunked_merge(a, b, tile=512)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8, torch.uint16])
def test_narrow_int_library_calls_match_cpu(cuda, dtype):
    """The narrow integer types as int32 keys on the card: ``sort`` with a
    payload, ``topk`` at the vocab width and ``merge``, bit-equal (and of
    the caller's dtype) to the same calls on CPU tensors."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(info.min, info.max + 1, (8, 1000))).to(dtype)
    x[:, :50] = info.min  # ties with the pads
    pay = torch.arange(8000, dtype=torch.int32).reshape(8, 1000)
    runs = torch.cat([torch.sort(x[:, :512])[0], torch.sort(x[:, 512:])[0]], 1)
    for call, t in ((lambda t, p: repro_torch.sort(t, payload=p), x),
                    (lambda t, p: repro_torch.topk(t, 1000), x),
                    (lambda t, p: repro_torch.merge(t[:, :512], t[:, 512:]), runs)):
        got, want = call(t.to(cuda), pay.to(cuda)), call(t, pay)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)
