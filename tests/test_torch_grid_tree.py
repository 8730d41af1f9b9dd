"""CPU checks of the decompositions of kernel rows 9 and 5 on the card.

* Row 9, the grid merge (``csrc/grid_merge.cu``): the split pass over
  whole rows and the per-thread runs inside each tile, emulated by
  ``grid_merge2_emulated`` at forced tiles of 2, 6 and 64 outputs, equal
  the plain carry loop ``grid_chunked_merge2_plain``: ties across tile
  boundaries, unequal sides, one empty side, row views of one buffer.
* The values-only sort spill merges its runs one level a launch (two
  where an odd run meets the carried rest): it equals
  ``repro.segment_sort(backend="segmented")`` (and the reference's spill
  itself at runs of 16) at 3, 5 and 128 runs a segment, with the launch
  count of each level.
* Row 5, the vocab merge tree (``csrc/topk.cu``): the grouped tree of
  ``vocab_merge_tree_emulated`` (subtrees of 2, 4, 32 lists and the
  plan's; each level merge paths over packed (key, index) words, by runs
  of outputs sized to the CTA) equals the chained
  levels ``vocab_merge_tree_plain``, and both equal
  ``vocab_topk_pallas(interpret=True)`` on small vocabularies.

The reference's planner reads an autotune cache; it is pointed at an
empty one. Tolerance: bit-equal (values compared as their bits, indices
exactly).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.topk import vocab_topk_pallas
from repro.segmented.core import _spill_sort_values as j_spill_sort_values

import repro_torch
from repro_torch.kernels import topk as K
from repro_torch.segmented import core
from repro_torch.streaming.grid_merge import (grid_chunked_merge2_plain,
                                              grid_merge2_emulated, grid_merge2_rows)


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_cache(tmp_path_factory):
    from repro.streaming.cache import AutotuneCache, set_default_cache

    path = str(tmp_path_factory.mktemp("autotune") / "autotune.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    prev = set_default_cache(AutotuneCache(path))
    yield
    set_default_cache(prev)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


def _keys(rng, rows, n, spread=4):
    """Sorted int32 rows with heavy ties and the dtype's extremes."""
    x = rng.integers(-spread, spread, (rows, n)).astype(np.int32)
    x[rng.random((rows, n)) < 0.05] = np.iinfo(np.int32).max
    x[rng.random((rows, n)) < 0.05] = np.iinfo(np.int32).min
    return torch.from_numpy(np.sort(x, axis=-1))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# ---------------------------------------------------------------------------
# row 9: the split pass and the per-thread runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("items,threads", [(1, 2), (3, 2), (4, 16)])  # tiles 2, 6, 64
@pytest.mark.parametrize("rows,na,nb", [(3, 100, 37), (2, 37, 0), (2, 0, 5), (4, 64, 64),
                                        (1, 1, 1), (3, 513, 200)])
def test_grid_split_and_runs_match_plain(items, threads, rows, na, nb):
    rng = np.random.default_rng(na * 7 + nb)
    a, b = _keys(rng, rows, na), _keys(rng, rows, nb)
    want = grid_chunked_merge2_plain(a, b, tile=64)
    got = grid_merge2_emulated(a, b, items=items, threads=threads)
    assert torch.equal(got, want)


def test_grid_ties_across_tile_boundaries():
    """Rows of one value, and runs that cross every tile edge: the split
    puts a's equal keys first (a wins ties) wherever a tile ends."""
    a = torch.tensor([[5] * 40, [1] * 13 + [5] * 27], dtype=torch.int32)
    b = torch.tensor([[5] * 33, [5] * 20 + [9] * 13], dtype=torch.int32)
    want = grid_chunked_merge2_plain(a, b, tile=16)
    for items, threads in ((1, 2), (3, 2), (5, 3)):
        assert torch.equal(grid_merge2_emulated(a, b, items=items, threads=threads), want)


def test_grid_strided_row_views():
    """a and b as column slices of one buffer (rows of stride 3000), as the
    spill reads its pairs of runs in place; the (G, P, n) row views of
    grid_merge2_rows, merged into a view of another buffer."""
    rng = np.random.default_rng(5)
    buf = torch.cat([_keys(rng, 4, 1701), _keys(rng, 4, 1299)], dim=1)
    a, b = buf[:, :1701], buf[:, 1701:]
    want = grid_chunked_merge2_plain(a.contiguous(), b.contiguous(), tile=64)
    assert torch.equal(grid_merge2_emulated(a, b, items=3, threads=2), want)
    runs = torch.cat([_keys(rng, 3, 50) for _ in range(6)], dim=1)  # (3, 6 runs of 50)
    pairs = runs.unflatten(1, (3, 100))
    out = torch.full((3, 300), -7, dtype=torch.int32)
    grid_merge2_rows(pairs[..., :50], pairs[..., 50:], out.unflatten(1, (3, 100)), tile=16)
    for p in range(3):
        sl = slice(100 * p, 100 * p + 100)
        assert torch.equal(out[:, sl], torch.sort(runs[:, sl], dim=1)[0])


# ---------------------------------------------------------------------------
# the values-only sort spill, one launch a level
# ---------------------------------------------------------------------------


def _spill_launches(c):
    m, rest, n = c, False, 0
    while m + rest > 1:
        n += (m // 2 > 0) + (m % 2 == 1 and rest)
        m, rest = m // 2, rest or m % 2 == 1
    return n


def _count_level_launches(monkeypatch):
    """Count grid_merge2_rows calls of the spill: each is one launch on the
    card."""
    calls = []
    real = core.grid_merge2_rows

    def counting(a, b, out, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, out, **kw)

    monkeypatch.setattr(core, "grid_merge2_rows", counting)
    return calls


def test_sort_spill_levels_match_reference(monkeypatch):
    """A segment of 2500 (5 runs of 512: 3 launches) through the public
    calls of both packages."""
    calls = _count_level_launches(monkeypatch)
    rng = np.random.default_rng(3)
    x = (rng.integers(-6, 7, 2500) * 0.5).astype(np.float32)
    x[rng.random(2500) < 0.05] = np.nan
    x[rng.random(2500) < 0.05] = -0.0
    offs = (0, 2500)
    want = repro.segment_sort(jnp.asarray(x), offs, backend="segmented")
    got = repro_torch.segment_sort(torch.from_numpy(x), offs)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert len(calls) == _spill_launches(5) == 3


@pytest.mark.parametrize("c,launches", [(3, 2), (128, 7)])
def test_sort_spill_runs_match_reference(monkeypatch, c, launches):
    """3 runs a row (an odd run carried, then merged with the rest), and
    128 (the 16 x 65,536 spill's count: 7 levels, one launch each, the
    pairs of a level read in place from the (rows, W) buffer); runs of 16
    so the reference's interpret mode stays quick."""
    calls = _count_level_launches(monkeypatch)
    rng = np.random.default_rng(c)
    x = (rng.integers(-20, 21, (2, c * 16)) * 0.25).astype(np.float32)
    want = j_spill_sort_values(jnp.asarray(x), descending=True, nan_policy="last", tile=16,
                               interpret=True)
    got = core._spill_sort_values(torch.from_numpy(x), True, 16)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert len(calls) == _spill_launches(c) == launches
    if c == 128:
        assert [a for a, _ in calls] == [(2, 64 >> lvl, 16 << lvl) for lvl in range(7)]
    else:  # a level of one pair and the odd run carried, then the odd pair
        assert calls == [((2, 1, 16), (2, 1, 16)), ((2, 1, 32), (2, 1, 16))]


# ---------------------------------------------------------------------------
# row 5: the grouped merge tree
# ---------------------------------------------------------------------------


def _logits(rows, v, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (rows, v)) * 0.25).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, np.nan]
    x[-1, -4:] = [-0.0, 0.0, np.inf, np.nan]
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("threads", [512, 1])
@pytest.mark.parametrize("group", [0, 2, 4, 32])
@pytest.mark.parametrize("rows,v,k,block,dtype", [
    (3, 4000, 64, 16, torch.bfloat16),   # lists of 16 that grow to 64
    (2, 5000, 64, 64, torch.float32),
    (1, 3000, 200, 128, torch.float16),  # k past the block, not a power of two
    (2, 9000, 256, 128, torch.bfloat16),
    (2, 300, 300, 16, torch.float32)])   # k past V: pads, index -1
def test_grouped_tree_matches_chained_levels(threads, group, rows, v, k, block, dtype):
    """CTAs of 512 threads (runs of 4, 2 and 1 outputs a thread, by level)
    and of 1 (runs of 4 throughout)."""
    x = _logits(rows, v, dtype, seed=v + k)
    keys, idx = K.vocab_phase1_plain(x, k, block)
    want = K.vocab_merge_tree_plain(keys, idx, k, dtype)
    got = K.vocab_merge_tree_emulated(keys, idx, k, dtype, group=group,
                                      threads=threads)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,v,k,block,dtype", [(8, 1000, 64, 16, "bfloat16"),
                                                  (8, 300, 16, 16, "float32")])
def test_grouped_tree_matches_reference(rows, v, k, block, dtype):
    np_dt = {"bfloat16": jnp.bfloat16, "float32": np.float32}[dtype]
    x = _logits(rows, v, torch.float32, seed=k).numpy().astype(np_dt)
    ref = vocab_topk_pallas(jnp.asarray(x), k=k, block=block, block_batch=8, use_mxu=False,
                            key_dtype=dtype, interpret=True)
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    keys, idx = K.vocab_phase1_plain(xt, k, block)
    for group in (2, 4):
        vs, is_ = K.vocab_merge_tree_emulated(keys, idx, k, xt.dtype, group=group)
        np.testing.assert_array_equal(_bits(vs[:, 0, :k].float()).numpy(),
                                      np.asarray(ref[0], np.float32).view(np.int32))
        np.testing.assert_array_equal(is_[:, 0, :k].numpy(), np.asarray(ref[1]))


def test_tree_plan_and_launches():
    """Two passes at the serving shapes (the largest subtrees that fit
    first), in one launch (the last CTA of a row merges the second); the
    depth stays vocab_levels."""
    assert K.vocab_merge_plan(4096, 64, 64) == (7, 5)
    assert K.vocab_merge_plan(16_384, 16, 64) == (9, 5)
    assert K.vocab_merge_plan(2048, 128, 256) == (6, 5)
    assert K.vocab_merge_plan(4096, 64, 64, group=32) == (5, 5, 2)
    assert K.vocab_merge_plan(8, 16, 16, group=2) == (1, 1, 1)
    assert K.vocab_merge_plan(1, 64, 64) == ()
    assert sum(K.vocab_merge_plan(2048, 128, 4096)) == 11  # lists of 4096 fit by twos
    for v, k in ((151_936, 64), (151_936, 16), (151_936, 256)):
        block = repro_torch.api.topk_block(v, k)
        assert K.vocab_merge_launches(v, block, k) == 1
        assert sum(K.vocab_merge_plan(K.vocab_blocks(v, block), min(k, block), k)) == \
            K.vocab_levels(v, block)
    assert K.tree_launches((6, 6)) == ((6, 6),)
    assert K.tree_launches((5, 5, 2)) == ((5, 0), (5, 2))
    assert K.tree_launches((9,)) == ((9, 0),) and K.tree_launches(()) == ()
    with pytest.raises(ValueError):
        K.vocab_merge_plan(64, 16, 16, group=3)
