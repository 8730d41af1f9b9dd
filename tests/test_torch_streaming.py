"""CPU parity of the port's streaming merge (kernel row 9) and the
values-only segmented spills against the reference.

* ``grid_chunked_merge2_plain`` (what the CPU runs, and what the CUDA
  kernel is held against on the card) equals ``grid_chunked_merge2`` in
  interpret mode: int32 keys with their extremes (``INT32_MAX`` ties the
  drain pads), empty rows, tiles from 16 to 512; and float rows. The
  reference merges float rows raw through the one-hot matrix permute,
  which turns -0.0 into +0.0, and the card merges them as keys; so the
  float rows here hold no -0.0 and no NaN.
* ``repro_torch.chunked_merge`` equals ``repro.streaming.chunked_merge``
  (grid mode) on batched and unbatched rows; ``mode="loop"`` (one 2-way
  merge a tile, the schedule merge where the plan's columns do not
  divide the tile) equals the reference's loop, -0.0 / +0.0 mixes in
  float rows included.
* The values-only ``segment_sort`` / ``segment_merge`` spills (segments
  past the 1024 class width: rows 6 + 9 on the keys) equal
  ``repro.segment_sort`` / ``segment_merge(backend="segmented")``.

Tolerance: bit-equal (values compared as their bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.streaming import chunked_merge as j_chunked_merge
from repro.streaming.grid_merge import grid_chunked_merge2

import repro_torch
from repro_torch.streaming import grid_chunked_merge2_plain


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _keys(rng, rows, n):
    x = rng.integers(-40, 40, (rows, n)).astype(np.int32)
    x[rng.random((rows, n)) < 0.05] = np.iinfo(np.int32).max
    x[rng.random((rows, n)) < 0.05] = np.iinfo(np.int32).min
    return np.sort(x, axis=-1)


@pytest.mark.parametrize("na,nb,tile", [(1000, 300, 64), (37, 0, 16), (513, 511, 512),
                                        (96, 700, 32)])
def test_grid_merge_plain_matches_reference(na, nb, tile):
    rng = np.random.default_rng(na + nb)
    a, b = _keys(rng, 3, na), _keys(rng, 3, nb)
    want = grid_chunked_merge2(jnp.asarray(a), jnp.asarray(b), tile=tile, use_mxu=False,
                               interpret=True)
    got = grid_chunked_merge2_plain(torch.from_numpy(a), torch.from_numpy(b), tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.sort(np.concatenate([a, b], -1), -1))


def test_grid_merge_plain_matches_reference_on_float_rows():
    """Ties, ±inf-free finite floats without -0.0 or NaN (see the module
    note): the reference's raw-float merge, matrix permute and all."""
    rng = np.random.default_rng(2)
    a = np.sort((rng.integers(-20, 20, (2, 300)) * 0.25).astype(np.float32), -1)
    b = np.sort((rng.integers(-20, 20, (2, 200)) * 0.25).astype(np.float32), -1)
    want = grid_chunked_merge2(jnp.asarray(a), jnp.asarray(b), tile=64, interpret=True)
    got = grid_chunked_merge2_plain(torch.from_numpy(a), torch.from_numpy(b), tile=64)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_chunked_merge_matches_reference():
    rng = np.random.default_rng(4)
    a, b = _keys(rng, 6, 700), _keys(rng, 6, 450)
    want = j_chunked_merge(jnp.asarray(a).reshape(2, 3, 700), jnp.asarray(b).reshape(2, 3, 450))
    got = repro_torch.chunked_merge(torch.from_numpy(a).reshape(2, 3, 700),
                                    torch.from_numpy(b).reshape(2, 3, 450))
    assert got.shape == (2, 3, 1150)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want1 = j_chunked_merge(jnp.asarray(a[0]), jnp.asarray(b[0]), tile=128)
    got1 = repro_torch.chunked_merge(torch.from_numpy(a[0]), torch.from_numpy(b[0]), tile=128)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    loop = repro_torch.chunked_merge(torch.from_numpy(a), torch.from_numpy(b), mode="loop")
    np.testing.assert_array_equal(loop.numpy(), np.asarray(want).reshape(6, 1150))


def _loop_rows(rng, rows, n, dtype):
    """Sorted rows of quarter steps with many ties; the float rows mix -0.0
    and +0.0 (the reference's raw-float merge ties them, and its one-hot
    permute decides their sign)."""
    x = (rng.integers(-12, 12, (rows, n)) * 0.25).astype(np.float32)
    if dtype == "int32":
        return np.sort((x * 4).astype(np.int32), -1)
    x[(x == 0) & (rng.random((rows, n)) < 0.5)] = -0.0
    return np.sort(x, -1, kind="stable")


@pytest.mark.parametrize("dtype,na,nb,tile,n_cols", [
    ("float32", 64, 48, 16, None), ("bfloat16", 64, 48, 16, None),
    ("int32", 64, 48, 16, None), ("int32", 37, 0, 16, None), ("int32", 37, 5, 16, None),
    ("float32", 5, 70, 8, None),
    ("int32", 40, 30, 6, 4), ("float32", 40, 30, 6, 4)])
def test_loop_mode_matches_reference(dtype, na, nb, tile, n_cols):
    """``mode="loop"``: one 2-way merge a tile with the FLiMS refill; ragged
    and empty rows, and (``n_cols``) a plan whose columns do not divide the
    tile, where each tile takes the schedule merge. Bit-equal to the
    reference's loop in interpret mode and to the port's grid mode (on
    the rows without a -0.0 / +0.0 mix: the grid merge orders keys)."""
    from repro.streaming.planner import MergePlan as JPlan
    from repro_torch.streaming import MergePlan

    rng = np.random.default_rng(na * 7 + nb)
    ja, ta = _pair(_loop_rows(rng, 2, na, dtype), dtype)
    jb, tb = _pair(_loop_rows(rng, 2, nb, dtype), dtype)
    kw, tkw = {}, {}
    if n_cols:
        kw = dict(plan=JPlan(kind="loms", n_cols=n_cols, use_mxu=dtype != "int32"))
        tkw = dict(plan=MergePlan(kind="loms", n_cols=n_cols, use_mxu=dtype != "int32"))
    got = repro_torch.chunked_merge(ta, tb, tile=tile, mode="loop", **tkw)
    if nb:  # the reference's loop divides by zero on an empty list
        want = j_chunked_merge(ja, jb, tile=tile, mode="loop", **kw)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got.numpy(), ta.numpy())
    if dtype == "int32":
        grid = repro_torch.chunked_merge(ta, tb, tile=tile)
        np.testing.assert_array_equal(got.numpy(), grid.numpy())


def _special(rng, n, dtype):
    x = (rng.integers(-30, 30, n) * 0.25).astype(np.float32)
    if dtype == "int32":
        return x.astype(np.int32)
    for val, frac in ((np.nan, 0.03), (np.inf, 0.03), (-np.inf, 0.03), (-0.0, 0.05),
                      (0.0, 0.05)):
        x[rng.random(n) < frac] = val
    return x


def _pair(x, dtype):
    j = jnp.asarray(x).astype({"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                               "int32": jnp.int32}[dtype])
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j.view(jnp.int16)).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


@pytest.mark.parametrize("dtype,desc", [("float32", False), ("bfloat16", True),
                                        ("int32", True)])
def test_values_only_sort_spill_matches_reference(dtype, desc):
    """Two segments of 1500 and one of 1100 spill (three tiles of 512 and
    their pairwise grid merges); the short ones take the class sort."""
    rng = np.random.default_rng(8)
    offs = (0, 1500, 1530, 3030, 3031, 4131)
    jx, tx = _pair(_special(rng, offs[-1], dtype), dtype)
    want = repro.segment_sort(jx, offs, descending=desc, backend="segmented")
    got = repro_torch.segment_sort(tx, offs, descending=desc)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,desc", [("float32", True), ("int32", False)])
def test_values_only_merge_spill_matches_reference(dtype, desc):
    """Pairs whose classes sum past 1024 (600 + 10, 700 + 700) spill to one
    grid merge of the keys; the (5, 9) pair takes the class merge."""
    rng = np.random.default_rng(6)
    la, lb = (600, 5, 700), (10, 9, 700)
    oa = tuple(np.concatenate([[0], np.cumsum(la)]).tolist())
    ob = tuple(np.concatenate([[0], np.cumsum(lb)]).tolist())
    xa, xb = _special(rng, oa[-1], dtype), _special(rng, ob[-1], dtype)
    ja, ta = _pair(xa, dtype)
    jb, tb = _pair(xb, dtype)
    sa = repro.segment_sort(ja, oa, descending=desc, backend="segmented")
    sb = repro.segment_sort(jb, ob, descending=desc, backend="segmented")
    wv, woffs = repro.segment_merge(sa, sb, oa, ob, descending=desc, backend="segmented")
    ta_s = repro_torch.segment_sort(ta, oa, descending=desc)
    tb_s = repro_torch.segment_sort(tb, ob, descending=desc)
    np.testing.assert_array_equal(_bits(ta_s), _bits(sa))
    gv, goffs = repro_torch.segment_merge(ta_s, tb_s, oa, ob, descending=desc)
    assert tuple(goffs) == tuple(int(o) for o in woffs)
    np.testing.assert_array_equal(_bits(gv), _bits(wv))
