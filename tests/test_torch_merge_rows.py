"""CPU checks of the row-merge executor of kernel rows 1 and 7
(``src/repro_torch/csrc/merge_rows.cuh``), which no CUDA runs here: its
decomposition, emulated in torch ops, against the reference's Pallas
kernels in interpret mode and against the port's plain versions.

* Row 1: ``merge_rows_emulated`` (each thread's merge-path split and
  steps at 4, 8, 32 and 64 threads a row, the row sorts of C packed
  words, positions in the original ``concat(a, b)``, descending reversed
  on load and store) equals ``loms_merge2_pallas(..., use_mxu=False,
  interpret=True)`` and ``loms_merge2_plain`` at 32 + 32 (C = 4), 64 + 8
  (C = 2), 5 + 3 s2ms (C = 1) and 64 + 64 with C = 16, ascending and
  descending, with a 3-D payload lane.
* Row 7: ``seg_merge_rows_emulated`` (sentinel lanes past each length,
  the same merges and row sorts, the valid-first compaction as a prefix
  over the row's threads, the ``k_out`` prefix) equals
  ``segment_class_merge_pallas(..., interpret=True)`` and
  ``segment_class_merge_plain`` at (64, wb) for wb in 1, 2, 16 and 64,
  lengths 0 to full, ``k_out`` below and at the width, flip on and off.

Inputs come from a seed with numpy and carry NaN, ±inf, ±0.0 and heavy
ties; int32 rows carry INT32_MAX and INT32_MIN, so that a genuine key ties
the class merge's sentinel (INT32_MAX ascending, ~INT32_MIN descending).
Every dtype the wrappers take appears. Tolerance 0: every output is
compared as integer bits. The Pallas outputs are made once per module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.loms_merge import loms_merge2_pallas
from repro.kernels.segmented import segment_class_merge_pallas

from repro_torch.kernels import segmented as S
from repro_torch.kernels.common import encode_key_values, take_along
from repro_torch.kernels.loms_merge import loms_merge2_plain, merge_rows_emulated, tile_cols

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
        "int32": torch.int32}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16,
        "int32": jnp.int32}


def _values(rng, shape, dtype):
    """Heavy ties; floats also NaN, ±inf and ±0.0; int32 both extremes."""
    if dtype == "int32":
        x = rng.integers(-3, 4, shape).astype(np.int32)
        x[rng.random(shape) < 0.1] = np.iinfo(np.int32).max
        x[rng.random(shape) < 0.1] = np.iinfo(np.int32).min
        return torch.from_numpy(x)
    x = (rng.integers(-3, 4, shape) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random(shape) < frac] = val
    return _from_jax(jnp.asarray(x).astype(_JDT[dtype]))  # NaN bits as JAX makes them


def _int_bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        if t.dtype.is_floating_point else t


def _to_jax(t):
    if t.dtype in (torch.bfloat16, torch.float16):
        return jnp.asarray(t.view(torch.int16).numpy()).view(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float16)
    return jnp.asarray(t.numpy())


def _from_jax(a):
    a = np.asarray(a)
    if a.dtype in (jnp.bfloat16, np.float16):
        t = torch.from_numpy(a.view(np.int16).copy())
        return t.view(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float16)
    return torch.from_numpy(a.copy())


def _assert_bits(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert torch.equal(_int_bits(g), _int_bits(w))


def _sorted_rows(rng, shape, dtype, descending):
    """Rows in the total order of their keys (NaN last, -0.0 below +0.0)."""
    x = _values(rng, shape, dtype)
    keys = encode_key_values(x) if x.dtype.is_floating_point else x
    order = torch.argsort(keys, dim=-1, stable=True)
    return take_along(x, 1, order.flip(-1) if descending else order)


# ---------------------------------------------------------------------------
# row 1: the 2-way merge's shared-memory rows
# ---------------------------------------------------------------------------

#: (m, n, family, n_cols, dtype, orders): both orders where C > 1 and a
#: thread's steps cross a column's end, one where the interpret-mode
#: compile buys little (the budget is 15 s in one worker)
ROW1_CASES = [(32, 32, "loms", 4, "float32", (False, True)),
              (64, 8, "loms", 2, "bfloat16", (True,)),
              (5, 3, "s2ms", 1, "int32", (False,)),
              (64, 64, "loms", 16, "float16", (False, True))]
ROW1_RUNS = [(i, desc) for i, case in enumerate(ROW1_CASES) for desc in case[-1]]


@pytest.fixture(scope="module")
def row1_refs():
    """Per (case, descending): the inputs, a 3-D payload lane and the
    Pallas kernel's (values, perm, payload) on them."""
    refs = {}
    for i, (m, n, fam, cols, dtype, orders) in enumerate(ROW1_CASES):
        for desc in orders:
            rng = np.random.default_rng(100 * i + desc)
            rows = 6
            a = _sorted_rows(rng, (rows, m), dtype, desc)
            b = _sorted_rows(rng, (rows, n), dtype, desc)
            pay = torch.from_numpy(rng.integers(0, 1000, (rows, m + n, 3)).astype(np.int32))
            key = _JDT[dtype] if dtype != "int32" else None
            v, p, lanes = loms_merge2_pallas(
                _to_jax(a), _to_jax(b), (_to_jax(pay),), network=fam, n_cols=cols,
                block_batch=8, use_mxu=False, interpret=True, key_dtype=key,
                descending=desc, want_perm=True)
            refs[i, desc] = (a, b, pay, (_from_jax(v), _from_jax(p), _from_jax(lanes[0])))
    return refs


@pytest.mark.parametrize("case,desc", ROW1_RUNS)
@pytest.mark.parametrize("threads", [4, 8, 32, 64])
def test_merge_rows_emulated_matches_pallas_and_plain(row1_refs, case, desc, threads):
    m, n, fam, cols, dtype, _ = ROW1_CASES[case]
    a, b, pay, want = row1_refs[case, desc]
    assert tile_cols(fam, m, n, cols, False) == cols
    key = _TDT[dtype] if dtype != "int32" else None
    v, p, lanes = merge_rows_emulated(a, b, (pay,), cols=cols, key_dtype=key,
                                      descending=desc, threads=threads)
    _assert_bits(want, (v, p, lanes[0]))
    plain = loms_merge2_plain(a, b, (pay,), network=fam, n_cols=cols, key_dtype=key,
                              descending=desc, want_perm=True)
    _assert_bits((plain[0], plain[1], plain[2][0]), (v, p, lanes[0]))


# ---------------------------------------------------------------------------
# row 7: the class merge
# ---------------------------------------------------------------------------

#: (wb, dtype, family, flips): a = 64 wide, as phase 3d's kept lists;
#: int32 in both orders (INT32_MAX ties the sentinel ascending, INT32_MIN
#: descending)
ROW7_CASES = [(1, "float32", "loms", (False, True)), (2, "bfloat16", "s2ms", (True,)),
              (16, "int32", "loms", (False, True)), (64, "float16", "loms", (False,))]
ROW7_RUNS = [(i, flip) for i, case in enumerate(ROW7_CASES) for flip in case[-1]]


@pytest.fixture(scope="module")
def row7_refs():
    """Per (case, flip): the class tiles (sorted valid prefixes; the first
    row full, the second empty, the third with b empty), a payload lane and
    the Pallas kernel's full-width (values, perm, payload)."""
    refs = {}
    wa, rows = 64, 7
    for i, (wb, dtype, fam, flips) in enumerate(ROW7_CASES):
        for flip in flips:
            rng = np.random.default_rng(200 * i + flip)
            la = rng.integers(0, wa + 1, (rows, 1)).astype(np.int32)
            lb = rng.integers(0, wb + 1, (rows, 1)).astype(np.int32)
            la[0], lb[0], la[1], lb[1], lb[2] = wa, wb, 0, 0, 0
            la, lb = torch.from_numpy(la), torch.from_numpy(lb)
            a = S.segment_class_sort_plain(_values(rng, (rows, wa), dtype), la, flip=flip)[0]
            b = S.segment_class_sort_plain(_values(rng, (rows, wb), dtype), lb, flip=flip)[0]
            pay = torch.from_numpy(rng.integers(0, 1000, (rows, wa + wb)).astype(np.int32))
            v, p, lanes = segment_class_merge_pallas(
                _to_jax(a), _to_jax(b), _to_jax(la), _to_jax(lb), (_to_jax(pay),),
                network=fam, flip=flip, want_perm=True, interpret=True)
            refs[i, flip] = (a, b, la, lb, pay, (_from_jax(v), _from_jax(p),
                                                 _from_jax(lanes[0])))
    return refs


@pytest.mark.parametrize("case,flip", ROW7_RUNS)
@pytest.mark.parametrize("k_out", ["full", "third"])
@pytest.mark.parametrize("threads", [4, 32, 64])
def test_seg_merge_rows_emulated_matches_pallas_and_plain(row7_refs, case, flip, k_out,
                                                          threads):
    wb, dtype, fam, _ = ROW7_CASES[case]
    a, b, la, lb, pay, want = row7_refs[case, flip]
    total = 64 + wb
    k = total if k_out == "full" else max(1, total // 3)
    got = S.seg_merge_rows_emulated(a, b, la, lb, (pay,), k_out=k, network=fam, flip=flip,
                                    threads=threads)
    _assert_bits(tuple(w[:, :k] for w in want), (got[0], got[1], got[2][0]))
    plain = S.segment_class_merge_plain(a, b, la, lb, (pay,), k_out=k, network=fam,
                                        flip=flip, want_perm=True)
    _assert_bits((plain[0], plain[1], plain[2][0]), (got[0], got[1], got[2][0]))


def test_compaction_where_a_valid_key_ties_the_sentinel():
    """int32 rows whose genuine keys tie the sentinel (INT32_MAX ascending,
    INT32_MIN descending), full and ragged, at 4, 32 and 128 threads a row:
    the rows that need the compaction get it (every valid lane first) and
    full rows keep the network order."""
    rng = np.random.default_rng(5)
    wa, wb, rows = 64, 16, 8
    for flip in (False, True):
        ext = np.iinfo(np.int32).min if flip else np.iinfo(np.int32).max
        for full in (True, False):
            la = torch.full((rows, 1), wa, dtype=torch.int32) if full else \
                torch.from_numpy(rng.integers(0, wa + 1, (rows, 1)).astype(np.int32))
            lb = torch.full((rows, 1), wb, dtype=torch.int32) if full else \
                torch.from_numpy(rng.integers(0, wb + 1, (rows, 1)).astype(np.int32))
            xa = torch.full((rows, wa), ext, dtype=torch.int32)
            xa[:, ::3] = 1
            xb = torch.full((rows, wb), ext, dtype=torch.int32)
            a = S.segment_class_sort_plain(xa, la, flip=flip)[0]
            b = S.segment_class_sort_plain(xb, lb, flip=flip)[0]
            want = S.segment_class_merge_plain(a, b, la, lb, flip=flip, want_perm=True)
            for threads in (4, 32, 128):
                got = S.seg_merge_rows_emulated(a, b, la, lb, flip=flip, threads=threads)
                _assert_bits((want[0], want[1]), (got[0], got[1]))
            if not full:
                seg = got[1]
                assert bool(((seg < (la + lb)) | (torch.arange(wa + wb) >= la + lb)).all())
