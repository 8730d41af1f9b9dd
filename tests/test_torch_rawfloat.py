"""CPU parity of the raw-float mode of kernel rows 1, 2 and 8.

The reference's values-only wrappers (``repro.kernels.ops`` ``merge2``,
``sort``, ``merge_k``, ``median_k``) send float rows through the fused
kernels raw, with ``use_mxu=True``: the ranks compare raw floats (NaN
compares false, -0.0 ties +0.0) and every permute is the float32 one-hot
matrix product ``onehot_permute``. The port's wrappers take the same mode
(``kernels/common.onehot_permute`` states its rule). Here they are held
against the reference on rows that hold -0.0 / +0.0 mixes, all-negative
rows with a -0.0, one +inf, one -inf, one NaN, several NaNs, and plain
tied rows, in float32 and bfloat16:

* the wrappers against ``repro.kernels.ops.*`` (which run the Pallas
  kernels in interpret mode on the CPU), with the autotune cache pointed
  at an empty directory so that the reference plans as the port does;
* the kernels called directly (``use_mxu=True, interpret=True``) with the
  position lane, whose sums (colliding ranks of a NaN row) must match too.

Tolerance: every lane the reference leaves a number is bit-equal (so a
-0.0 is a -0.0), and the NaN lanes sit in the same places. The NaN bits
themselves are not compared: the reference's are the host FPU's (0 x inf
gives 0xFFC00000 on x86), not the algorithm's; the port writes the
canonical quiet NaN.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.kway import kway_merge_pallas
from repro.kernels.loms_merge import loms_merge2_pallas
from repro.kernels.sort import loms_sort_pallas
from repro.networks import kway_schedule as j_kway_schedule
from repro.streaming.planner import plan_op as j_plan_op

from repro_torch.kernels import ops as tops
from repro_torch.kernels.kway import kway_merge
from repro_torch.kernels.loms_merge import loms_merge2
from repro_torch.kernels.sort import loms_sort
from repro_torch.networks import kway_schedule
from repro_torch.streaming.planner import plan_op

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _special_rows(seed: int, n: int, sort: bool) -> np.ndarray:
    """Ten rows of width n: a -0.0 / +0.0 mix, all-negative with one
    -0.0, one +inf, one -inf, one NaN, several NaNs, +inf and -inf, two
    tied rows with a -0.0, and an all-negative row whose largest is -0.0
    (sorted in raw-float order when ``sort``: NaN last)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (10, n)) * 0.5).astype(np.float32)
    x[0] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    x[1] = -np.abs(x[1]) - 1.0
    x[1, rng.integers(n)] = -0.0
    x[2, rng.integers(n)] = np.inf
    x[3, rng.integers(n)] = -np.inf
    x[4, rng.integers(n)] = np.nan
    x[5, rng.integers(0, n, 3)] = np.nan
    x[6, rng.integers(n)] = np.inf
    x[6, rng.integers(n)] = -np.inf
    x[7, rng.integers(n)] = -0.0
    x[8, rng.integers(n)] = -0.0
    x[9] = -(np.arange(n, dtype=np.float32) + 1.0)
    x[9, 0] = -0.0
    return np.sort(x, axis=-1) if sort else x


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = _DT[dtype]
    j = jnp.asarray(x).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _assert_raw_equal(got: torch.Tensor, want) -> None:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    gn, wn = np.isnan(g), np.isnan(w)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(g.view(np.int32)[~gn], w.view(np.int32)[~wn])


_CASES = {
    "merge2 32+32": lambda s: ("merge2", [_special_rows(s, 32, True),
                                          _special_rows(s + 1, 32, True)]),
    "merge2 64+32": lambda s: ("merge2", [_special_rows(s, 64, True),
                                          _special_rows(s + 1, 32, True)]),
    "sort 8": lambda s: ("sort", [_special_rows(s, 8, False)]),
    "sort 1007": lambda s: ("sort", [_special_rows(s, 1007, False)]),
    "sort 1024": lambda s: ("sort", [_special_rows(s, 1024, False)]),
    "merge_k 3x7": lambda s: ("merge_k", [_special_rows(s + j, 7, True) for j in range(3)]),
    "median_k 3x7": lambda s: ("median_k", [_special_rows(s + j, 7, True) for j in range(3)]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_values_only_wrappers_match_the_reference(case, dtype):
    op, rows = _CASES[case](len(case))
    pairs = [_pair(r, dtype) for r in rows]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    if op in ("merge2", "sort"):
        want, got = getattr(jops, op)(*js), getattr(tops, op)(*ts)
    else:
        want, got = getattr(jops, op)(js), getattr(tops, op)(ts)
    _assert_raw_equal(got, want)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_kernel_positions_match_the_reference(descending):
    """The position lane of the raw-float sort: the einsum's sums where
    a NaN made ranks collide, then the valid-first compaction."""
    x = _special_rows(7, 37, False)
    want, want_p, _ = loms_sort_pallas(jnp.asarray(x), use_mxu=True, interpret=True,
                                       want_perm=True, descending=descending)
    got, got_p, _ = loms_sort(torch.from_numpy(x), use_mxu=True, want_perm=True,
                              descending=descending)
    _assert_raw_equal(got, want)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_merge_kernel_positions_match_the_reference():
    """A 4 + 4 column device: columns of 4 lanes and rows of 2, the short
    vectors whose zero sums keep the sign of their products."""
    a, b = _special_rows(11, 4, True), _special_rows(12, 4, True)
    for desc in (False, True):
        a_, b_ = (a[:, ::-1].copy(), b[:, ::-1].copy()) if desc else (a, b)
        want, want_p, _ = loms_merge2_pallas(jnp.asarray(a_), jnp.asarray(b_), n_cols=2,
                                             use_mxu=True, interpret=True, want_perm=True,
                                             descending=desc)
        got, got_p, _ = loms_merge2(torch.from_numpy(a_), torch.from_numpy(b_), n_cols=2,
                                    use_mxu=True, want_perm=True, descending=desc)
        _assert_raw_equal(got, want)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kway_kernel_positions_match_the_reference(dtype):
    x = np.concatenate([_special_rows(20 + j, 7, True) for j in range(3)], axis=-1)
    jx, tx = _pair(x, dtype)
    want, want_p, _ = kway_merge_pallas(jx, j_kway_schedule((7, 7, 7)), use_mxu=True,
                                        interpret=True, want_perm=True)
    got, got_p, _ = kway_merge(tx, kway_schedule((7, 7, 7)), use_mxu=True, want_perm=True)
    _assert_raw_equal(got, want)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert (np.signbit(w) & (w == 0)).any()  # the short vectors keep a -0.0 here


@pytest.mark.parametrize("op,lengths", [("merge2", (32, 32)), ("merge2", (6, 9)),
                                        ("sort", (1007,)), ("kway", (7, 7, 7)),
                                        ("chunked2", (4096, 4096)), ("chunked_k", (64, 64))])
def test_planner_use_mxu_is_the_reference(op, lengths):
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                     (jnp.int32, torch.int32)):
        want = j_plan_op(op, lengths, batch=8, dtype=jdt)
        got = plan_op(op, lengths, batch=8, dtype=tdt)
        assert got.use_mxu == want.use_mxu
        assert (got.kind, got.n_cols, got.network) == (want.kind, want.n_cols, want.network)


def test_modes_that_stay_refused():
    x = torch.zeros((2, 8))
    with pytest.raises(NotImplementedError, match="use_mxu=True"):
        loms_sort(x)  # raw floats through the exact permute
    with pytest.raises(NotImplementedError, match="integer keys"):
        loms_sort(x.to(torch.int32), use_mxu=True)
    with pytest.raises(NotImplementedError, match="payload"):
        loms_sort(x, (torch.zeros((2, 8), dtype=torch.int32),), use_mxu=True)
    # the unified API keeps the key mode: NaN last, -0.0 below +0.0
    import repro_torch

    y = torch.tensor([[float("nan"), 0.0, -0.0, float("-inf")]])
    out = repro_torch.sort(y, device="cpu")
    assert torch.equal(out[:, :3], torch.tensor([[float("-inf"), -0.0, 0.0]]))
    assert torch.signbit(out[0, 1]) and torch.isnan(out[0, 3])
