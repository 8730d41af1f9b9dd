"""CPU parity of the port's segmented subsystem against the reference.

* The plain class sort and class merge (what the CPU runs, and what the
  CUDA class kernels are held against on the card) equal
  ``segment_class_sort_pallas`` / ``segment_class_merge_pallas`` in
  interpret mode bit for bit: values, int32 perm and payload lanes, in
  float32, bfloat16 and int32, both orders, with NaN, ±inf, ±0.0, heavy
  ties and lengths from 0 to W, including the column-device widths.
* ``repro_torch.segment_{sort,merge,topk,argmax}`` equal
  ``repro.segment_*(backend="segmented")`` on ragged offset patterns.
* ``topk(stable=True)`` equals the reference's pallas rung with
  ``stable=True``.

The reference's planner reads an autotune cache; it is pointed at an
empty one, so every class runs the loms family on both sides.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.segmented import segment_class_merge_pallas, segment_class_sort_pallas

import repro_torch
from repro_torch.kernels import segmented as S

RNG_SEED = 13


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


def _tile(rng, s, w, dtype):
    """A tile with many ties; floats also carry NaN, ±inf and ±0.0."""
    if dtype == "int32":
        x = rng.integers(-3, 4, (s, w)).astype(np.int32)
        x[rng.random((s, w)) < 0.05] = np.iinfo(np.int32).max
        x[rng.random((s, w)) < 0.05] = np.iinfo(np.int32).min
        return x
    x = (rng.integers(-3, 4, (s, w)) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random((s, w)) < frac] = val
    return x


def _both(x, dtype):
    """The same bits as a jax array and a torch tensor."""
    a = jnp.asarray(x).astype(dtype)
    if dtype == "bfloat16":
        return a, torch.from_numpy(np.asarray(a.view(jnp.int16)).copy()).view(torch.bfloat16)
    return a, torch.from_numpy(np.asarray(a).copy())


def _bits(a):
    a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy() \
        if isinstance(a, torch.Tensor) and a.dtype.is_floating_point else np.asarray(a)
    if a.dtype.kind == "f" or a.dtype == jnp.bfloat16:
        a = a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)
    return a


def _assert_same(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _lens(rng, s, w):
    lens = rng.integers(0, w + 1, (s, 1)).astype(np.int32)
    lens[0], lens[1] = w, 0
    return lens


@pytest.mark.parametrize("w", [2, 16, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_class_sort_plain_matches_pallas(w, dtype):
    rng = np.random.default_rng(RNG_SEED + w)
    s = 6
    x_j, x_t = _both(_tile(rng, s, w, dtype), dtype)
    lens = _lens(rng, s, w)
    pay = rng.integers(0, 1000, (s, w, 2)).astype(np.int32)
    k_out = max(1, w // 2)
    for flip in (False, True):
        want = segment_class_sort_pallas(x_j, jnp.asarray(lens), (jnp.asarray(pay),),
                                         k_out=k_out, flip=flip, want_perm=True,
                                         interpret=True)
        got = S.segment_class_sort(x_t, torch.from_numpy(lens), (torch.from_numpy(pay),),
                                   k_out=k_out, flip=flip, want_perm=True)
        _assert_same((want[0], want[1]) + tuple(want[2]), (got[0], got[1]) + got[2])


def _sorted_runs(rng, s, w, dtype, lens, flip):
    """Rows whose valid prefix is sorted in the kernels' key order."""
    x_j, x_t = _both(_tile(rng, s, w, dtype), dtype)
    out = S.segment_class_sort_plain(x_t, torch.from_numpy(lens), flip=flip)[0]
    return _both_from_torch(out, dtype)


def _both_from_torch(t, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16), t
    return jnp.asarray(t.numpy()), t


@pytest.mark.parametrize("wa,wb", [(16, 16), (4, 64), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_class_merge_plain_matches_pallas(wa, wb, dtype):
    rng = np.random.default_rng(RNG_SEED + wa + 7 * wb)
    s = 5
    la, lb = _lens(rng, s, wa), _lens(rng, s, wb)
    lb[0] = 0
    pay = rng.integers(0, 1000, (s, wa + wb)).astype(np.int32)
    for flip in (False, True):
        a_j, a_t = _sorted_runs(rng, s, wa, dtype, la, flip)
        b_j, b_t = _sorted_runs(rng, s, wb, dtype, lb, flip)
        want = segment_class_merge_pallas(a_j, b_j, jnp.asarray(la), jnp.asarray(lb),
                                          (jnp.asarray(pay),), flip=flip,
                                          want_perm=True, interpret=True)
        got = S.segment_class_merge(a_t, b_t, torch.from_numpy(la), torch.from_numpy(lb),
                                    (torch.from_numpy(pay),), flip=flip, want_perm=True)
        _assert_same((want[0], want[1]) + tuple(want[2]), (got[0], got[1]) + got[2])


#: ragged offset patterns of tests/test_segmented.py: empty, singleton,
#: prime, all-equal and mixed segments
OFFSET_CASES = [(0, 0, 1, 1, 2), (0, 3, 3, 4, 17, 17, 64, 111)]


def _values(rng, n):
    x = (rng.integers(-4, 5, n) * 0.5).astype(np.float32)
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.1] = -0.0
    return x


@pytest.mark.parametrize("offs", OFFSET_CASES)
def test_segment_ops_match_reference(offs):
    rng = np.random.default_rng(sum(offs))
    n = offs[-1]
    x = _values(rng, n)
    pay = {"emb": rng.integers(0, 99, (n, 2)).astype(np.int32),
           "pos": np.arange(n, dtype=np.int32)}
    jpay = {k: jnp.asarray(v) for k, v in pay.items()}
    tpay = {k: torch.from_numpy(v) for k, v in pay.items()}
    xt = torch.from_numpy(x)
    jo, jt = repro.segment_sort(jnp.asarray(x), offs, descending=True, payload=jpay,
                                backend="segmented")
    to, tt = repro_torch.segment_sort(xt, offs, descending=True, payload=tpay)
    _assert_same((jo, jt["emb"], jt["pos"]), (to, tt["emb"], tt["pos"]))
    ks = [int(k) for k in rng.integers(0, 9, len(offs) - 1)]
    jv, ji, joo = repro.segment_topk(jnp.asarray(x), offs, ks, backend="segmented")
    tv, ti, too = repro_torch.segment_topk(xt, offs, ks)
    _assert_same((jv, ji), (tv, ti))
    assert too == tuple(joo)
    _assert_same(repro.segment_argmax(jnp.asarray(x), offs, backend="segmented"),
                 repro_torch.segment_argmax(xt, offs))


def test_segment_merge_matches_reference():
    rng = np.random.default_rng(5)
    offs_a, offs_b = (0, 0, 3, 10, 14, 30), (0, 2, 2, 9, 30, 41)
    a, b = _values(rng, offs_a[-1]), _values(rng, offs_b[-1])
    for desc in (True,):
        sa = repro_torch.segment_sort(torch.from_numpy(a), offs_a, descending=desc)
        sb = repro_torch.segment_sort(torch.from_numpy(b), offs_b, descending=desc)
        pa = np.arange(offs_a[-1], dtype=np.int32)
        pb = 100 + np.arange(offs_b[-1], dtype=np.int32)
        jo, jt, joo = repro.segment_merge(
            jnp.asarray(sa.numpy()), jnp.asarray(sb.numpy()), offs_a, offs_b,
            descending=desc, payload=(jnp.asarray(pa), jnp.asarray(pb)),
            backend="segmented")
        to, tt, too = repro_torch.segment_merge(
            sa, sb, offs_a, offs_b, descending=desc,
            payload=(torch.from_numpy(pa), torch.from_numpy(pb)))
        _assert_same((jo, jt), (to, tt))
        assert too == tuple(joo)


def test_zero_segments_match_reference_auto_route():
    """The reference's kernel path crashes on zero segments (its
    ``np.cumsum([])`` is a float); its auto route is the oracle here."""
    x = jnp.zeros((0,), jnp.float32)
    jv, ji, joo = repro.segment_topk(x, (0,), (), backend="auto")
    tv, ti, too = repro_torch.segment_topk(torch.zeros(0), (0,), ())
    assert too == tuple(joo) == (0,)
    assert tv.shape == ji.shape == (0,) and ti.dtype == torch.int32
    av, ai = repro_torch.segment_argmax(torch.zeros(0), (0,))
    assert av.shape == ai.shape == (0,)


def test_spill_topk_matches_reference_stable_spill(monkeypatch):
    """Two segments of 5000 (past the 1024 class width): the stable top-k.
    The values are distinct, so the stable top-k is one answer whatever
    backend selects it; the reference's is pinned to ``lax`` (on the CPU
    its auto route compiles a 5000-wide network)."""
    import repro.api.ops as j_ops

    j_topk = j_ops.topk
    monkeypatch.setattr(j_ops, "topk", lambda x, k, **kw: j_topk(x, k, backend="lax", **kw))
    rng = np.random.default_rng(11)
    x = rng.standard_normal(10_000).astype(np.float32)
    offs, ks = (0, 5000, 10_000), (64, 7)
    jv, ji, joo = repro.segment_topk(jnp.asarray(x), offs, ks, backend="segmented")
    tv, ti, too = repro_torch.segment_topk(torch.from_numpy(x), offs, ks)
    _assert_same((jv, ji), (tv, ti))
    assert too == tuple(joo)
    # the values-only sort spill (kernel rows 6 + 9) sorts each segment
    got = repro_torch.segment_sort(torch.from_numpy(x), offs)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(
        [np.sort(x[:5000]), np.sort(x[5000:])]))


@pytest.mark.parametrize("n,k,dtype", [(256, 64, "bfloat16"), (1000, 16, "float32")])
def test_stable_topk_matches_reference(n, k, dtype):
    rng = np.random.default_rng(n)
    x = (rng.integers(-6, 7, (3, n)) * 0.5).astype(np.float32)
    x[0, :4] = [np.nan, -0.0, 0.0, np.inf]
    x_j, x_t = _both(x, dtype)
    want = repro.topk(x_j, k, stable=True, backend="pallas")
    got = repro_torch.topk(x_t, k, stable=True)
    _assert_same(want, got)
