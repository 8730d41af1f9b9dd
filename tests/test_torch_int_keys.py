"""Integer keys: int32 on the top-k kernels, and the narrow integer types.

* The plain versions of rows 3-5 (``router_topk_plain``,
  ``vocab_topk_plain``) on int32 rows full of ``INT32_MIN`` (which ties the
  pads) and ``INT32_MAX``, against ``router_topk_pallas`` /
  ``vocab_topk_pallas(interpret=True)`` with the reference's integer mode
  (``key_dtype=None``, ``use_mxu=False``); the CUDA kernels' decompositions
  (``router_topk_emulated``, ``vocab_phase1_emulated`` and
  ``vocab_merge_tree_emulated``: int32 words, the pads past V) against the
  plain versions.
* int8, int16, uint8 and uint16 (and int32 for ``topk``) through the
  library calls against ``repro.*`` on the reference's kernel routes
  (``backend="pallas"``; ``"segmented"`` for the segment ops): the port's
  auto route on a CPU tensor is the card's, through the kernels' plain
  versions. Values, their dtype, int32 indices, payloads and offsets,
  bit-equal; a top-k whose k reaches past the real candidates puts out
  the reference's pads (index -1, the type's minimum).
* ``plan`` sends an integer top-k to the kernels, as the reference plans
  it for its accelerator; the key map keeps the order and the extremes.

Both packages point at empty autotune caches.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api.spec import SortSpec as JSpec
from repro.kernels.topk import router_topk_pallas, vocab_topk_pallas

import repro_torch
from repro_torch.api.keys import narrow_int_keys, widen_int_keys
from repro_torch.api.spec import SortSpec
from repro_torch.kernels import topk as K
from repro_torch.streaming import cache as tcache

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_caches(tmp_path_factory):
    from repro.streaming.cache import AutotuneCache, set_default_cache

    d = tmp_path_factory.mktemp("autotune")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(d / "ref.json")
    prev = set_default_cache(AutotuneCache(str(d / "ref.json")))
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(str(d / "port.json")))
    yield
    set_default_cache(prev)
    tcache.set_default_cache(prev_t)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


def _extremes(rng, dtype, shape):
    """Values of ``dtype`` heavy in its minimum, with its maximum and ties."""
    info = np.iinfo(dtype)
    vals = np.array([info.min, info.min, info.min + 1, 0, 1, 5, 5, info.max - 1, info.max],
                    np.int64)
    vals = vals[(vals >= info.min) & (vals <= info.max)]
    return rng.choice(vals, size=shape).astype(dtype)


# ---------------------------------------------------------------------------
# rows 3-5 on int32 keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,e,k,block", [(8, 48, 40, 16), (8, 96, 96, 32), (8, 40, 40, 8),
                                         (8, 512, 64, 64), (8, 320, 300, 64)])
def test_router_plain_int32_matches_pallas(t, e, k, block):
    x = _extremes(np.random.default_rng(e + k), np.int32, (t, e))
    wv, wi = router_topk_pallas(jnp.asarray(x), k=k, block=block, use_mxu=False,
                                interpret=True)
    gv, gi = K.router_topk_plain(torch.from_numpy(x), k, block)
    assert gv.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    ev, ei = K.router_topk_emulated(torch.from_numpy(x), k, block)
    assert torch.equal(ev, gv) and torch.equal(ei, gi)


@pytest.mark.parametrize("b,v,k,block", [(8, 600, 64, 16), (8, 530, 530, 16),
                                         (8, 700, 1000, 128), (8, 2000, 64, 64)])
def test_vocab_plain_int32_matches_pallas(b, v, k, block):
    """(530, k 530): the pads past V tie the real minima inside the last
    real block; (700, k 1000): k past V, so pads come out."""
    x = _extremes(np.random.default_rng(v + k), np.int32, (b, v))
    wv, wi = vocab_topk_pallas(jnp.asarray(x), k=k, block=block, use_mxu=False,
                               interpret=True)
    tx = torch.from_numpy(x)
    gv, gi = K.vocab_topk_plain(tx, k, block)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert bool((gi < 0).any()) == (k >= v)
    pv, pi = K.vocab_phase1_plain(tx, k, block)
    qv, qi = K.vocab_phase1_emulated(tx, k, block)
    assert torch.equal(qv, pv) and torch.equal(qi, pi)
    tv, ti = K.vocab_merge_tree_emulated(pv, pi, k)
    assert torch.equal(tv[:, 0, :k], gv) and torch.equal(ti[:, 0, :k], gi)


def test_integer_topk_plans_the_kernels():
    for n, detail in ((151_936, "vocab_topk"), (256, "router_topk")):
        got = repro_torch.plan(SortSpec(op="topk", lengths=(n,), batch=4, dtype="int32", k=64))
        want = repro.plan(JSpec(op="topk", lengths=(n,), batch=4, dtype="int32", k=64,
                                device="tpu"))
        assert (got.backend, got.detail) == ("cuda", detail)
        assert (want.backend, want.detail) == ("pallas", detail)
    host = repro_torch.plan(SortSpec(op="topk", lengths=(256,), dtype="int32", k=8,
                                     device="cpu"))
    assert host.backend == "schedule"


# ---------------------------------------------------------------------------
# int8 / int16 / uint8 / uint16 through the library calls
# ---------------------------------------------------------------------------

NARROW = [np.int8, np.int16, np.uint8, np.uint16]


@pytest.mark.parametrize("dtype", NARROW)
def test_int_key_map_keeps_order_and_extremes(dtype):
    info = np.iinfo(dtype)
    x = torch.from_numpy(np.arange(info.min, info.max + 1, dtype=np.int64).astype(dtype))
    keys = widen_int_keys(x)
    assert keys.dtype == torch.int32 and bool((keys[1:] > keys[:-1]).all())
    assert (int(keys[0]), int(keys[-1])) == (I32_MIN, I32_MAX)
    assert torch.equal(narrow_int_keys(keys, x.dtype), x)


def _same(want, got):
    want = jax.tree.leaves(want)
    got = torch.utils._pytree.tree_leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(g, torch.Tensor):
            g = g.numpy()
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype, (w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case_sort(rng, dt):
    x = _extremes(rng, dt, (4, 37))
    ids = np.arange(x.size, dtype=np.int32).reshape(x.shape)
    return (repro.sort(jnp.asarray(x), payload=jnp.asarray(ids), descending=True,
                       backend="pallas"),
            repro_torch.sort(_t(x), payload=_t(ids), descending=True))


def _case_topk(rng, dt):
    """(2, 530), k 530: the vocab path, with the pads past V (the type's
    minimum, index -1) among the real minima."""
    x = _extremes(rng, dt, (2, 530))
    return (repro.topk(jnp.asarray(x), 530, backend="pallas"),
            repro_torch.topk(_t(x), 530))


def _case_merge(rng, dt):
    a, b = (np.sort(_extremes(rng, dt, (4, n)), -1) for n in (16, 12))
    pa = np.arange(64, dtype=np.int32).reshape(4, 16)
    pb = 64 + np.arange(48, dtype=np.int32).reshape(4, 12)
    return (repro.merge(jnp.asarray(a), jnp.asarray(b), payload=(jnp.asarray(pa), jnp.asarray(pb)),
                        backend="pallas"),
            repro_torch.merge(_t(a), _t(b), payload=(_t(pa), _t(pb))))


def _case_merge_k(rng, dt):
    lists = [np.sort(_extremes(rng, dt, (4, n)), -1) for n in (16, 12, 9)]
    return (repro.merge_k([jnp.asarray(v) for v in lists], backend="pallas"),
            repro_torch.merge_k([_t(v) for v in lists]))


def _case_median(rng, dt):
    lists = [np.sort(_extremes(rng, dt, (4, 7)), -1) for _ in range(3)]
    return (repro.median_of_lists([jnp.asarray(v) for v in lists], backend="pallas"),
            repro_torch.median_of_lists([_t(v) for v in lists]))


OFFS = (0, 5, 5, 17, 40)


def _case_segment_sort(rng, dt):
    v = _extremes(rng, dt, (OFFS[-1],))
    ids = np.arange(OFFS[-1], dtype=np.int32)
    return (repro.segment_sort(jnp.asarray(v), OFFS, payload=jnp.asarray(ids),
                               backend="segmented"),
            repro_torch.segment_sort(_t(v), OFFS, payload=_t(ids)))


def _case_segment_merge(rng, dt):
    oa, ob = (0, 10, 20, 44), (0, 15, 20, 36)
    a = _extremes(rng, dt, (oa[-1],))
    b = _extremes(rng, dt, (ob[-1],))
    for x, offs in ((a, oa), (b, ob)):
        for s, e in zip(offs[:-1], offs[1:]):
            x[s:e] = np.sort(x[s:e])
    return (repro.segment_merge(jnp.asarray(a), jnp.asarray(b), oa, ob, backend="segmented"),
            repro_torch.segment_merge(_t(a), _t(b), oa, ob))


def _case_segment_topk(rng, dt):
    v = _extremes(rng, dt, (OFFS[-1],))
    return (repro.segment_topk(jnp.asarray(v), OFFS, [3, 4, 8, 30], backend="segmented"),
            repro_torch.segment_topk(_t(v), OFFS, [3, 4, 8, 30]))


def _case_segment_argmax(rng, dt):
    v = _extremes(rng, dt, (OFFS[-1],))
    return (repro.segment_argmax(jnp.asarray(v), OFFS, backend="segmented"),
            repro_torch.segment_argmax(_t(v), OFFS))


CASES = {"sort": _case_sort, "topk": _case_topk, "merge": _case_merge,
         "merge_k": _case_merge_k, "median_of_lists": _case_median,
         "segment_sort": _case_segment_sort, "segment_merge": _case_segment_merge,
         "segment_topk": _case_segment_topk, "segment_argmax": _case_segment_argmax}
#: every op in every type; the segment ops (the slowest references) in int8
#: and uint16, a signed type of one width and an unsigned one of the other
PAIRS = [(op, dt) for op in CASES for dt in NARROW
         if not op.startswith("segment") or dt in (np.int8, np.uint16)]


@pytest.mark.parametrize("op,dtype", PAIRS, ids=[f"{op}-{dt.__name__}" for op, dt in PAIRS])
def test_narrow_ints_match_reference(op, dtype):
    want, got = CASES[op](np.random.default_rng(len(op) + NARROW.index(dtype)), dtype)
    _same(want, got)


def test_int32_topk_runs_the_kernels_route():
    """int32 ``topk`` (router and vocab widths) takes the kernels' plain
    versions on a CPU tensor, as the reference's accelerator route does."""
    rng = np.random.default_rng(7)
    for shape, k in (((8, 256), 64), ((2, 530), 530)):
        x = _extremes(rng, np.int32, shape)
        _same(repro.topk(jnp.asarray(x), k, backend="pallas"), repro_torch.topk(_t(x), k))


def test_64_bit_values_are_refused():
    with pytest.raises(NotImplementedError, match="8 to 32 bits"):
        repro_torch.sort(torch.zeros(2, 8, dtype=torch.int64))
