"""``nan_policy="unsafe"`` and signed zeros: the port against the reference.

Under ``"unsafe"`` the reference's kernels compare raw floats, so -0.0
and +0.0 tie and the network's tie rule orders them. The port runs
total-order keys with -0.0 given +0.0's key (``tie_signed_zeros``), so
the same rule decides. Finite rows in float32 and bfloat16 that are
mostly zeros of both signs go through ``segment_sort`` (a payload),
``segment_topk``, ``segment_merge`` (a payload) with
``backend="segmented"``, and the fused ``topk`` at a router width and a
vocab width, against the reference's kernels in interpret mode in their
raw-float mode. Both packages point at empty autotune caches.

The top-k kernels' plain versions (rows 3-5) also go alone against
``router_topk_pallas`` / ``vocab_topk_pallas(use_mxu=True,
interpret=True)`` on rows whose values all have the sign bit set, at
blocks and k small enough that the reference's one-hot permute keeps a
zero's sign (``signed_zero_rule``), and the library's ``topk`` at a row
of 6 and 7. The values-only spills (segments past the 1024 class width:
the sort spill's tile sorts and grid merges, the merge spill's grid
merge) and ``segment_topk``'s spill go against ``repro.segment_*`` with
``nan_policy="unsafe"``; the reference's spill top-k calls its unified
``topk``, pinned here to its kernel route (``backend="pallas"``), which
the port's takes.

Tolerance: bit-equal: values as their bits (the sign of every zero
included), int32 indices, payload lanes and offsets. The class kernels
gather raw values, so a -0.0 stays -0.0; the top-k kernels put out the
reference's one-hot permute's zero: +0.0 for either zero, except where
that permute keeps -0.0.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.topk import router_topk_pallas, vocab_topk_pallas

import repro_torch
from repro_torch.kernels import topk as K
from repro_torch.streaming import cache as tcache

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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


def _zeros_heavy(rng, shape):
    vals = np.array([-1.5, -0.5, -0.0, 0.0, 0.5, 1.5], np.float32)
    return rng.choice(vals, size=shape, p=[0.1, 0.15, 0.3, 0.3, 0.1, 0.05])


def _pair(x, dtype):
    j = jnp.asarray(x).astype(_JDT[dtype])
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j.view(jnp.int16)).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, tuple):
            assert tuple(w) == tuple(g)
            continue
        np.testing.assert_array_equal(_bits(g), _bits(w))


OFFS = (0, 5, 12, 30, 48, 100, 192)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("descending", [False, True])
def test_segment_sort_ties_signed_zeros(dtype, descending):
    rng = np.random.default_rng(1 + descending)
    jx, tx = _pair(_zeros_heavy(rng, OFFS[-1]), dtype)
    ids = np.arange(OFFS[-1], dtype=np.int32)
    w = repro.segment_sort(jx, OFFS, descending=descending, payload=jnp.asarray(ids),
                           backend="segmented", nan_policy="unsafe")
    g = repro_torch.segment_sort(tx, OFFS, descending=descending,
                                 payload=torch.from_numpy(ids), backend="segmented",
                                 nan_policy="unsafe")
    _same(w, g)
    assert (np.signbit(np.asarray(w[0], np.float32)) & (np.asarray(w[0], np.float32) == 0)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_topk_ties_signed_zeros(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(_zeros_heavy(rng, OFFS[-1]), dtype)
    w = repro.segment_topk(jx, OFFS, [3, 4, 8, 2, 16, 5], backend="segmented",
                           nan_policy="unsafe")
    g = repro_torch.segment_topk(tx, OFFS, [3, 4, 8, 2, 16, 5], backend="segmented",
                                 nan_policy="unsafe")
    _same(w, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_merge_ties_signed_zeros(dtype):
    """Runs sorted as raw floats (a stable sort keeps each zero's place)."""
    rng = np.random.default_rng(4)
    oa, ob = (0, 10, 20, 44, 60), (0, 15, 20, 36, 70)
    runs = []
    for offs in (oa, ob):
        x = _zeros_heavy(rng, offs[-1])
        for s, e in zip(offs[:-1], offs[1:]):
            x[s:e] = np.sort(x[s:e], kind="stable")
        runs.append(_pair(x, dtype))
    (ja, ta), (jb, tb) = runs
    ia, ib = np.arange(oa[-1], dtype=np.int32), 1000 + np.arange(ob[-1], dtype=np.int32)
    w = repro.segment_merge(ja, jb, oa, ob, payload=(jnp.asarray(ia), jnp.asarray(ib)),
                            backend="segmented", nan_policy="unsafe")
    g = repro_torch.segment_merge(ta, tb, oa, ob,
                                  payload=(torch.from_numpy(ia), torch.from_numpy(ib)),
                                  backend="segmented", nan_policy="unsafe")
    _same(w, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((8, 24), 8), ((4, 256), 64), ((8, 600), 16)])
def test_fused_topk_ties_signed_zeros(dtype, shape, k):
    """The router kernel (rows of 24 and 256) and the vocab kernels (600),
    with a payload gathered at the winners."""
    rng = np.random.default_rng(shape[1] + k)
    jx, tx = _pair(_zeros_heavy(rng, shape), dtype)
    ids = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    w = repro.topk(jx, k, payload=jnp.asarray(ids), backend="pallas", nan_policy="unsafe")
    g = repro_torch.topk(tx, k, payload=torch.from_numpy(ids), backend="cuda",
                         nan_policy="unsafe")
    _same(w, g)


# ---------------------------------------------------------------------------
# rows 3-5: the one-hot permute's negative zeros
# ---------------------------------------------------------------------------


def _negative_rows(rng, shape, mixed_every=3):
    """Rows of -1.5, -0.5 and -0.0 (every value's sign bit set), every
    ``mixed_every``-th row with +0.0 and 0.5 as well."""
    x = rng.choice(np.array([-1.5, -0.5, -0.0], np.float32), size=shape)
    x[::mixed_every] = rng.choice(np.array([-1.5, -0.5, -0.0, 0.0, 0.5], np.float32),
                                  size=x[::mixed_every].shape)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,block,k", [(6, 6, 3), (8, 4, 2), (8, 4, 4), (24, 3, 1),
                                       (14, 7, 3), (16, 4, 3)])
def test_router_plain_keeps_the_permutes_negative_zeros(dtype, e, block, k):
    jx, tx = _pair(_negative_rows(np.random.default_rng(e * k + block), (8, e)), dtype)
    w = router_topk_pallas(jx, k=k, block=block, use_mxu=True, interpret=True)
    g = K.router_topk_plain(tx, k, block, zero_ties=True)
    _same(w, g)
    negative = np.signbit(np.asarray(w[0], np.float32)) & (np.asarray(w[0], np.float32) == 0)
    assert negative.any() == K.signed_zero_rule(block, k, e // block)


@pytest.mark.parametrize("v,block,k", [(600, 4, 2), (520, 3, 1), (600, 4, 4)])
def test_vocab_plain_keeps_the_permutes_negative_zeros(v, block, k):
    jx, tx = _pair(_negative_rows(np.random.default_rng(v + k), (8, v)), "float32")
    w = vocab_topk_pallas(jx, k=k, block=block, use_mxu=True, interpret=True)
    _same(w, K.vocab_topk_plain(tx, k, block, zero_ties=True))
    if not K.signed_zero_rule(block, k, K.vocab_blocks(v, block)):
        return
    signs = torch.zeros(8, dtype=torch.int32)  # phase 1 hands the tree its flags
    keys, idx = K.vocab_phase1(tx, k, block, True, signs)
    assert signs.tolist() == [int(not np.signbit(r).all()) for r in np.asarray(jx)]
    _same(w, [t[:, 0, :k] for t in K.vocab_merge_tree(keys, idx, k, tx.dtype, signs)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e", [6, 7])
def test_fused_topk_keeps_negative_zeros(dtype, e):
    """Rows of 6 and 7: one block of the row's width, the permute of its
    sort short enough to keep -0.0 where every value is negative."""
    jx, tx = _pair(_negative_rows(np.random.default_rng(e), (8, e)), dtype)
    w = repro.topk(jx, 3, backend="pallas", nan_policy="unsafe")
    _same(w, repro_torch.topk(tx, 3, backend="cuda", nan_policy="unsafe"))
    assert (np.signbit(np.asarray(w[0], np.float32)) & (np.asarray(w[0], np.float32) == 0)).any()


# ---------------------------------------------------------------------------
# the spills past the class width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descending", [False, True])
def test_values_only_sort_spill_ties_signed_zeros(descending):
    """A segment of 1300 (three tiles of 512 and two grid merges)."""
    offs = (0, 60, 1360)
    jx, tx = _pair(_zeros_heavy(np.random.default_rng(7 + descending), offs[-1]), "float32")
    w = repro.segment_sort(jx, offs, descending=descending, backend="segmented",
                           nan_policy="unsafe")
    g = repro_torch.segment_sort(tx, offs, descending=descending, backend="segmented",
                                 nan_policy="unsafe")
    _same((w,), (g,))


def test_values_only_merge_spill_ties_signed_zeros():
    """One pair of 700 + 500 (past the class width): one grid merge."""
    rng = np.random.default_rng(8)
    oa, ob = (0, 30, 730), (0, 20, 520)
    runs = []
    for offs in (oa, ob):
        x = _zeros_heavy(rng, offs[-1])
        for s, e in zip(offs[:-1], offs[1:]):
            x[s:e] = np.sort(x[s:e], kind="stable")
        runs.append(_pair(x, "float32"))
    (ja, ta), (jb, tb) = runs
    w = repro.segment_merge(ja, jb, oa, ob, backend="segmented", nan_policy="unsafe")
    g = repro_torch.segment_merge(ta, tb, oa, ob, backend="segmented", nan_policy="unsafe")
    _same(w, g)


@pytest.mark.parametrize("descending", [True, False])
def test_topk_spill_ties_signed_zeros(descending, monkeypatch):
    """A segment of 1100, k 900: the cut falls inside the zeros."""
    import repro.api.ops as j_ops

    j_topk = j_ops.topk
    monkeypatch.setattr(j_ops, "topk",
                        lambda x, k, **kw: j_topk(x, k, backend="pallas", **kw))
    offs = (0, 40, 1140)
    jx, tx = _pair(_zeros_heavy(np.random.default_rng(9 + descending), offs[-1]), "float32")
    w = repro.segment_topk(jx, offs, [5, 900], descending=descending, backend="segmented",
                           nan_policy="unsafe")
    g = repro_torch.segment_topk(tx, offs, [5, 900], descending=descending,
                                 backend="segmented", nan_policy="unsafe")
    _same(w, g)
