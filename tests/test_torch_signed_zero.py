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

Tolerance: bit-equal: values as their bits (the sign of every zero
included), int32 indices, payload lanes and offsets. The class kernels
gather raw values, so a -0.0 stays -0.0; the top-k kernels put out the
reference's one-hot permute's +0.0 for either zero, the decode of the
shared key.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro

import repro_torch
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
