"""CPU parity of the port's schedule executor against the reference's
(``repro.api.schedules``), and of the pure-Python structures under it.

* ``schedules.sort`` for each kind (loms, bitonic, oems, rank) at n = 1,
  7, 37 and 64, with and without a payload, on int32 rows with heavy
  ties: values and payload lanes bit-equal.
* ``schedules.topk``: an odd block count, dtype-minimum ties with the
  pads, pad index -1, int32 and float32 rows.
* The 2-way merge of each kind, ragged (7 + 5) and stable through the
  library, and ``median9``.
* Batcher's schedules, ``program_to_schedule`` /
  ``sort_program_to_schedule`` and ``core.metrics`` equal to the
  reference's (pure Python, no JAX compute).
* The executor's slabbed comparison clouds equal the whole cloud at a
  forced budget of a few bytes, on sorted and on unsorted runs (the
  reference's faulty devices).

Tolerance: bit-equal everywhere. The reference's executor compiles a
network per shape on the CPU (seconds each), so the shapes are few.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api import schedules as JS
from repro.core import batcher as jbatcher
from repro.core import metrics as jmetrics
from repro.networks import program as jprogram

import repro_torch
from repro_torch.api import schedules as TS
from repro_torch.core import batcher as tbatcher
from repro_torch.core import metrics as tmetrics
from repro_torch.core import networks as tnet
from repro_torch.networks import program as tprogram


def _same(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.ascontiguousarray(np.asarray(w))
        g = np.ascontiguousarray(g.numpy())
        assert w.dtype == g.dtype and w.shape == g.shape, (w.dtype, g.dtype, w.shape, g.shape)
        if w.dtype.kind == "f":
            w, g = w.view(np.uint8), g.view(np.uint8)
        np.testing.assert_array_equal(g, w)


def _jit(fn, *arrays, **static):
    """The reference's executor call under one ``jax.jit``: one compile of
    the whole network where eager dispatch compiles op after op; its
    compares and selects give the same bits either way."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _ties(rng, shape):
    x = rng.integers(-3, 4, shape).astype(np.int32)
    x[rng.random(shape) < 0.1] = np.iinfo(np.int32).max
    x[rng.random(shape) < 0.1] = np.iinfo(np.int32).min
    return x


@pytest.mark.parametrize("kind", ["loms", "bitonic", "oems", "rank"])
@pytest.mark.parametrize("n", [1, 7, 37, 64])
def test_schedule_sort_matches_reference(kind, n):
    rng = np.random.default_rng(n)
    x = _ties(rng, (3, n))
    pay = rng.integers(0, 1000, (3, n)).astype(np.int32)
    _same(_jit(JS.sort, jnp.asarray(x), kind=kind), TS.sort(torch.from_numpy(x), kind=kind))
    _same(_jit(lambda v, p: JS.sort(v, kind=kind, payload=p), jnp.asarray(x), jnp.asarray(pay)),
          TS.sort(torch.from_numpy(x), kind=kind, payload=torch.from_numpy(pay)))


@pytest.mark.parametrize("dtype,n,k,block", [("int32", 37, 5, 8), ("int32", 40, 8, 16),
                                             ("float32", 70, 3, 0)])
def test_schedule_topk_matches_reference(dtype, n, k, block):
    """37 / 8 = 5 blocks (an odd tail carried), the dtype minimum tying
    the pads, pad index -1 (block 8 > 37 % 8 pads)."""
    rng = np.random.default_rng(n + k)
    x = _ties(rng, (2, n)) if dtype == "int32" else (
        rng.integers(-2, 3, (2, n)) * 0.5).astype(np.float32)
    x[0, :8] = np.iinfo(np.int32).min if dtype == "int32" else -np.inf
    want = _jit(JS.topk, jnp.asarray(x), k=k, block=block)
    got = TS.topk(torch.from_numpy(x), k, block=block)
    _same(want, got)
    _same(want[0], TS.topk(torch.from_numpy(x), k, block=block, with_indices=False))
    if dtype == "int32" and block == 8:
        x[1] = np.iinfo(np.int32).min  # every lane ties the pads
        _same(_jit(JS.topk, jnp.asarray(x), k=n, block=block), TS.topk(torch.from_numpy(x), n,
                                                               block=block))


@pytest.mark.parametrize("kind,m,n", [("loms", 8, 8), ("loms", 7, 5), ("s2ms", 6, 10),
                                      ("batcher-oe", 8, 8), ("batcher-bitonic", 4, 4)])
def test_schedule_merge_matches_reference(kind, m, n):
    rng = np.random.default_rng(m * n)
    a = np.sort(_ties(rng, (3, m)), -1)
    b = np.sort(_ties(rng, (3, n)), -1)
    pa = np.arange(3 * m, dtype=np.int32).reshape(3, m)
    pb = np.arange(3 * n, dtype=np.int32).reshape(3, n) + 100
    _same(_jit(JS.merge, jnp.asarray(a), jnp.asarray(b), kind=kind),
          TS.merge(torch.from_numpy(a), torch.from_numpy(b), kind=kind))
    _same(_jit(lambda u, v, p, q: JS.merge(u, v, kind=kind, payload=(p, q)), jnp.asarray(a),
               jnp.asarray(b), jnp.asarray(pa), jnp.asarray(pb)),
          TS.merge(torch.from_numpy(a), torch.from_numpy(b), kind=kind,
                   payload=(torch.from_numpy(pa), torch.from_numpy(pb))))


def test_library_ragged_and_stable_merges_match_reference():
    """The library's schedule routes: 7 + 5 (ragged) and a stable merge,
    descending, with a payload; and two lists with network="s2ms" (the
    2-way device, not a k-way one)."""
    rng = np.random.default_rng(3)
    for (m, n), stable in (((7, 5), False), ((8, 8), True)):
        a = -np.sort(-_ties(rng, (2, m)), -1)
        b = -np.sort(-_ties(rng, (2, n)), -1)
        pa = rng.integers(0, 99, (2, m)).astype(np.int32)
        pb = rng.integers(0, 99, (2, n)).astype(np.int32)
        want = repro.merge(jnp.asarray(a), jnp.asarray(b), descending=True, stable=stable,
                           payload=(jnp.asarray(pa), jnp.asarray(pb)), backend="schedule")
        got = repro_torch.merge(torch.from_numpy(a), torch.from_numpy(b), descending=True,
                                stable=stable, payload=(torch.from_numpy(pa),
                                                        torch.from_numpy(pb)))
        _same(want, got)
    a, b = np.sort(_ties(rng, (2, 6)), -1), np.sort(_ties(rng, (2, 10)), -1)
    _same(repro.merge(jnp.asarray(a), jnp.asarray(b), network="s2ms"),
          repro_torch.merge(torch.from_numpy(a), torch.from_numpy(b), network="s2ms"))


def test_median9_matches_reference():
    x = np.random.default_rng(9).standard_normal((5, 4, 9)).astype(np.float32)
    x[0, 0, :3] = x[0, 0, 3]
    _same(_jit(JS.median9, jnp.asarray(x)), TS.median9(torch.from_numpy(x)))


def _sched_fields(s):
    return (s.name, s.size, s.setup_scatter, s.output_gather, s.meta,
            tuple(tuple((g.idx, g.runs) for g in st.groups) for st in s.stages))


def test_batcher_schedules_match_reference():
    for fn, args in (("oems_merge", (8, 8)), ("bitonic_merge", (4, 4)),
                     ("oems_sort", (16,)), ("bitonic_sort", (16,))):
        assert _sched_fields(getattr(tbatcher, fn)(*args)) == _sched_fields(
            getattr(jbatcher, fn)(*args)), fn
    with pytest.raises(ValueError):
        tbatcher.oems_merge(8, 4)


def test_program_lifts_and_metrics_match_reference():
    from repro.networks import merge_program as jmp
    from repro.networks import sort_program as jsp

    from repro_torch.networks import merge_program as tmp
    from repro_torch.networks import sort_program as tsp

    for fam, m, n in (("loms", 8, 8), ("s2ms", 6, 10), ("bitonic", 8, 8),
                      ("periodic3", 8, 8)):
        want = jprogram.program_to_schedule(jmp(fam, m, n))
        got = tprogram.program_to_schedule(tmp(fam, m, n))
        assert _sched_fields(got) == _sched_fields(want), fam
        for bits, mode in ((32, "2insLUT"), (16, "4insLUT")):
            assert tmetrics.lut_proxy(got, bits, mode) == jmetrics.lut_proxy(want, bits, mode)
            assert tmetrics.series_levels(got, mode) == jmetrics.series_levels(want, mode)
        assert tmetrics.summarize(got) == jmetrics.summarize(want)
        assert tmetrics.vmem_bytes(got, 16, 4) == jmetrics.vmem_bytes(want, 16, 4)
    want = jprogram.sort_program_to_schedule(jsp("s2ms", 16))
    assert _sched_fields(tprogram.sort_program_to_schedule(tsp("s2ms", 16))) == \
        _sched_fields(want)
    with pytest.raises(ValueError, match="composable"):
        tprogram.sort_program_to_schedule(tsp("bitonic", 16))


@pytest.mark.parametrize("sorted_runs", [True, False])
def test_slabbed_cloud_equals_whole_cloud(monkeypatch, sorted_runs):
    """At a budget of a few bytes every slab is one query row; the ranks,
    and so the outputs, equal the whole cloud's (unsorted runs too: the
    counts add, whatever the input)."""
    rng = np.random.default_rng(int(sorted_runs))
    x = torch.from_numpy(_ties(rng, (3, 2, 24)))
    if sorted_runs:
        x = torch.cat([torch.sort(x[..., :10]).values, torch.sort(x[..., 10:]).values], -1)
    pay = torch.arange(24, dtype=torch.int32).expand(3, 2, 24)
    whole = (tnet.rank_sort(x, pay), tnet.rank_merge_runs(x, (10, 9, 5), pay),
             tnet.apply_schedule(tbatcher.oems_sort(32), torch.cat([x, x[..., :8]], -1)))
    monkeypatch.setattr(tnet, "CLOUD_BUDGET", 8)
    assert len(tnet._slabs(6, 24, 24)) == 24
    slabbed = (tnet.rank_sort(x, pay), tnet.rank_merge_runs(x, (10, 9, 5), pay),
               tnet.apply_schedule(tbatcher.oems_sort(32), torch.cat([x, x[..., :8]], -1)))
    for w, g in zip(whole, slabbed):
        for a, b in zip(w if isinstance(w, tuple) else (w,), g if isinstance(g, tuple) else (g,)):
            assert torch.equal(a, b)
    # and the sort at 64 under the small budget still equals the reference
    xs = _ties(rng, (2, 64))
    _same(_jit(JS.sort, jnp.asarray(xs)), TS.sort(torch.from_numpy(xs)))


def test_executor_uploads_a_wiring_once():
    sched = tbatcher.oems_sort(8)
    x = torch.zeros(2, 8, dtype=torch.int32)
    tnet.apply_schedule(sched, x)
    n = len(tnet._DEVICE_INDEX)
    tnet.apply_schedule(sched, x + 1)
    assert len(tnet._DEVICE_INDEX) == n
