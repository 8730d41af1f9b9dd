"""CPU parity of the port's backend registry, explicit ``backend=`` asks,
``topk``'s full signature, ``nan_policy="unsafe"``, uint32 keys, the lax
median, the exact nucleus and the autotune cache against the reference.

* ``backend_names`` and ``decision_table`` equal the reference's, with
  ``pallas`` named ``cuda`` (its accelerator rows, ``"tpu"``, for the
  port's ``"cuda"``), with the fused and segmented switches on and off;
  ``plan()``'s segmented rows too.
* Explicit asks run the named backend: ``cuda`` against the reference's
  ``pallas`` (its kernels in interpret mode), ``schedule`` / ``streaming``
  against the same names, ``lax`` equal in value. Asks a backend cannot
  run raise ``ValueError``, as there; so does ``sharded`` without a
  ``par`` (``tests/test_torch_parallel.py`` runs it with one).
* ``topk`` with ``axis=``, ``payload=``, ``block=``, ``with_indices``,
  integer keys and ``descending=False``; uint32 rows holding 0 and
  2^32 - 1 through every op; the median of unequal and even lists (the
  lax rung, as the reference's ladder answers).
* ``sample_topp(k_max=None)`` at vocab 256 with one gumbel draw.
* A cache file written by ``repro.streaming.cache`` is read by the
  port's (same ``plan_key`` strings) and changes the plan; the autotune
  tournament with an injected deterministic timer picks and persists its
  winner; recorded route samples override the rule.

Tolerance: bit-equal (values as bits, int32 indices and payload lanes),
except the lax rung's float values: equal. The reference is pointed at
an empty autotune cache, the port at its own temporary ones. The
reference's calls on the schedule executor and its kernels run under one
``jax.jit`` each (``_jit``): one compile of the whole network where eager
dispatch compiles op after op; the compares and selects give the same
bits either way.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api.spec import SortSpec as JSpec

import repro_torch
from repro_torch.api import SortSpec
from repro_torch.streaming import cache as tcache
from repro_torch.streaming import planner as tplanner


@pytest.fixture(scope="module", autouse=True)
def empty_caches(tmp_path_factory):
    from repro.resilience import breaker
    from repro.streaming.cache import AutotuneCache, set_default_cache

    d = tmp_path_factory.mktemp("autotune")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(d / "ref.json")
    prev = set_default_cache(AutotuneCache(str(d / "ref.json")))
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(str(d / "port.json")))
    yield
    set_default_cache(prev)
    tcache.set_default_cache(prev_t)
    breaker.reset()
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


def _same(want, got, values_equal=False):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.ascontiguousarray(np.asarray(w))
        g = np.ascontiguousarray(g.detach().numpy())
        assert w.dtype == g.dtype and w.shape == g.shape, (w.dtype, g.dtype, w.shape, g.shape)
        if w.dtype.kind == "f" and not values_equal:
            w, g = w.view(np.uint8), g.view(np.uint8)
        np.testing.assert_array_equal(g, w)


def _jit(fn, *arrays, **static):
    """The reference's call ``fn(*arrays, **static)`` under one ``jax.jit``."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _sorted_f32(rng, shape, desc=False):
    x = np.sort((rng.integers(-4, 5, shape) * 0.5).astype(np.float32), -1)
    return x[..., ::-1].copy() if desc else x


# ---------------------------------------------------------------------------
# the registry and the table
# ---------------------------------------------------------------------------


def test_backend_names_match_reference():
    """The reference's built-in backends (other tests register their own
    in its process-wide registry)."""
    builtin = [n for n in repro.backend_names() if all(
        f.__module__ == "repro.api.registry" for f in repro.get_backend(n).run.values())]
    want = tuple(sorted("cuda" if n == "pallas" else n for n in builtin))
    assert repro_torch.backend_names() == want
    with pytest.raises(ValueError, match="unknown backend"):
        repro_torch.get_backend("nope")
    be = repro_torch.get_backend("schedule")
    with pytest.raises(ValueError, match="already registered"):
        repro_torch.register_backend(be)
    repro_torch.register_backend(be, overwrite=True)


def _row(r, rename=False):
    def name(s):
        return s.replace("pallas", "cuda") if rename and s else s

    return (r["op"], r["sharded"], r["payload"], r["segments"], name(r["backend"]),
            name(r["detail"]), r["network"], r["source"])


@pytest.mark.parametrize(
    "ref_dev,dev,fused,segmented",
    [("tpu", "cuda", True, True), ("cpu", "cpu", True, True),
     ("tpu", "cuda", False, True), ("tpu", "cuda", True, False),
     ("tpu", "cuda", False, False), ("cpu", "cpu", False, False)],
    ids=["tpu-cuda", "cpu-cpu", "tpu-cuda-fused_off", "tpu-cuda-segmented_off",
         "tpu-cuda-both_off", "cpu-cpu-both_off"])
def test_decision_table_matches_reference(ref_dev, dev, fused, segmented):
    """With each switch on and off (both packages' ``set_fused_enabled`` /
    ``set_segmented_enabled``, restored after)."""
    from repro.api.fused import set_fused_enabled as j_fused
    from repro.segmented import set_segmented_enabled as j_seg
    from repro_torch.api import set_fused_enabled as t_fused
    from repro_torch.segmented import set_segmented_enabled as t_seg

    prev = j_fused(fused), t_fused(fused), j_seg(segmented), t_seg(segmented)
    try:
        want = [_row(r, rename=True) for r in repro.decision_table(ref_dev)]
        got = [_row(r) for r in repro_torch.decision_table(dev)]
    finally:
        j_fused(prev[0])
        t_fused(prev[1])
        j_seg(prev[2])
        t_seg(prev[3])
    assert got == want
    assert all(r["tuned_us"] is None for r in repro_torch.decision_table(dev))


@pytest.mark.parametrize("offs,op,k", [(((0, 3, 40, 41, 168),), "sort", None),
                                       (((0, 32, 64, 96),), "topk", 8),
                                       (((0, 5, 12), (0, 16, 20)), "merge", None)])
def test_segmented_plan_rows_match_reference(offs, op, k):
    lens = tuple(o[-1] for o in offs)
    for ref_dev, dev in (("tpu", "cuda"), ("cpu", "cpu")):
        want = repro.plan(JSpec(op=op, lengths=lens, k=k, device=ref_dev,
                                segment_offsets=offs))
        got = repro_torch.plan(SortSpec(op=op, lengths=lens, k=k, device=dev,
                                        segment_offsets=offs))
        assert (got.backend, got.detail.replace("cuda", "pallas")) == (want.backend,
                                                                       want.detail)
    spec = SortSpec(op=op, lengths=lens, k=k, segment_offsets=offs, backend="schedule")
    with pytest.raises(ValueError, match="cannot run"):
        repro_torch.plan(spec)


# ---------------------------------------------------------------------------
# explicit asks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merge_asks():
    """One merge of (4, 16 + 16) f32 through every backend of the
    reference (``pallas`` for the port's ``cuda``)."""
    rng = np.random.default_rng(11)
    a, b = _sorted_f32(rng, (4, 16)), _sorted_f32(rng, (4, 16))
    pa, pb = (np.arange(64, dtype=np.int32).reshape(4, 16) + off for off in (0, 64))
    want = {be: repro.merge(jnp.asarray(a), jnp.asarray(b), backend=be)
            for be in ("pallas", "schedule", "streaming", "lax")}
    want["schedule_payload"] = repro.merge(jnp.asarray(a), jnp.asarray(b), backend="schedule",
                                           payload=(jnp.asarray(pa), jnp.asarray(pb)))
    want["lax_payload"] = repro.merge(jnp.asarray(a), jnp.asarray(b), backend="lax",
                                      payload=(jnp.asarray(pa), jnp.asarray(pb)))
    return (a, b, pa, pb), want


@pytest.mark.parametrize("backend", ["cuda", "schedule", "streaming", "lax"])
def test_explicit_merge_asks_match_reference(merge_asks, backend):
    (a, b, pa, pb), want = merge_asks
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = repro_torch.merge(ta, tb, backend=backend)
    _same(want["pallas" if backend == "cuda" else backend], got,
          values_equal=backend == "lax")
    if backend in ("schedule", "lax"):
        got = repro_torch.merge(ta, tb, backend=backend,
                                payload=(torch.from_numpy(pa), torch.from_numpy(pb)))
        _same(want[f"{backend}_payload"], got, values_equal=backend == "lax")


def test_explicit_asks_a_backend_cannot_run_raise():
    x = torch.zeros(2, 8)
    pay = (torch.zeros(2, 8), torch.zeros(2, 8))
    for call in (lambda: repro_torch.merge(x, x, payload=pay, backend="streaming"),
                 lambda: repro_torch.sort(x, backend="streaming"),
                 lambda: repro_torch.sort(x, stable=True, backend="cuda"),
                 lambda: repro_torch.merge(x, x, network="mwms", backend="cuda"),
                 lambda: repro_torch.topk(x, 2, backend="streaming"),
                 lambda: repro_torch.topk(x, 2, descending=False, backend="cuda"),
                 lambda: repro_torch.median_of_lists([x[:, :5]] * 4, backend="cuda"),
                 lambda: repro_torch.segment_sort(x[0], (0, 8), backend="schedule"),
                 lambda: repro_torch.sort(x, backend="nope")):
        with pytest.raises(ValueError):
            call()
    jx = jnp.zeros((2, 8))
    with pytest.raises(ValueError):
        repro.merge(jx, jx, payload=(jx, jx), backend="streaming")
    # without a Parallelism no spec is sharded: both packages refuse the ask
    with pytest.raises(ValueError, match="backend 'sharded' cannot run"):
        repro.sort(jx, backend="sharded")
    with pytest.raises(ValueError, match="backend 'sharded' cannot run"):
        repro_torch.sort(x, backend="sharded")


def test_explicit_sort_and_topk_asks_match_reference():
    rng = np.random.default_rng(4)
    x = (rng.integers(-4, 5, (3, 24)) * 0.5).astype(np.float32)
    pay = np.arange(72, dtype=np.int32).reshape(3, 24)
    for be in ("schedule", "lax"):
        _same(_jit(repro.sort, jnp.asarray(x), backend=be, payload=jnp.asarray(pay),
                   stable=True),
              repro_torch.sort(torch.from_numpy(x), backend=be, payload=torch.from_numpy(pay),
                               stable=True), values_equal=be == "lax")
        _same(_jit(repro.topk, jnp.asarray(x), k=5, backend=be),
              repro_torch.topk(torch.from_numpy(x), 5, backend=be), values_equal=be == "lax")
    _same(_jit(repro.topk, jnp.asarray(x), k=5, backend="pallas"),
          repro_torch.topk(torch.from_numpy(x), 5, backend="cuda"))
    # the values-only kernel wrappers: top-k, and a merge2 with no kernel layout
    from repro.kernels import ops as jkops

    from repro_torch.kernels import ops as tkops

    _same(_jit(jkops.topk, jnp.asarray(x), k=5), tkops.topk(torch.from_numpy(x), 5))
    a, b = np.sort(x[:, :7], -1), np.sort(x[:, 7:12], -1)
    _same(_jit(jkops.merge2, jnp.asarray(a), jnp.asarray(b), n_cols=3),
          tkops.merge2(torch.from_numpy(a), torch.from_numpy(b), n_cols=3))


# ---------------------------------------------------------------------------
# topk's full signature, unsafe floats, uint32, the lax median
# ---------------------------------------------------------------------------


def test_topk_new_arguments_match_reference():
    rng = np.random.default_rng(21)
    # integer keys: the top-k kernels on raw int32, the reference's accelerator route
    x = rng.integers(-6, 6, (50, 3)).astype(np.int32)
    feat = rng.standard_normal((50, 3, 2)).astype(np.float32)
    w = _jit(lambda v, f: repro.topk(v, 6, axis=0, block=16, payload={"f": f},
                                     backend="pallas"), jnp.asarray(x), jnp.asarray(feat))
    g = repro_torch.topk(torch.from_numpy(x), 6, axis=0, block=16,
                         payload={"f": torch.from_numpy(feat)})
    _same(w[:2] + (w[2]["f"],), g[:2] + (g[2]["f"],))
    _same(_jit(repro.topk, jnp.asarray(x), k=6, axis=0, with_indices=False, backend="pallas"),
          repro_torch.topk(torch.from_numpy(x), 6, axis=0, with_indices=False))
    _same(_jit(repro.topk, jnp.asarray(x), k=6, axis=0, descending=False, stable=True),
          repro_torch.topk(torch.from_numpy(x), 6, axis=0, descending=False, stable=True))
    xf = (rng.integers(-6, 6, (3, 40)) * 0.25).astype(np.float32)
    _same(_jit(repro.topk, jnp.asarray(xf), k=4, descending=False),
          repro_torch.topk(torch.from_numpy(xf), 4, descending=False))
    # float keys on the kernels' route, a payload gathered at the winners
    _same(_jit(lambda v: repro.topk(v, 4, axis=0, backend="pallas", payload=v),
               jnp.asarray(xf.T.copy())),
          repro_torch.topk(torch.from_numpy(xf.T.copy()), 4, axis=0,
                           payload=torch.from_numpy(xf.T.copy())))


def test_unsafe_floats_match_reference():
    """Finite values without -0.0 / +0.0 mixes (what ``unsafe`` admits,
    and where the port's key order is the raw floats')."""
    rng = np.random.default_rng(8)
    x = (rng.integers(-8, 9, (4, 12)) * 0.5 + 0.25).astype(np.float32)
    tx = torch.from_numpy(x)
    _same(_jit(lambda v: repro.sort(v, nan_policy="unsafe", backend="schedule", stable=True,
                                    payload=v), jnp.asarray(x)),
          repro_torch.sort(tx, nan_policy="unsafe", backend="schedule", stable=True,
                           payload=tx))
    _same(_jit(repro.sort, jnp.asarray(x), nan_policy="unsafe"),
          repro_torch.sort(tx, nan_policy="unsafe"))
    _same(_jit(repro.topk, jnp.asarray(x), k=3, nan_policy="unsafe", backend="pallas"),
          repro_torch.topk(tx, 3, nan_policy="unsafe"))
    offs = (0, 5, 12, 30, 48)
    w = _jit(repro.segment_sort, jnp.asarray(x.reshape(-1)), segment_offsets=offs,
             nan_policy="unsafe", backend="segmented")
    _same(w, repro_torch.segment_sort(tx.reshape(-1), offs, nan_policy="unsafe"))
    w = _jit(repro.segment_topk, jnp.asarray(x.reshape(-1)), segment_offsets=offs, k=3,
             nan_policy="unsafe", backend="segmented")
    g = repro_torch.segment_topk(tx.reshape(-1), offs, 3, nan_policy="unsafe")
    _same(w[:2], g[:2])
    with pytest.raises(ValueError, match="nan_policy"):
        repro_torch.sort(tx, nan_policy="first")


def test_uint32_matches_reference():
    rng = np.random.default_rng(32)
    u = rng.integers(0, 2 ** 32, (3, 24), dtype=np.uint64).astype(np.uint32)
    u[0, :4] = (0, 2 ** 32 - 1, 0, 2 ** 32 - 1)
    tu = torch.from_numpy(u)
    _same(_jit(repro.sort, jnp.asarray(u)), repro_torch.sort(tu))
    pay = np.arange(72, dtype=np.int32).reshape(3, 24)
    _same(_jit(repro.sort, jnp.asarray(u), payload=jnp.asarray(pay), descending=True,
               backend="schedule"),
          repro_torch.sort(tu, payload=torch.from_numpy(pay), descending=True,
                           backend="schedule"))
    _same(_jit(repro.topk, jnp.asarray(u), k=5), repro_torch.topk(tu, 5))
    a, b = np.sort(u[:, :12], -1), np.sort(u[:, 12:], -1)
    _same(_jit(repro.merge, jnp.asarray(a), jnp.asarray(b)),
          repro_torch.merge(torch.from_numpy(a), torch.from_numpy(b)))
    lists = [np.sort(u[:, 8 * j:8 * j + 7], -1) for j in range(3)]
    _same(_jit(lambda *ls: repro.merge_k(list(ls)), *map(jnp.asarray, lists)),
          repro_torch.merge_k([torch.from_numpy(l) for l in lists]))
    _same(_jit(lambda *ls: repro.median_of_lists(list(ls)), *map(jnp.asarray, lists)),
          repro_torch.median_of_lists([torch.from_numpy(l) for l in lists]))


@pytest.mark.parametrize("lens", [(5, 7), (4, 4, 4), (5, 5, 5, 5)])
def test_median_of_unequal_or_even_lists_matches_reference(lens):
    rng = np.random.default_rng(sum(lens))
    lists = [np.sort(rng.standard_normal((4, n)).astype(np.float32), -1) for n in lens]
    for dev in ("cuda", "cpu"):
        want = repro.plan(JSpec(op="median", lengths=lens,
                                device="tpu" if dev == "cuda" else dev))
        got = repro_torch.plan(SortSpec(op="median", lengths=lens, device=dev))
        assert (got.backend, got.detail) == (want.backend.replace("pallas", "cuda"),
                                             want.detail)
    _same(repro.median_of_lists([jnp.asarray(l) for l in lists]),
          repro_torch.median_of_lists([torch.from_numpy(l) for l in lists]))


def test_keys_match_reference():
    from repro.api import keys as jkeys

    from repro_torch.api import keys as tkeys

    x = np.array([[np.nan, -np.inf, -1.5, -0.0, 0.0, 2.0, np.inf, -np.nan]], np.float32)
    want = jkeys.encode_keys(jnp.asarray(x))
    got = tkeys.encode_keys(torch.from_numpy(x))
    _same(want, got)
    _same(jkeys.decode_keys(want, jnp.float32)[:, 1:7],
          tkeys.decode_keys(got, torch.float32)[:, 1:7])
    assert tkeys.has_key_transform(torch.bfloat16) and not tkeys.has_key_transform(torch.int32)


# ---------------------------------------------------------------------------
# the exact nucleus
# ---------------------------------------------------------------------------


def test_sample_topp_exact_nucleus_matches_reference(monkeypatch):
    """Untied logits: the ranking is unique, so the reference's is run by
    its lax rung (its executor compiles a network per shape, seconds);
    the port's takes its own route (at 256 lanes the fused sort)."""
    from repro import sort as j_sort
    from repro.serving import sample as jsample

    from repro_torch.serving import sample as tsample

    monkeypatch.setattr(jsample, "unified_sort", lambda x, par=None, **kw: j_sort(
        x, backend="lax", **kw))

    logits = np.random.default_rng(5).standard_normal((3, 256)).astype(np.float32) * 3
    key = jax.random.PRNGKey(3)
    want = jsample.sample_topp(key, jnp.asarray(logits), p=0.8, k_max=None)
    noise = np.array(jax.random.gumbel(key, (3, 256), jnp.float32))
    got = tsample.sample_topp(torch.from_numpy(logits), p=0.8, k_max=None,
                              gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the autotune cache and the measured routes
# ---------------------------------------------------------------------------


def test_reference_cache_file_reads_in_the_port(tmp_path):
    from repro.streaming import cache as jcache
    from repro.streaming.planner import MergePlan as JPlan

    path = str(tmp_path / "shared.json")
    jc = jcache.AutotuneCache(path)
    entry = JPlan(kind="loms", network="s2ms", n_cols=1, block_batch=4,
                  use_mxu=False, us=12.5).to_entry()
    for op, shapes, k in (("merge2", (4, 16, 16), None), ("topk", (4, 256), 8)):
        jkey = jcache.plan_key(op, shapes=shapes, dtype="float32", k=k, backend="cpu")
        assert tcache.plan_key(op, shapes=shapes, dtype="float32", k=k, backend="cpu") == jkey
        jc.put(jkey, dict(entry, block=32))
    tc = tcache.AutotuneCache(path)
    got = tplanner.plan_op("merge2", (16, 16), batch=4, cache=tc)
    assert (got.source, got.network, got.n_cols, got.us) == ("cache", "s2ms", 1, 12.5)
    assert tplanner.plan_op("topk", (256,), batch=4, k=8, cache=tc).block == 32
    # stale schema entries are ignored; a corrupt file is quarantined
    tc.put("x|1|k-|float32|cpu", {"n_cols": 2})
    raw = tc._entries["x|1|k-|float32|cpu"]
    tc._entries["x|1|k-|float32|cpu"] = dict(raw, _schema=3)
    assert tc.get("x|1|k-|float32|cpu") is None
    with open(path, "w") as f:
        f.write("{torn")
    assert len(tcache.AutotuneCache(path)) == 0 and os.path.exists(path + ".bad")


def test_cached_winner_changes_the_family_that_runs(tmp_path):
    """A cached s2ms winner at (4, 16 + 16) makes the port's fused merge
    run s2ms, as the reference's fused rung does from the same entry."""
    from repro.streaming import cache as jcache
    from repro.streaming.planner import MergePlan as JPlan

    rng = np.random.default_rng(2)
    a, b = _sorted_f32(rng, (4, 16)), _sorted_f32(rng, (4, 16))
    pa, pb = (np.arange(64, dtype=np.int32).reshape(4, 16) + off for off in (0, 64))
    path = str(tmp_path / "c.json")
    jc = jcache.AutotuneCache(path)
    jc.put(jcache.plan_key("merge2", shapes=(4, 16, 16), dtype="float32", backend="cpu"),
           JPlan(kind="loms", network="s2ms", n_cols=1, block_batch=4).to_entry())
    prev_j = jcache.set_default_cache(jc)
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(path))
    try:
        spec = SortSpec(op="merge", lengths=(16, 16), batch=4, has_payload=True)
        assert repro_torch.plan(spec).network == "s2ms"
        want = repro.merge(jnp.asarray(a), jnp.asarray(b), backend="pallas",
                           payload=(jnp.asarray(pa), jnp.asarray(pb)))
        got = repro_torch.merge(torch.from_numpy(a), torch.from_numpy(b),
                                payload=(torch.from_numpy(pa), torch.from_numpy(pb)))
        _same(want, got)
    finally:
        jcache.set_default_cache(prev_j)
        tcache.set_default_cache(prev_t)


def test_autotune_with_a_deterministic_timer(tmp_path):
    cache = tcache.AutotuneCache(str(tmp_path / "t.json"))
    ran = []

    def timer(plan, fn):  # each candidate runs once; s2ms is "fastest"
        fn()
        ran.append(plan.network)
        return {"s2ms": 1.0, "loms": 2.0 + plan.n_cols}.get(plan.network, 9.0)

    best = tplanner.autotune_merge2(16, 16, batch=4, cache=cache, device="cpu", timer=timer)
    assert best.network == "s2ms" and best.us == 1.0 and "loms" in ran
    assert tplanner.plan_op("merge2", (16, 16), batch=4, cache=cache).network == "s2ms"

    def no_timer(plan, fn):
        raise AssertionError("a cache hit measures nothing")

    assert tplanner.autotune_merge2(16, 16, batch=4, cache=cache, device="cpu",
                                    timer=no_timer).source == "cache"
    best = tplanner.autotune_sort(32, batch=2, cache=cache, device="cpu",
                                  timer=lambda p, fn: (fn(), len(p.network))[1])
    assert best.network == min(tplanner.capable_families("sort", (32,)), key=len)
    best = tplanner.autotune_topk(64, 4, batch=2, cache=cache, device="cpu",
                                  timer=lambda p, fn: (fn(), abs(p.block - 32))[1])
    assert best.block == 32
    best = tplanner.autotune_op("segmented", (16, 16), batch=3, cache=cache, device="cpu",
                                timer=lambda p, fn: (fn(), float(p.network != "loms"))[1])
    assert best.network == "loms"
    assert tplanner.autotune_op("kway", (8, 8), cache=cache).source == "heuristic"


def test_measured_route_samples_override_the_rule(tmp_path):
    from repro.api import dispatch as jdispatch

    from repro_torch.api import dispatch as tdispatch

    prev = tcache.set_default_cache(tcache.AutotuneCache(str(tmp_path / "r.json")))
    try:
        spec = SortSpec(op="merge", lengths=(64, 64), batch=8)
        assert repro_torch.plan(spec).backend == "cuda"
        assert tdispatch._route_key(spec, "cuda").replace(":cuda", ":pallas") == \
            jdispatch._route_key(JSpec(op="merge", lengths=(64, 64), batch=8), "pallas")
        tdispatch.record_route_us(spec, "cuda", 9.0)
        assert repro_torch.plan(spec).source == "rule"  # one sample ranks nothing
        tdispatch.record_route_us(spec, "schedule", 4.0)
        tdispatch.record_route_us(spec, "schedule", 6.0)  # the fastest is kept
        dec = repro_torch.plan(spec)
        assert (dec.backend, dec.source, dec.measured_us) == ("schedule", "measured", 4.0)
        assert tdispatch.measured_route_us(spec, "schedule") == 4.0
        os.environ["REPRO_MEASURED_DISPATCH"] = "0"
        assert repro_torch.plan(spec).backend == "cuda"
    finally:
        os.environ.pop("REPRO_MEASURED_DISPATCH", None)
        tcache.set_default_cache(prev)
