"""CPU parity of the port's switches and hooks against the reference.

* The fused switch (``set_fused_enabled`` / ``REPRO_DISABLE_FUSED``):
  explicit ``backend="cuda"`` sorts and merges with a payload answer on
  the schedule executor, as the reference's ``backend="pallas"`` does;
  ``topk(backend="cuda")`` runs the unfused rung (the kernels on the
  encoded keys) against the reference's unfused ``pallas`` rung in
  interpret mode; the measured ranking drops ``cuda`` for a sort.
* The segmented switch (``set_segmented_enabled`` /
  ``REPRO_DISABLE_SEGMENTED``): auto ``segment_sort`` / ``segment_topk``
  take the per-segment plain version (no class kernel is called) and
  equal ``backend="segmented"`` and the reference's switched-off calls;
  the MoE dispatch's gating predicate.
* ``register_family`` in both packages with the same generators under
  one new name: the capable families, the programs served, the sort
  against the reference's kernel in interpret mode, and a
  re-registration that changes the program the next call runs.
* ``chunked_merge_k(plan=)`` (which tile wins), the empty-list cases
  (1-D lists answer bit for bit, batched rows refuse), and the library
  ops' refusal of an empty list.
* ``PagedKVCache.n_layers`` / ``.nbytes``, ``params_billions`` /
  ``active_params_billions`` of every config, ``cache_with_lengths``.

Tolerance: bit-equal, values as their bits, except where a top-k lane
holds a NaN: the unfused rung restores the input's own value, whose NaN
bits are the host's (a NaN in the same lane is compared, not its bits).
The switches and the family registry are process-global: every test
restores them in ``finally``. Both packages read temporary autotune
caches.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api import fused as jfused
from repro.networks import registry as jreg
from repro.networks.families import BUILTIN_FAMILIES as J_BUILTIN
from repro.segmented import set_segmented_enabled as j_set_segmented

import repro_torch
from repro_torch.api import SortSpec, set_fused_enabled
from repro_torch.api.dispatch import plan, record_route_us
from repro_torch.networks import registry as treg
from repro_torch.networks.families import BUILTIN_FAMILIES as T_BUILTIN
from repro_torch.segmented import set_segmented_enabled
from repro_torch.streaming import cache as tcache


@pytest.fixture(scope="module", autouse=True)
def empty_caches(tmp_path_factory):
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


@contextlib.contextmanager
def switched(fused=True, segmented=True):
    """Both packages' switches set, and restored however the body ends."""
    prev = (jfused.set_fused_enabled(fused), set_fused_enabled(fused),
            j_set_segmented(segmented), set_segmented_enabled(segmented))
    try:
        yield
    finally:
        jfused.set_fused_enabled(prev[0])
        set_fused_enabled(prev[1])
        j_set_segmented(prev[2])
        set_segmented_enabled(prev[3])


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.int32) if a.dtype == torch.float32 else a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(np.shape(w)) == tuple(g.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _both(x: np.ndarray, dtype: str):
    """The same bits as a jax array and a torch tensor."""
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j.view(jnp.int16)).copy()).view(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _logits(rows: int, n: int, seed: int) -> np.ndarray:
    """Heavy ties, NaN, ±inf and ±0.0 (``chip_smoke.special_logits``)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-64, 65, (rows, n)) * 0.125).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    x[1, -5:] = [-0.0, 0.0, np.inf, np.nan, -np.inf]
    x[2, :] = 0.0
    x[2, 1::3] = -0.0
    return x


# ---------------------------------------------------------------------------
# the fused switch
# ---------------------------------------------------------------------------


def test_fused_switch_reads_the_environment(monkeypatch):
    assert repro_torch.api.fused_enabled()
    monkeypatch.setenv("REPRO_DISABLE_FUSED", "1")
    assert not repro_torch.api.fused_enabled() and not jfused.fused_enabled()
    spec = SortSpec(op="sort", lengths=(1024,), batch=8)
    assert (plan(spec).backend, plan(spec).detail) == ("schedule", "loms_merge_tree")
    monkeypatch.delenv("REPRO_DISABLE_FUSED")
    assert plan(spec).detail == "loms_sort_fused"
    with switched(fused=False):
        assert set_fused_enabled(False) is False  # returns the previous setting
        from repro_torch.api.fused import fused_cfg_for

        assert fused_cfg_for(spec, 8, torch.float32) is None


def test_fused_off_explicit_payload_calls_take_the_executor():
    """``backend="cuda"`` with a payload, fused off: the rungs ``fused``,
    ``schedule`` (``resilience/ladder.py``), so the executor answers, as
    the reference's ``backend="pallas"`` (``tests/test_fused.py:203,
    373``); values and payload bit-equal to the reference's."""
    from repro_torch.resilience.ladder import rungs_for

    rng = np.random.default_rng(0)
    x = _logits(3, 40, 1)
    pay = rng.integers(0, 40, (3, 40)).astype(np.int32)
    jx, tx = _both(x, "float32")
    a = np.sort((rng.integers(-4, 5, (4, 16)) * 0.5).astype(np.float32), -1)
    b = np.sort((rng.integers(-4, 5, (4, 16)) * 0.5).astype(np.float32), -1)
    pa, pb = (np.arange(64, dtype=np.int32).reshape(4, 16) + off for off in (0, 64))
    with switched(fused=False):
        spec = SortSpec(op="sort", lengths=(40,), batch=3, has_payload=True, backend="cuda")
        assert rungs_for(spec, plan(spec)) == ["fused", "schedule"]
        want = jax.jit(lambda v, p: repro.sort(v, payload=p, backend="pallas"))(
            jx, jnp.asarray(pay))
        got = repro_torch.sort(tx, payload=torch.from_numpy(pay), backend="cuda")
        _same(want, got)
        _same(repro_torch.sort(tx, payload=torch.from_numpy(pay), backend="schedule"), got)
        want = jax.jit(lambda p, q, r, s: repro.merge(p, q, payload=(r, s), backend="pallas"))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(pa), jnp.asarray(pb))
        got = repro_torch.merge(torch.from_numpy(a), torch.from_numpy(b), backend="cuda",
                                payload=(torch.from_numpy(pa), torch.from_numpy(pb)))
        _same(want, got)


@pytest.fixture(scope="module")
def topk_runs():
    """Explicit ``topk`` of the kernel backend, fused on and off, in both
    packages: the vocab kernels (bf16, 640 wide) and the router kernel
    (f32, 256 wide), with ties and signed zeros."""
    out = {}
    for dtype, n, k in (("bfloat16", 640, 64), ("float32", 256, 8)):
        jx, tx = _both(_logits(4, n, 3), dtype)
        run = {}
        for fused in (True, False):
            with switched(fused=fused):
                run[fused] = (jax.jit(lambda v: repro.topk(v, k, backend="pallas"))(jx),
                              repro_torch.topk(tx, k, backend="cuda"))
        out[dtype] = run
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_off_topk_matches_the_unfused_reference(topk_runs, dtype):
    """The unfused ``cuda`` rung against the reference's unfused
    ``pallas`` rung (``ops.py:496-505``): indices bit-equal, values
    bit-equal but in NaN lanes (NaN in both)."""
    (jv, ji), (tv, ti) = topk_runs[dtype][False]
    _same(ji, ti)
    w, g = _bits(jv), _bits(tv)
    nan = np.isnan(np.asarray(jv, np.float32))
    assert np.array_equal(nan, torch.isnan(tv.float()).numpy()) and nan.any()
    np.testing.assert_array_equal(g[~nan], w[~nan])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_topk_tie_order_is_the_same_fused_and_unfused(topk_runs, dtype):
    """Both packages' fused and unfused rungs pick the same lanes (the
    kernels' tie order: the higher index first); the values differ only in
    NaN bits (the fused rung decodes a canonical NaN, the unfused one
    returns the input's)."""
    (jvf, jif), (tvf, tif) = topk_runs[dtype][True]
    (jvu, jiu), (tvu, tiu) = topk_runs[dtype][False]
    np.testing.assert_array_equal(np.asarray(jif), np.asarray(jiu))
    assert torch.equal(tif, tiu)
    _same(jif, tif)
    nan = torch.isnan(tvf.float())
    assert torch.equal(nan, torch.isnan(tvu.float()))
    assert torch.equal(tvf[~nan], tvu[~nan])


def test_fused_off_measured_ranking_drops_cuda(tmp_path):
    """A faster ``cuda`` sample cannot win a sort while fused is off
    (reference ``dispatch.py:380-382``); values-only merges keep it."""
    from repro.api.dispatch import record_route_us as j_record
    from repro.api.spec import SortSpec as JSpec
    from repro.streaming.cache import AutotuneCache, set_default_cache

    prev = set_default_cache(AutotuneCache(str(tmp_path / "ref.json")))
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(str(tmp_path / "port.json")))
    try:
        cases = (("sort", (1024,)), ("merge", (512, 512)))
        for op, lens in cases:
            jspec = JSpec(op=op, lengths=lens, batch=8, device="tpu")
            tspec = SortSpec(op=op, lengths=lens, batch=8)
            for be, us in (("pallas", 1.0), ("schedule", 5.0), ("streaming", 9.0)):
                if repro.get_backend(be).supports(jspec):
                    j_record(jspec, be, us)
                    record_route_us(tspec, "cuda" if be == "pallas" else be, us)
        for fused in (True, False):
            with switched(fused=fused):
                for op, lens in cases:
                    want = repro.plan(JSpec(op=op, lengths=lens, batch=8, device="tpu"))
                    got = plan(SortSpec(op=op, lengths=lens, batch=8))
                    assert (got.backend, got.detail, got.source) == (
                        want.backend.replace("pallas", "cuda"), want.detail, want.source)
        with switched(fused=False):
            assert plan(SortSpec(op="sort", lengths=(1024,), batch=8)).backend == "schedule"
    finally:
        set_default_cache(prev)
        tcache.set_default_cache(prev_t)


# ---------------------------------------------------------------------------
# the segmented switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descending", [False, True])
def test_segmented_off_auto_matches_explicit_and_reference(descending, monkeypatch):
    """The reference's ``tests/test_segmented.py:328-396``: auto with the
    switch off against ``backend="segmented"``; the auto route calls no
    class kernel, the explicit one still does."""
    from repro.api.spec import SortSpec as JSpec
    from repro_torch.segmented import core

    x = np.array([1, 1, 1, 2, 2, 0, 0, 3, -0.0, 0.0, 5, 5], np.float32)
    offs = (0, 8, 12)
    jx, tx = _both(x, "float32")
    jpay, tpay = jnp.arange(12, dtype=jnp.int32), torch.arange(12, dtype=torch.int32)
    calls = []
    real = core.segment_class_sort

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(core, "segment_class_sort", counting)
    kern = repro_torch.segment_sort(tx, offs, payload=tpay, descending=descending,
                                    backend="segmented")
    kv, ki, ko = repro_torch.segment_topk(tx, offs, 3, descending=descending,
                                          backend="segmented")
    assert len(calls) >= 2  # the class kernels ran
    with switched(segmented=False):
        dec = repro.plan(JSpec(op="sort", lengths=(12,), batch=2, device="tpu",
                               segment_offsets=(offs,)))
        got = plan(SortSpec(op="sort", lengths=(12,), batch=2, segment_offsets=(offs,)))
        assert (got.backend, got.detail) == (dec.backend, dec.detail) == ("segmented",
                                                                          "reference")
        calls.clear()
        auto = repro_torch.segment_sort(tx, offs, payload=tpay, descending=descending)
        av, ai, ao = repro_torch.segment_topk(tx, offs, 3, descending=descending)
        assert not calls
        ref = repro.segment_sort(jx, offs, payload=jpay, descending=descending)
        rv, ri, ro = repro.segment_topk(jx, offs, 3, descending=descending)
        repro_torch.segment_sort(tx, offs, backend="segmented")
        assert calls  # an explicit ask still runs the class kernels
    _same(kern, auto)
    _same((kv, ki), (av, ai))
    assert list(ko) == list(ao) == list(np.asarray(ro))
    _same(ref, auto)
    _same((rv, ri), (av, ai))


def test_moe_class_sort_gating_predicate():
    """The sorted dispatch takes the class sort on the card only with no
    ``par``, one size class wide and the switch on (``moe.py:109-111``),
    the reference's class width; on the CPU the executor, whose positions
    equal the one-hot cumsum's."""
    from repro.segmented import max_class_width as j_width
    from repro_torch.models.moe import _positions_cumsum, _positions_sorted, class_sort_dispatch
    from repro_torch.segmented import max_class_width

    w = max_class_width(torch.int32)
    assert w == j_width(jnp.int32)
    assert class_sort_dispatch(w, "cuda") and not class_sort_dispatch(w + 1, "cuda")
    assert not class_sort_dispatch(8, "cpu") and not class_sort_dispatch(8, "cuda", par=object())
    with switched(segmented=False):
        assert not class_sort_dispatch(8, "cuda")
    flat_e = torch.from_numpy(np.random.default_rng(4).integers(0, 4, 24).astype(np.int32))
    assert torch.equal(_positions_sorted(flat_e, 4), _positions_cumsum(flat_e, 4))


# ---------------------------------------------------------------------------
# register_family
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def registered(name: str):
    """Yield a function registering built-in generators under ``name`` in
    both packages; the name is removed from both registries after."""
    def register(builtin: str):
        jreg.register_family(jreg.NetworkFamily(name, *J_BUILTIN[builtin]))
        treg.register_family(treg.NetworkFamily(name, *T_BUILTIN[builtin]))

    try:
        yield register
    finally:
        jreg._REGISTRY.pop(name, None)
        treg._REGISTRY.pop(name, None)
        from repro_torch.kernels.launch import forget_family

        forget_family(name)


def test_register_family_matches_reference_and_replaces_programs():
    from repro.kernels.sort import loms_sort_pallas
    from repro_torch.kernels.launch import program_tensor, sort_prefix
    from repro_torch.kernels.loms_merge import tile_cols
    from repro_torch.kernels.sort import loms_sort_plain
    from repro_torch.streaming.planner import _sort_candidates

    x = np.tile(np.array([3, 1, 2, 1, 0, 2, 2, 1, 3, 0, 1, 2, 1, 3, 0, 0], np.int32), (4, 1))
    x[1] = x[1][::-1]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    def ref_sort(family):
        return jax.jit(lambda v: loms_sort_pallas(v, network=family, interpret=True,
                                                  use_mxu=False, want_perm=True)[:2])(jx)

    with registered("loms_twin") as register:
        assert "loms_twin" not in treg.family_names()
        register("loms")
        assert treg.family_names() == jreg.family_names()
        assert treg.capable_families("sort", (16,)) == jreg.capable_families("sort", (16,))
        assert treg.capable_families("merge2", (8, 8)) == jreg.capable_families("merge2", (8, 8))
        assert "loms_twin" in {c.network for c in _sort_candidates(16, torch.int32)}
        assert not treg.builtin_family("loms_twin") and tile_cols("loms_twin", 8, 8, 2, False) == 0
        words = program_tensor("cpu", "sort", "loms_twin", 16)
        assert torch.equal(words, program_tensor("cpu", "sort", "loms", 16))
        got = loms_sort_plain(tx, network="loms_twin", want_perm=True)[:2]
        _same(ref_sort("loms_twin"), got)
        _same(tuple(loms_sort_plain(tx, want_perm=True)[:2]), got)
        # the name now holds another family; the reference's kernel is
        # jitted with the name static, so its trace under the old family
        # stays cached: hold the port to the reference's bitonic instead
        register("bitonic")
        assert torch.equal(program_tensor("cpu", "sort", "loms_twin", 16),
                           program_tensor("cpu", "sort", "bitonic", 16))
        assert sort_prefix("loms_twin", 16) == sort_prefix("bitonic", 16)
        got = loms_sort_plain(tx, network="loms_twin", want_perm=True)[:2]
        _same(ref_sort("bitonic"), got)
        _same(tuple(loms_sort_plain(tx, network="bitonic", want_perm=True)[:2]), got)
        assert not torch.equal(got[1], loms_sort_plain(tx, want_perm=True)[1])
    assert "loms_twin" not in treg.family_names()


# ---------------------------------------------------------------------------
# chunked_merge_k: plan=, empty lists
# ---------------------------------------------------------------------------


def test_chunked_merge_k_tile_then_plan_then_planner(monkeypatch):
    from repro.streaming.planner import plan_chunked_k as j_plan
    from repro_torch.kernels import kway
    from repro_torch.streaming import chunked
    from repro_torch.streaming.planner import plan_chunked_k

    rng = np.random.default_rng(6)
    lens = (30, 11, 25)
    ls = [np.sort(rng.integers(-9, 10, (2, n)).astype(np.int32), -1) for n in lens]
    tiles, real = [], kway.kway_merge
    monkeypatch.setattr(kway, "kway_merge",
                        lambda rows, sched, *a, **kw: tiles.append(rows.shape[1] // 3)
                        or real(rows, sched, *a, **kw))
    want = jax.jit(lambda v: repro.streaming.chunked_merge_k(
        v, plan=j_plan(lens, batch=2, tile=8), interpret=True))([jnp.asarray(x) for x in ls])
    tl = [torch.from_numpy(x) for x in ls]
    _same(want, repro_torch.chunked_merge_k(tl, plan=plan_chunked_k(lens, batch=2, tile=8)))
    repro_torch.chunked_merge_k(tl, tile=4, plan=plan_chunked_k(lens, batch=2, tile=8))
    repro_torch.chunked_merge_k(tl)
    assert tiles == [8, 4, plan_chunked_k(lens, batch=2).tile]
    grid, real2 = [], chunked.grid_chunked_merge2
    monkeypatch.setattr(chunked, "grid_chunked_merge2",
                        lambda a, b, tile: grid.append(tile) or real2(a, b, tile=tile))
    repro_torch.chunked_merge_k(tl[:2], plan=plan_chunked_k(lens[:2], tile=6))
    assert grid == [6]


@pytest.mark.parametrize("lens,tile", [((5, 0, 7), 4), ((5, 0, 7), None), ((0, 0, 7), 4),
                                       ((0, 5, 0, 3), 4), ((0, 0, 0), None)])
def test_chunked_merge_k_empty_1d_lists_match_reference(lens, tile):
    """1-D lists with empty ones, at a tile and at the planner's."""
    rng = np.random.default_rng(sum(lens))
    ls = [np.sort(rng.standard_normal(n).astype(np.float32)) for n in lens]
    want = jax.jit(lambda v: repro.streaming.chunked_merge_k(v, tile=tile, interpret=True))(
        [jnp.asarray(x) for x in ls])
    _same(want, repro_torch.chunked_merge_k([torch.from_numpy(x) for x in ls], tile=tile))


def test_empty_lists_are_refused_by_name():
    """Batched rows with an empty list, where the reference divides by
    zero: ``chunked_merge_k`` and the library ops name the list."""
    rows = [torch.zeros(3, n) for n in (5, 0, 7)]
    with pytest.raises(ValueError, match=r"list 1 of shape \(3, 0\)"):
        repro_torch.chunked_merge_k(rows)
    with pytest.raises(ZeroDivisionError):
        repro.streaming.chunked_merge_k([jnp.zeros((3, n)) for n in (5, 0, 7)], tile=4)
    with pytest.raises(ValueError, match=r"list 1 of shape \(3, 0\)"):
        repro_torch.merge(rows[0], rows[1])
    with pytest.raises(ValueError, match=r"list 1 of shape \(3, 0\)"):
        repro_torch.merge_k(rows)
    with pytest.raises(ValueError, match=r"list 1 of shape \(3, 0\)"):
        repro_torch.median_of_lists([torch.zeros(3, 3), torch.zeros(3, 0), torch.zeros(3, 3)])
    with pytest.raises(ValueError, match=r"x of shape \(3, 0\)"):
        repro_torch.sort(torch.zeros(3, 0))
    with pytest.raises(ZeroDivisionError):
        repro.sort(jnp.zeros((3, 0)))


# ---------------------------------------------------------------------------
# PagedKVCache, parameter counts, cache_with_lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-moe-30b-a3b"])
def test_paged_cache_layers_and_bytes_match_reference(name):
    from repro.configs import get_smoke_config as j_smoke
    from repro.serving.scheduler.paged import PagedKVCache as JPaged
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.serving.scheduler.paged import PagedKVCache

    want = JPaged(j_smoke(name), 5, 4)
    got = PagedKVCache(get_smoke_config(name), 5, 4, "cpu")
    assert (got.n_layers, got.nbytes) == (want.n_layers, want.nbytes)
    assert got.n_layers == get_smoke_config(name).n_layers


def test_params_and_active_params_match_reference():
    from repro.configs import get_config as j_config, get_smoke_config as j_smoke
    from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

    for name in ARCHS:
        for mine, ref in ((get_config(name), j_config(name)),
                          (get_smoke_config(name), j_smoke(name))):
            assert mine.params_billions() == ref.params_billions(), name
            assert mine.active_params_billions() == ref.active_params_billions(), name
    moe = get_config("qwen3-moe-30b-a3b")
    assert moe.active_params_billions() < moe.params_billions() / 5


@pytest.mark.parametrize("name", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_cache_with_lengths_matches_reference(name):
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import cache_with_lengths as j_cwl, init_cache as j_init
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import cache_with_lengths, init_cache

    lengths = [3, 5]
    want = j_cwl(j_init(j_smoke(name), 2, 8), lengths)
    cache = init_cache(get_smoke_config(name), 2, 8, "cpu")
    got = cache_with_lengths(cache, lengths)
    for group, layers in got.items():
        pos = torch.stack([lc["pos"] for lc in layers])
        ref = want[group]  # stacked layers, or a list of them (a leading dense layer)
        ref = np.stack([lc["pos"] for lc in ref]) if isinstance(ref, list) else ref["pos"]
        np.testing.assert_array_equal(pos.numpy(), np.asarray(ref))
        assert pos.dtype == torch.int32
        assert len({lc["pos"].data_ptr() for lc in layers}) == len(layers)  # own copies
        for old, new in zip(cache[group], layers):
            assert old["pos"].ndim == 0  # the input is untouched
            assert all(new[k] is old[k] for k in old if k != "pos")
