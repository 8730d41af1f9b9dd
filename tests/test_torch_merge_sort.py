"""CPU parity of the port's library ``merge`` and ``sort`` against the
reference.

* Kernel row 1: ``loms_merge2_plain`` (what the CPU runs, and what the
  CUDA kernel is held against on the card) equals ``loms_merge2_pallas``
  in interpret mode: values, int32 perm and payload lanes (one with a
  feature dim), every capable family, both orders, float32 / bfloat16 /
  int32 rows with NaN, ±inf, ±0.0 and heavy ties.
* Kernel row 2: ``loms_sort_plain`` equals ``loms_sort_pallas`` in
  interpret mode the same way, pow2 and padded rows.
* ``repro_torch.merge`` / ``sort`` equal the reference's fused rungs
  (``fused_merge_k`` / ``fused_sort`` with ``fused_cfg_for(SortSpec(...,
  device="tpu"))``): the route the reference takes on its accelerator;
  on the CPU ``repro.merge`` / ``sort`` take the schedule executor, whose
  tie order differs. A merge past the routing budget equals
  ``repro.merge`` (which streams on any device).
* Gradients of the fused sort and merge equal ``jax.grad`` of the same
  reference functions.
* ``plan()`` decides as ``repro.plan(SortSpec(device="tpu"))`` on the
  decision table's shapes; ``chunked_merge(mode="loop")`` equals the
  reference's loop.

Tolerance: bit-equal everywhere (values compared as their bits), except
the gradients: float32, ``rtol=0`` and ``atol=0`` (a scatter of the
cotangent is exact). The reference reads an autotune cache; it is pointed
at an empty one, so every call plans the heuristic loms family, as the
port does. The reference's library calls and gradients run under one
``jax.jit`` each: one compile of the whole network where eager dispatch
compiles op after op; the compares and selects give the same bits.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api import fused as jfused
from repro.api.spec import SortSpec as JSpec
from repro.kernels.loms_merge import loms_merge2_pallas
from repro.kernels.sort import loms_sort_pallas

import repro_torch
from repro_torch.api import SortSpec, plan
from repro_torch.api.fused import fused_cfg_for
from repro_torch.kernels.common import encode_key_values
from repro_torch.kernels.loms_merge import loms_merge2_plain
from repro_torch.kernels.sort import loms_sort_plain
from repro_torch.networks import capable_families, pick_merge_cols

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


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


def _values(rng, shape, dtype):
    """Heavy ties; floats also NaN, ±inf and ±0.0, int32 its extremes."""
    if dtype == "int32":
        x = rng.integers(-3, 4, shape).astype(np.int32)
        x[rng.random(shape) < 0.05] = np.iinfo(np.int32).max
        x[rng.random(shape) < 0.05] = np.iinfo(np.int32).min
        return x
    x = (rng.integers(-3, 4, shape) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random(shape) < frac] = val
    return x


def _jit(fn, *args, **static):
    """The reference's call ``fn(*args, **static)`` under one ``jax.jit``;
    a leading non-array argument (a fused config) is static."""
    if args and not isinstance(args[0], (jax.Array, tuple, list)):
        return jax.jit(functools.partial(fn, args[0], **static))(*args[1:])
    return jax.jit(functools.partial(fn, **static))(*args)


def _both(x, dtype):
    """The same bits as a jax array and a torch tensor."""
    a = jnp.asarray(x).astype(_JDT[dtype])
    if dtype == "bfloat16":
        return a, torch.from_numpy(np.asarray(a.view(jnp.int16)).copy()).view(torch.bfloat16)
    return a, torch.from_numpy(np.asarray(a).copy())


def _sorted(rng, shape, dtype, descending=False):
    """Rows sorted in the total order of the keys (NaN last, -0.0 first)."""
    _, t = _both(_values(rng, shape, dtype), dtype)
    keys = encode_key_values(t) if t.dtype.is_floating_point else t
    order = torch.argsort(keys, dim=-1, stable=True)
    if descending:
        order = order.flip(-1)
    t = torch.gather(t.view(torch.int16) if dtype == "bfloat16" else t, 1, order)
    t = t.view(torch.bfloat16) if dtype == "bfloat16" else t
    return _to_jax(t), t


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _payloads(rng, rows, lanes):
    """An int32 lane with a feature dim and a bf16 lane with NaN and -0.0."""
    ids = np.arange(rows * lanes * 3, dtype=np.int32).reshape(rows, lanes, 3)
    return [_both(ids, "int32"), _both(_values(rng, (rows, lanes), "float32"), "bfloat16")]


# ---------------------------------------------------------------------------
# kernel rows 1 and 2: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

_MERGE_CASES = [(m, n, fam) for m, n in ((8, 8), (16, 48), (12, 20))
                for fam in capable_families("merge2", (m, n))]


@pytest.mark.parametrize("m,n,family", _MERGE_CASES)
def test_loms_merge2_plain_matches_pallas(m, n, family):
    rng = np.random.default_rng(m * 100 + n)
    rows = 5
    n_cols = pick_merge_cols(m, n)
    dtypes = ("float32", "int32", "bfloat16") if family == "loms" else ("float32", "int32")
    for dtype in dtypes:
        for desc in (False, True):
            ja, ta = _sorted(rng, (rows, m), dtype, desc)
            jb, tb = _sorted(rng, (rows, n), dtype, desc)
            pays = _payloads(rng, rows, m + n)
            key = dtype if dtype != "int32" else None
            want = _jit(loms_merge2_pallas,
                        ja, jb, tuple(p[0] for p in pays), network=family, n_cols=n_cols,
                        block_batch=8, use_mxu=False, interpret=True, key_dtype=key,
                        descending=desc, want_perm=True)
            got = loms_merge2_plain(
                ta, tb, tuple(p[1] for p in pays), network=family, n_cols=n_cols,
                key_dtype=_TDT[dtype] if key else None, descending=desc, want_perm=True)
            _assert_same((want[0], want[1]) + tuple(want[2]),
                         (got[0], got[1]) + tuple(got[2]))
    # values only: no position lane in the reference
    want = _jit(loms_merge2_pallas, ja, jb, network=family, n_cols=n_cols, block_batch=8,
                use_mxu=False, interpret=True, key_dtype=key, descending=desc)
    got = loms_merge2_plain(ta, tb, network=family, n_cols=n_cols,
                            key_dtype=_TDT[dtype] if key else None, descending=desc)
    assert got[1] is None and got[2] == ()
    _assert_same((want,), (got[0],))


_SORT_CASES = ([(37, fam, ("float32",) if fam == "periodic3" else ("float32", "int32"))
                for fam in capable_families("sort", (37,))]
               + [(16, "bitonic", ("float32",)), (128, "loms", ("bfloat16", "float32"))])


@pytest.mark.parametrize("n,family,dtypes", _SORT_CASES)
def test_loms_sort_plain_matches_pallas(n, family, dtypes):
    rng = np.random.default_rng(n)
    rows = 6
    for dtype in dtypes:
        for desc in (False, True):
            jx, tx = _both(_values(rng, (rows, n), dtype), dtype)
            pays = _payloads(rng, rows, n)
            key = dtype if dtype != "int32" else None
            want = _jit(loms_sort_pallas, jx, tuple(p[0] for p in pays), network=family,
                        block_batch=8, use_mxu=False, interpret=True,
                        key_dtype=key, descending=desc, want_perm=True)
            got = loms_sort_plain(tx, tuple(p[1] for p in pays), network=family,
                                  key_dtype=_TDT[dtype] if key else None,
                                  descending=desc, want_perm=True)
            _assert_same((want[0], want[1]) + tuple(want[2]),
                         (got[0], got[1]) + tuple(got[2]))


# ---------------------------------------------------------------------------
# the library calls against the reference's fused rungs
# ---------------------------------------------------------------------------


def _jcfg(op, lens, batch, dtype, descending, has_payload=False):
    spec = JSpec(op=op, lengths=lens, batch=batch, dtype=dtype, descending=descending,
                 has_payload=has_payload, device="tpu")
    cfg = jfused.fused_cfg_for(spec, batch, _JDT[dtype])
    assert cfg is not None
    return cfg


@pytest.mark.parametrize("dtype,desc,m,n", [("float32", False, 32, 32),
                                            ("bfloat16", True, 64, 192),
                                            ("int32", True, 24, 40)])
def test_merge_matches_fused_reference(dtype, desc, m, n):
    rng = np.random.default_rng(7)
    rows = 6
    ja, ta = _sorted(rng, (rows, m), dtype, desc)
    jb, tb = _sorted(rng, (rows, n), dtype, desc)
    cfg = _jcfg("merge", (m, n), rows, dtype, desc)
    want, _ = _jit(jfused.fused_merge_k, cfg, (ja, jb), ())
    _assert_same((want,), (repro_torch.merge(ta, tb, descending=desc),))
    # a payload tree: int32 ids and float32 rows of a feature dim
    ids = np.arange(rows * (m + n), dtype=np.int32).reshape(rows, m + n)
    emb = rng.standard_normal((rows, m + n, 2)).astype(np.float32)
    jtrees = [{"id": jnp.asarray(ids[:, :m]), "emb": jnp.asarray(emb[:, :m])},
              {"id": jnp.asarray(ids[:, m:]), "emb": jnp.asarray(emb[:, m:])}]
    ttrees = [{"id": torch.from_numpy(ids[:, :m].copy()),
               "emb": torch.from_numpy(emb[:, :m].copy())},
              {"id": torch.from_numpy(ids[:, m:].copy()),
               "emb": torch.from_numpy(emb[:, m:].copy())}]
    cfg = _jcfg("merge", (m, n), rows, dtype, desc, has_payload=True)
    lanes = (jnp.asarray(emb), jnp.asarray(ids))  # the tree's leaves, keys sorted
    want_v, (w_emb, w_id) = _jit(jfused.fused_merge_k, cfg, (ja, jb), lanes)
    got_v, got_tree = repro_torch.merge(ta, tb, descending=desc, payload=ttrees)
    _assert_same((want_v, w_id, w_emb), (got_v, got_tree["id"], got_tree["emb"]))


def test_merge_along_axis_0_and_port_config():
    """``axis=0`` of a 3-D pair, and the port's fused config equals the
    reference's (family, column count, lengths, key type)."""
    rng = np.random.default_rng(3)
    ja, ta = _sorted(rng, (12, 16), "float32")
    jb, tb = _sorted(rng, (12, 48), "float32")
    want, _ = jfused.fused_merge_k(_jcfg("merge", (16, 48), 12, "float32", False),
                                   (ja, jb), ())
    a3 = ta.reshape(3, 4, 16).permute(2, 0, 1)  # (16, 3, 4), sorted along axis 0
    b3 = tb.reshape(3, 4, 48).permute(2, 0, 1)
    got = repro_torch.merge(a3, b3, axis=0)
    assert got.shape == (64, 3, 4)
    _assert_same((want,), (got.permute(1, 2, 0).reshape(12, 64),))
    for op, lens, batch, dtype in (("merge", (16, 48), 12, "float32"),
                                   ("merge", (512, 512), 4096, "bfloat16"),
                                   ("sort", (1007,), 16, "float32"),
                                   ("sort", (1024,), 16384, "bfloat16")):
        jc = _jcfg(op, lens, batch, dtype, False)
        tc = fused_cfg_for(SortSpec(op=op, lengths=lens, batch=batch, dtype=dtype),
                           batch, _TDT[dtype])
        assert (tc.network, tc.n_cols, tc.lens, str(tc.key_dtype)) == (
            jc.network, jc.n_cols, jc.lens, f"torch.{jc.key_dtype}")


@pytest.mark.parametrize("dtype,desc,n", [("float32", True, 1007), ("bfloat16", False, 64),
                                          ("int32", True, 48)])
def test_sort_matches_fused_reference(dtype, desc, n):
    rng = np.random.default_rng(n)
    rows = 4
    jx, tx = _both(_values(rng, (rows, n), dtype), dtype)
    cfg = _jcfg("sort", (n,), rows, dtype, desc)
    want, _ = _jit(jfused.fused_sort, cfg, jx, ())
    _assert_same((want,), (repro_torch.sort(tx, descending=desc),))
    pay = np.arange(rows * n * 2, dtype=np.int32).reshape(rows, n, 2)
    cfg = _jcfg("sort", (n,), rows, dtype, desc, has_payload=True)
    want_v, (want_p,) = _jit(jfused.fused_sort, cfg, jx, (jnp.asarray(pay),))
    got_v, got_p = repro_torch.sort(tx, descending=desc, payload=torch.from_numpy(pay))
    _assert_same((want_v, want_p), (got_v, got_p))
    # axis 0 of the transpose is the same sort
    _assert_same((want_v,), (repro_torch.sort(tx.T.contiguous(), axis=0,
                                              descending=desc).T,))


def test_merge_past_the_budget_streams_like_the_reference():
    """3000 + 3000 float32 is past the routing budget: both stream (the
    grid merge, rows 9), on the keys, in both orders."""
    rng = np.random.default_rng(5)
    for desc in (False, True):
        ja, ta = _sorted(rng, (2, 3000), "float32", desc)
        jb, tb = _sorted(rng, (2, 3000), "float32", desc)
        spec = SortSpec(op="merge", lengths=(3000, 3000), batch=2)
        assert plan(spec).backend == "streaming"
        want = jax.jit(lambda p, q: repro.merge(p, q, descending=desc))(ja, jb)
        _assert_same((want,), (repro_torch.merge(ta, tb, descending=desc),))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_sort_and_merge_gradients_match_jax():
    rng = np.random.default_rng(9)
    x = (rng.integers(-4, 5, (3, 40)) * 0.5).astype(np.float32)  # ties
    w = rng.standard_normal((3, 40)).astype(np.float32)
    emb = rng.standard_normal((3, 40, 2)).astype(np.float32)
    we = rng.standard_normal((3, 40, 2)).astype(np.float32)
    for desc in (False, True):
        cfg = _jcfg("sort", (40,), 3, "float32", desc)
        gj = jax.jit(jax.grad(lambda v: jnp.sum(jfused.fused_sort(cfg, v, ())[0] * w)))(
            jnp.asarray(x))
        tx = torch.from_numpy(x.copy()).requires_grad_()
        (repro_torch.sort(tx, descending=desc) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj), rtol=0, atol=0)
        # with a payload leaf: the kernel's own permutation
        cfg = _jcfg("sort", (40,), 3, "float32", desc, has_payload=True)

        def jloss(v, e):
            out, (pe,) = jfused.fused_sort(cfg, v, (e,))
            return jnp.sum(out * w) + jnp.sum(pe * we)

        gv, ge = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(emb))
        tx = torch.from_numpy(x.copy()).requires_grad_()
        te = torch.from_numpy(emb.copy()).requires_grad_()
        out, pe = repro_torch.sort(tx, descending=desc, payload=te)
        ((out * torch.from_numpy(w)).sum() + (pe * torch.from_numpy(we)).sum()).backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gv), rtol=0, atol=0)
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), rtol=0, atol=0)
    # merge, values only: one stable argsort of the keys in backward
    a = np.sort(x[:, :16], -1)
    b = np.sort(x[:, 16:], -1)
    wm = rng.standard_normal((3, 40)).astype(np.float32)
    for desc in (False, True):
        aa, bb = (a[:, ::-1].copy(), b[:, ::-1].copy()) if desc else (a, b)
        cfg = _jcfg("merge", (16, 24), 3, "float32", desc)
        ga, gb = jax.jit(jax.grad(lambda p, q: jnp.sum(
            jfused.fused_merge_k(cfg, (p, q), ())[0] * wm), argnums=(0, 1)))(
            jnp.asarray(aa), jnp.asarray(bb))
        ta = torch.from_numpy(aa).requires_grad_()
        tb = torch.from_numpy(bb).requires_grad_()
        (repro_torch.merge(ta, tb, descending=desc) * torch.from_numpy(wm)).sum().backward()
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=0, atol=0)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

_TABLE = [
    ("topk", (151_936,), {"k": 64}), ("topk", (256,), {"k": 8}),
    ("sort", (1024,), {}), ("sort", (2048,), {}), ("sort", (100,), {"stable": True}),
    ("sort", (64,), {"network": "bitonic"}),
    ("merge", (32, 32), {}), ("merge", (512, 512), {"has_payload": True}),
    ("merge", (65_536, 32), {}), ("merge", (4096, 4096), {}),
    ("merge", (4096, 4096), {"has_payload": True}), ("merge", (7, 5), {}),
    ("merge", (64, 64), {"stable": True}), ("merge", (64, 64), {"network": "bitonic"}),
    ("merge", (100_000, 100_000), {}), ("merge", (600_000, 2), {}),
]


@pytest.mark.parametrize("op,lens,kw", _TABLE)
def test_plan_matches_reference_on_the_accelerator(op, lens, kw):
    for dtype in ("float32", "bfloat16"):
        want = repro.plan(JSpec(op=op, lengths=lens, dtype=dtype, device="tpu", **kw))
        got = plan(SortSpec(op=op, lengths=lens, dtype=dtype, **kw))
        assert (got.backend, got.detail) == (
            "cuda" if want.backend == "pallas" else want.backend, want.detail)
        cpu = plan(SortSpec(op=op, lengths=lens, dtype=dtype, device="cpu", **kw))
        want_cpu = repro.plan(JSpec(op=op, lengths=lens, dtype=dtype, device="cpu", **kw))
        assert (cpu.backend, cpu.detail) == (want_cpu.backend, want_cpu.detail)


@pytest.mark.parametrize("switch", ["fused", "segmented"])
@pytest.mark.parametrize("op,lens,kw", _TABLE)
def test_plan_matches_reference_with_a_switch_off(op, lens, kw, switch):
    """The same rows with the fused or the segmented switch off in both
    packages (restored after)."""
    from repro.api.fused import set_fused_enabled as j_fused
    from repro.segmented import set_segmented_enabled as j_seg
    from repro_torch.api.fused import set_fused_enabled as t_fused
    from repro_torch.segmented import set_segmented_enabled as t_seg

    j_set, t_set = (j_fused, t_fused) if switch == "fused" else (j_seg, t_seg)
    prev = j_set(False), t_set(False)
    try:
        want = repro.plan(JSpec(op=op, lengths=lens, device="tpu", **kw))
        got = plan(SortSpec(op=op, lengths=lens, **kw))
    finally:
        j_set(prev[0])
        t_set(prev[1])
    assert (got.backend, got.detail) == (
        "cuda" if want.backend == "pallas" else want.backend, want.detail)


def test_chunked_merge_loop_matches_reference():
    """The one-launch-a-tile loop (``mode="loop"``, once refused) on
    batched rows with leading axes: the reference's loop in interpret
    mode, bit for bit, and the port's grid mode."""
    from repro.streaming import chunked_merge as j_chunked_merge

    rng = np.random.default_rng(12)
    a = np.sort(rng.standard_normal((2, 1, 40)).astype(np.float32), -1)
    b = np.sort(rng.standard_normal((2, 1, 24)).astype(np.float32), -1)
    want = j_chunked_merge(jnp.asarray(a), jnp.asarray(b), tile=16, mode="loop")
    got = repro_torch.chunked_merge(torch.from_numpy(a), torch.from_numpy(b), tile=16,
                                    mode="loop")
    assert got.shape == (2, 1, 64)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    grid = repro_torch.chunked_merge(torch.from_numpy(a), torch.from_numpy(b), tile=16)
    assert torch.equal(got.view(torch.int32), grid.view(torch.int32))
    with pytest.raises(ValueError, match="mode"):
        repro_torch.chunked_merge(torch.from_numpy(a), torch.from_numpy(b), mode="tiles")


def _jit_payload_merge(ja, jb, pa, pb):
    """The reference's payload merge on the schedule executor, jitted."""
    return jax.jit(lambda p, q, x, y: repro.merge(p, q, payload=(x, y), backend="schedule"))(
        ja, jb, jnp.asarray(pa), jnp.asarray(pb))


def _route_case(name, rng):
    """The inputs of one route the port used to refuse, and the
    reference's answer on its accelerator's route for them."""
    if name == "ragged":  # 7 + 5: no common column count, the executor
        ja, ta = _sorted(rng, (3, 7), "float32", False)
        jb, tb = _sorted(rng, (3, 5), "float32", False)
        pa, pb = (np.arange(3 * n, dtype=np.int32).reshape(3, n) for n in (7, 5))
        want = _jit_payload_merge(ja, jb, pa, pb)
        return want, repro_torch.merge(ta, tb, payload=(torch.from_numpy(pa),
                                                        torch.from_numpy(pb)))
    if name == "stable_merge":
        ja, ta = _sorted(rng, (4, 8), "float32", False)
        jb, tb = _sorted(rng, (4, 8), "float32", False)
        return (jax.jit(lambda p, q: repro.merge(p, q, stable=True, backend="schedule"))(
            ja, jb), repro_torch.merge(ta, tb, stable=True))
    if name == "stable_sort":
        jx, tx = _both(_values(rng, (4, 8), "float32"), "float32")
        pay = np.arange(32, dtype=np.int32).reshape(4, 8)
        return (jax.jit(lambda v, p: repro.sort(v, stable=True, payload=p,
                                                backend="schedule"))(jx, jnp.asarray(pay)),
                repro_torch.sort(tx, stable=True, payload=torch.from_numpy(pay)))
    if name == "sort_past_budget":  # npad > 2048: the executor's merge tree
        jx, tx = _both(_values(rng, (1, 2049), "int32"), "int32")
        return (jax.jit(lambda v: repro.sort(v, backend="schedule"))(jx),
                repro_torch.sort(tx))
    if name == "payload_merge_past_budget":
        ja, ta = _sorted(rng, (1, 4096), "float32", False)
        jb, tb = _sorted(rng, (1, 4096), "float32", False)
        pa, pb = (np.arange(4096, dtype=np.int32)[None] + off for off in (0, 4096))
        want = _jit_payload_merge(ja, jb, pa, pb)
        return want, repro_torch.merge(ta, tb, payload=(torch.from_numpy(pa),
                                                        torch.from_numpy(pb)))
    if name == "bitonic_sort":
        jx, tx = _both(_values(rng, (4, 8), "int32"), "int32")
        return (jax.jit(lambda v: repro.sort(v, network="bitonic", backend="schedule"))(jx),
                repro_torch.sort(tx, network="bitonic"))
    if name == "unsafe_sort":  # finite raw floats: the fused rung's raw-float mode
        x = (rng.integers(-3, 4, (4, 8)) * 0.5).astype(np.float32)
        x[rng.random((4, 8)) < 0.2] = -0.0
        jx, tx = _both(x, "float32")
        spec = JSpec(op="sort", lengths=(8,), batch=4, nan_policy="unsafe", device="tpu")
        cfg = jfused.fused_cfg_for(spec, 4, jnp.float32)
        want, _ = jax.jit(lambda v: jfused.fused_sort(cfg, v, ()))(jx)
        return want, repro_torch.sort(tx, nan_policy="unsafe")
    assert name == "uint32_sort"  # values only: unique, whatever the route
    u = rng.integers(0, 2 ** 32, (2, 4), dtype=np.uint64).astype(np.uint32)
    u[0, :2] = (0, 2 ** 32 - 1)
    return jax.jit(repro.sort)(jnp.asarray(u)), repro_torch.sort(torch.from_numpy(u))


@pytest.mark.parametrize("name", ["ragged", "stable_merge", "stable_sort",
                                  "sort_past_budget", "payload_merge_past_budget",
                                  "bitonic_sort", "unsafe_sort", "uint32_sort"])
def test_routes_the_port_used_to_refuse_match_reference(name):
    """Each route ``test_routes_the_port_lacks_raise`` used to pin as a
    refusal, held against the reference on the same input."""
    want, got = _route_case(name, np.random.default_rng(len(name)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    _assert_same(want, got)
