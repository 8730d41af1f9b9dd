"""CPU parity of the port's k-way merge and median against the reference.

* The schedule builders (``loms_kway``, ``loms_median``, ``mwms_kway``,
  ``mwms_median``, ``loms_2way``, ``table1_stages``) equal
  ``repro.core``'s field by field.
* The torch ``apply_schedule`` / ``apply_schedule_with_payload`` equal
  ``repro.core``'s bit for bit, truncated or not.
* Kernel row 8: ``kway_merge_plain`` (what the CPU runs, and what the CUDA
  kernel is held against on the card) equals ``kway_merge_pallas`` in
  interpret mode (``use_mxu=False``): values, int32 perm and payload
  lanes (one with a feature dim), float32 / bfloat16 / int32 rows with
  NaN, ±inf, ±0.0 and heavy ties, both orders, ``n_stages=2``.
* ``repro_torch.merge_k`` equals the reference's fused rung
  (``fused_merge_k`` with ``fused_cfg_for(SortSpec(op="merge_k", ...,
  device="tpu"))``): the route the reference takes on its accelerator.
  On the CPU ``repro.merge_k`` takes the schedule executor, so the
  schedule routes (``stable``, ``mwms``, ``tree``) are held against it.
  ``median_of_lists`` equals ``repro.median_of_lists``; ``chunked_merge_k``
  equals ``repro.streaming.chunked_merge_k(tile=16, interpret=True)``;
  ``plan`` decides as ``repro.plan`` on the ``merge_k`` and ``median``
  rows.
* Gradients of ``merge_k`` (fused, with and without a payload leaf, and
  the schedule route) and ``median_of_lists`` equal ``jax.grad``.

Tolerance: bit-equal everywhere (values compared as their bits); the
gradients float32 with ``rtol=0`` and ``atol=0`` (scatters of the
cotangent are exact). The reference is pointed at an empty autotune
cache, so every call plans the heuristic route the port plans. The
reference's library calls and gradients run under one ``jax.jit`` each:
one compile of the whole network where eager dispatch compiles op after
op; the compares and selects give the same bits.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.api import fused as jfused
from repro.api.spec import SortSpec as JSpec
from repro.core import loms as jloms
from repro.core import mwms as jmwms
from repro.core import networks as jnet
from repro.kernels.kway import kway_merge_pallas
from repro.streaming import chunked_merge_k as jchunked_merge_k

import repro_torch
from repro_torch.api import SortSpec, plan
from repro_torch.core import loms as tloms
from repro_torch.core import mwms as tmwms
from repro_torch.core import networks as tnet
from repro_torch.kernels.common import encode_key_values
from repro_torch.kernels.kway import kway_merge_plain
from repro_torch.networks import kway_schedule

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


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _both(x, dtype):
    """The same bits as a jax array and a torch tensor."""
    a = jnp.asarray(x).astype(_JDT[dtype])
    if dtype == "bfloat16":
        return a, torch.from_numpy(np.asarray(a.view(jnp.int16)).copy()).view(torch.bfloat16)
    return a, torch.from_numpy(np.asarray(a).copy())


def _sorted_lists(rng, rows, lens, dtype, descending=False):
    """Each list sorted in the total order of its keys (NaN last, -0.0
    first), reversed when descending: (jax lists, torch lists)."""
    js, ts = [], []
    for n in lens:
        _, t = _both(_values(rng, (rows, n), dtype), dtype)
        keys = encode_key_values(t) if t.dtype.is_floating_point else t
        order = torch.argsort(keys, dim=-1, stable=True)
        if descending:
            order = order.flip(-1)
        bits = t.view(torch.int16) if dtype == "bfloat16" else t
        t = torch.gather(bits, 1, order)
        t = t.view(torch.bfloat16) if dtype == "bfloat16" else t
        js.append(_to_jax(t))
        ts.append(t)
    return js, ts


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


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def _fields(s):
    return (s.name, s.size, tuple(s.setup_scatter), tuple(s.output_gather),
            tuple(tuple((g.idx, g.runs) for g in st.groups) for st in s.stages), s.meta)


_KWAY_LENS = [(7, 7, 7), (3,) * 8, (64,) * 4, (100, 50, 25), (5,) * 5, (4, 6, 2),
              (1, 5, 3), (40, 30, 20)] + [(3,) * k for k in range(2, 9)]


@pytest.mark.parametrize("lens", _KWAY_LENS)
def test_kway_schedules_match_reference(lens):
    assert _fields(tloms.loms_kway(lens)) == _fields(jloms.loms_kway(lens))
    if len(lens) < 3 or np.prod([n + 1 for n in lens]) > 10_000:
        return  # the MWMS builder 0-1-validates every stage count it tries
    try:
        want = jmwms.mwms_kway(lens)
    except RuntimeError:  # no MWMS network of at most 12 stages
        with pytest.raises(RuntimeError, match="did not converge"):
            tmwms.mwms_kway(lens)
        return
    assert _fields(tmwms.mwms_kway(lens)) == _fields(want)
    (med_t, pos_t), (med_j, pos_j) = tmwms.mwms_median(lens), jmwms.mwms_median(lens)
    assert pos_t == pos_j and _fields(med_t) == _fields(med_j)


@pytest.mark.parametrize("lens", [(3, 3, 3), (7, 7, 7), (5,) * 5, (9,) * 7])
def test_median_schedules_match_reference(lens):
    (st, pt), (sj, pj) = tloms.loms_median(lens), jloms.loms_median(lens)
    assert pt == pj and _fields(st) == _fields(sj)


def test_2way_schedules_and_table1_match_reference():
    for m, n, c in ((7, 7, 2), (32, 32, 4), (12, 20, 4), (5, 3, 2), (64, 16, 8)):
        assert _fields(tloms.loms_2way(m, n, c)) == _fields(jloms.loms_2way(m, n, c))
    for k in range(2, 15):
        assert tloms.table1_stages(k) == jloms.table1_stages(k)
    with pytest.raises(ValueError):
        tloms.table1_stages(15)
    s = tloms.loms_kway((7, 7, 7))
    assert (tnet.depth(s), tnet.comparator_count(s)) == (
        jnet.depth(jloms.loms_kway((7, 7, 7))), jnet.comparator_count(jloms.loms_kway((7, 7, 7))))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_apply_schedule_matches_reference(dtype):
    rng = np.random.default_rng(3)
    run = jax.jit(jnet.apply_schedule, static_argnums=(0, 2))
    run_p = jax.jit(jnet.apply_schedule_with_payload, static_argnums=(0, 3))
    for lens in ((7, 7, 7), (4, 6, 2)):
        ts, js = tloms.loms_kway(lens), jloms.loms_kway(lens)
        x = np.concatenate([np.sort(rng.integers(-3, 4, (4, n)), -1) for n in lens], -1)
        x = x.astype(np.float32) * 0.5 if dtype == "float32" else x.astype(np.int32)
        p = rng.permutation(x.shape[-1] * 4).reshape(4, -1).astype(np.int32)
        for n_stages in ((None, 2) if lens == (7, 7, 7) else (None,)):
            _assert_same((run(js, jnp.asarray(x), n_stages),),
                         (tnet.apply_schedule(ts, torch.from_numpy(x), n_stages),))
            want = run_p(js, jnp.asarray(x), jnp.asarray(p), n_stages)
            got = tnet.apply_schedule_with_payload(ts, torch.from_numpy(x),
                                                   torch.from_numpy(p), n_stages)
            _assert_same(want, got)


# ---------------------------------------------------------------------------
# kernel row 8: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

# (lens, dtype, descending, n_stages, payload lanes)
_KERNEL_CASES = [
    ((7, 7, 7), "float32", False, None, True),
    ((7, 7, 7), "float32", True, None, True),
    ((7, 7, 7), "int32", True, None, True),
    ((64,) * 4, "bfloat16", True, None, True),
    ((100, 50, 25), "float32", False, None, True),
    ((3,) * 8, "bfloat16", True, 2, True),
]


@pytest.fixture(scope="module")
def kernel_results():
    """Both kernels' outputs on every case, the reference's computed once."""
    out = []
    for i, (lens, dtype, desc, n_stages, pay) in enumerate(_KERNEL_CASES):
        rng = np.random.default_rng(i)
        rows, total = 6, sum(lens)
        js, ts = _sorted_lists(rng, rows, lens, dtype, desc)
        ids = np.arange(rows * total * 3, dtype=np.int32).reshape(rows, total, 3)
        lanes = ([_both(ids, "int32"), _both(_values(rng, (rows, total), "float32"),
                                             "bfloat16")] if pay else [])
        key = dtype if dtype != "int32" else None
        sched = repro.networks.kway_schedule(lens)
        want = jax.jit(lambda x, lv, sched=sched, n_stages=n_stages, lens=lens, key=key,
                       desc=desc: kway_merge_pallas(
            x, sched, lv, n_stages=n_stages, block_batch=8, use_mxu=False,
            interpret=True, lens=lens, key_dtype=key, descending=desc, want_perm=True))(
            jnp.concatenate(js, -1), tuple(p[0] for p in lanes))
        got = kway_merge_plain(
            torch.cat(ts, -1), kway_schedule(lens), tuple(p[1] for p in lanes),
            n_stages=n_stages, lens=lens, key_dtype=_TDT[dtype] if key else None,
            descending=desc, want_perm=True)
        out.append((want, got))
    return out


@pytest.mark.parametrize("case", range(len(_KERNEL_CASES)))
def test_kway_plain_matches_pallas(kernel_results, case):
    want, got = kernel_results[case]
    _assert_same((want[0], want[1]) + tuple(want[2]), (got[0], got[1]) + tuple(got[2]))


def test_kway_plain_values_only_and_checks():
    rng = np.random.default_rng(5)
    _, ts = _sorted_lists(rng, 3, (7, 7, 7), "int32")
    out, perm, pouts = kway_merge_plain(torch.cat(ts, -1), kway_schedule((7, 7, 7)))
    assert perm is None and pouts == ()
    assert torch.equal(out, torch.sort(torch.cat(ts, -1), -1)[0])
    from repro_torch.kernels import ops
    from repro_torch.kernels.kway import kway_merge

    assert torch.equal(ops.merge_k(ts), out)
    assert torch.equal(ops.median_k(ts), out[:, 10])

    x = torch.cat(ts, -1).float()
    with pytest.raises(NotImplementedError, match="key_dtype"):
        kway_merge(x, kway_schedule((7, 7, 7)))
    with pytest.raises(ValueError, match="lens"):
        kway_merge(torch.cat(ts, -1), kway_schedule((7, 7, 7)), descending=True)


# ---------------------------------------------------------------------------
# the library calls against the reference
# ---------------------------------------------------------------------------


def _jcfg(lens, batch, dtype, descending, has_payload=False):
    spec = JSpec(op="merge_k", lengths=lens, batch=batch, dtype=dtype,
                 descending=descending, has_payload=has_payload, device="tpu")
    cfg = jfused.fused_cfg_for(spec, batch, _JDT[dtype])
    assert cfg is not None
    return cfg


@pytest.mark.parametrize("lens,dtype,desc", [((7, 7, 7), "float32", False),
                                             ((64,) * 4, "bfloat16", True),
                                             ((3,) * 8, "int32", True)])
def test_merge_k_matches_fused_reference(lens, dtype, desc):
    rng = np.random.default_rng(sum(lens))
    rows, total = 5, sum(lens)
    js, ts = _sorted_lists(rng, rows, lens, dtype, desc)
    cfg = _jcfg(lens, rows, dtype, desc)
    want, _ = jax.jit(lambda ls: jfused.fused_merge_k(cfg, ls, ()))(tuple(js))
    _assert_same((want,), (repro_torch.merge_k(ts, descending=desc),))
    # a payload tree: int32 ids with a feature dim, float32 rows
    ids = np.arange(rows * total * 2, dtype=np.int32).reshape(rows, total, 2)
    emb = rng.standard_normal((rows, total)).astype(np.float32)
    offs = np.cumsum((0,) + lens)
    ttrees = [{"id": torch.from_numpy(ids[:, a:b].copy()),
               "emb": torch.from_numpy(emb[:, a:b].copy())}
              for a, b in zip(offs[:-1], offs[1:])]
    lanes = (jnp.asarray(emb), jnp.asarray(ids))  # the tree's leaves, keys sorted
    cfg = _jcfg(lens, rows, dtype, desc, has_payload=True)
    want_v, (w_emb, w_id) = jax.jit(lambda ls, lv: jfused.fused_merge_k(cfg, ls, lv))(
        tuple(js), lanes)
    got_v, tree = repro_torch.merge_k(ts, descending=desc, payload=ttrees)
    _assert_same((want_v, w_id, w_emb), (got_v, tree["id"], tree["emb"]))


def test_merge_k_along_axis_0_and_port_config():
    rng = np.random.default_rng(8)
    js, ts = _sorted_lists(rng, 6, (7, 7, 7), "float32")
    want, _ = jfused.fused_merge_k(_jcfg((7, 7, 7), 6, "float32", False), tuple(js), ())
    got = repro_torch.merge_k([t.T.reshape(7, 2, 3) for t in ts], axis=0)
    assert got.shape == (21, 2, 3)
    _assert_same((want,), (got.reshape(21, 6).T,))
    from repro_torch.api.fused import fused_cfg_for

    tc = fused_cfg_for(SortSpec(op="merge_k", lengths=(7, 7, 7), batch=6), 6, torch.float32)
    jc = _jcfg((7, 7, 7), 6, "float32", False)
    assert (tc.op, tc.lens, tc.n_cols, tc.network, str(tc.key_dtype)) == (
        jc.op, jc.lens, jc.n_cols, jc.network, f"torch.{jc.key_dtype}")


def test_merge_k_schedule_routes_match_reference():
    """``stable=True`` (the executor with positions, then the tie pass) and
    the mwms network with payloads riding along; the tree of 2-way merges
    values only."""
    rng = np.random.default_rng(11)
    lens = (7, 7, 7)
    js, ts = _sorted_lists(rng, 3, lens, "float32", descending=True)
    pos = [np.full((3, n), j, dtype=np.int32) for j, n in enumerate(lens)]
    for kw in (dict(stable=True), dict(network="mwms")):
        want = jax.jit(lambda ls, ps, kw=kw: repro.merge_k(ls, descending=True, payload=ps,
                                                           **kw))(js, [jnp.asarray(p)
                                                                       for p in pos])
        got = repro_torch.merge_k(ts, descending=True,
                                  payload=[torch.from_numpy(p) for p in pos], **kw)
        _assert_same(want, got)
    _assert_same((jax.jit(lambda ls: repro.merge_k(ls, descending=True, network="tree"))(
        js),),
                 (repro_torch.merge_k(ts, descending=True, network="tree"),))


def test_merge_k_past_the_budget_streams_like_the_reference():
    """3 x 500 is past the k-way budget (total 1500 > 1448): both stream,
    on the keys, and backward is the gradient of a value sort (one stable
    argsort of the raw keys, reversed when descending)."""
    rng = np.random.default_rng(12)
    assert plan(SortSpec(op="merge_k", lengths=(500,) * 3)).backend == "streaming"
    w = rng.standard_normal((2, 1500)).astype(np.float32)
    for desc in (True,):  # ascending is the same path without the reversals
        ls = [np.sort((rng.integers(-8, 9, (2, 500)) * 0.5).astype(np.float32), -1)
              for _ in range(3)]  # ties
        ls = [l[:, ::-1].copy() if desc else l for l in ls]
        g = jax.jit(jax.grad(lambda *v: jnp.sum(repro.merge_k(v, descending=desc) * w),
                             argnums=(0, 1, 2)))(*map(jnp.asarray, ls))
        tl = [torch.from_numpy(l).requires_grad_() for l in ls]
        got = repro_torch.merge_k(tl, descending=desc)
        (got * torch.from_numpy(w)).sum().backward()
        _assert_same((jax.jit(lambda v: repro.merge_k(v, descending=desc))(
            [jnp.asarray(l) for l in ls]),), (got,))
        for a, b in zip(tl, g):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=0)


@pytest.mark.parametrize("lens,dtype,network", [((7, 7, 7), "float32", "loms"),
                                                ((5,) * 5, "bfloat16", "loms"),
                                                ((7, 7, 7), "int32", "mwms"),
                                                ((3, 5, 7), "float32", "loms")])
def test_median_of_lists_matches_reference(lens, dtype, network):
    rng = np.random.default_rng(len(lens))
    js, ts = _sorted_lists(rng, 6, lens, dtype)
    want = jax.jit(lambda ls: repro.median_of_lists(ls, network=network))(js)
    if len(set(lens)) > 1:  # the lax rung: the middle of a sort, as the reference's ladder
        _assert_same((want,), (repro_torch.median_of_lists(ts, network=network),))
        return
    got = repro_torch.median_of_lists(ts, network=network)
    assert got.shape == (6,)
    _assert_same((want,), (got,))
    # along axis 0 of a 3-D stack of lists
    got3 = repro_torch.median_of_lists([t.T.reshape(lens[0], 2, 3) for t in ts], axis=0,
                                       network=network)
    _assert_same((want,), (got3.reshape(6),))


def test_chunked_merge_k_matches_reference():
    rng = np.random.default_rng(13)
    lens = (100, 37, 120)
    js, ts = _sorted_lists(rng, 2, lens, "int32")
    want = jax.jit(lambda ls: jchunked_merge_k(ls, tile=16, interpret=True))(js)
    _assert_same((want,), (repro_torch.chunked_merge_k(ts, tile=16),))
    # one list row, no batch axis, the planner's tile
    _assert_same((np.sort(np.concatenate([np.asarray(j[0]) for j in js])),),
                 (repro_torch.chunked_merge_k([t[0] for t in ts]),))


_TABLE = [
    ("merge_k", (7, 7, 7), {}), ("merge_k", (64,) * 4, {"has_payload": True}),
    ("merge_k", (500,) * 3, {}), ("merge_k", (500,) * 3, {"has_payload": True}),
    ("merge_k", (7, 7, 7), {"stable": True}), ("merge_k", (7, 7, 7), {"network": "mwms"}),
    ("merge_k", (181,) * 8, {}), ("median", (7, 7, 7), {}), ("median", (5,) * 5, {}),
    ("median", (3, 5, 7), {}), ("median", (7, 7, 7), {"network": "mwms"}),
    ("median", (4, 4, 4), {}),
]


@pytest.mark.parametrize("op,lens,kw", _TABLE)
def test_plan_matches_reference_on_the_accelerator(op, lens, kw):
    for dtype in ("float32", "int32"):
        want = repro.plan(JSpec(op=op, lengths=lens, dtype=dtype, device="tpu", **kw))
        got = plan(SortSpec(op=op, lengths=lens, dtype=dtype, **kw))
        assert (got.backend, got.detail) == (
            "cuda" if want.backend == "pallas" else want.backend, want.detail)
        cpu = plan(SortSpec(op=op, lengths=lens, dtype=dtype, device="cpu", **kw))
        want_cpu = repro.plan(JSpec(op=op, lengths=lens, dtype=dtype, device="cpu", **kw))
        assert (cpu.backend, cpu.detail) == (want_cpu.backend, want_cpu.detail)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_merge_k_and_median_gradients_match_jax():
    rng = np.random.default_rng(14)
    lens = (7, 7, 7)
    x = (rng.integers(-3, 4, (3, 21)) * 0.5).astype(np.float32)  # ties
    w = rng.standard_normal((3, 21)).astype(np.float32)
    emb = rng.standard_normal((3, 21, 2)).astype(np.float32)
    we = rng.standard_normal((3, 21, 2)).astype(np.float32)
    for desc in (True,):  # ascending is the same path without the reversals
        ls = [np.sort(x[:, 7 * j:7 * j + 7], -1) for j in range(3)]
        ls = [l[:, ::-1].copy() if desc else l for l in ls]
        tw, twe = torch.from_numpy(w), torch.from_numpy(we)
        # values only (one stable argsort of the keys), with a payload leaf
        # (the kernel's permutation), and on the schedule route (stable=True)
        cfg = _jcfg(lens, 3, "float32", desc)
        g = jax.jit(jax.grad(lambda *v: jnp.sum(jfused.fused_merge_k(cfg, v, ())[0] * w),
                             argnums=(0, 1, 2)))(*map(jnp.asarray, ls))
        tl = [torch.from_numpy(l).requires_grad_() for l in ls]
        (repro_torch.merge_k(tl, descending=desc) * tw).sum().backward()
        for a, b in zip(tl, g):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=0)
        cfg = _jcfg(lens, 3, "float32", desc, has_payload=True)

        def jloss(e, *v):
            out, (pe,) = jfused.fused_merge_k(cfg, v, (e,))
            return jnp.sum(out * w) + jnp.sum(pe * we)

        g = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(jnp.asarray(emb),
                                                           *map(jnp.asarray, ls))
        tl = [torch.from_numpy(l).requires_grad_() for l in ls]
        te = torch.from_numpy(emb).requires_grad_()
        pays = [te[:, 7 * j:7 * j + 7] for j in range(3)]
        out, pe = repro_torch.merge_k(tl, descending=desc, payload=pays)
        ((out * tw).sum() + (pe * twe).sum()).backward()
        for a, b in zip([te] + tl, g):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=0)
        g = jax.jit(jax.grad(
            lambda *v: jnp.sum(repro.merge_k(v, descending=desc, stable=True) * w),
            argnums=(0, 1, 2)))(*map(jnp.asarray, ls))
        tl = [torch.from_numpy(l).requires_grad_() for l in ls]
        (repro_torch.merge_k(tl, descending=desc, stable=True) * tw).sum().backward()
        for a, b in zip(tl, g):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=0)
    # the median: the cotangent goes to the input that held it
    ls = [np.sort(x[:, 7 * j:7 * j + 7], -1) for j in range(3)]
    wm = rng.standard_normal(3).astype(np.float32)
    g = jax.jit(jax.grad(lambda *v: jnp.sum(repro.median_of_lists(v) * wm),
                         argnums=(0, 1, 2)))(*map(jnp.asarray, ls))
    tl = [torch.from_numpy(l).requires_grad_() for l in ls]
    (repro_torch.median_of_lists(tl) * torch.from_numpy(wm)).sum().backward()
    for a, b in zip(tl, g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=0)
