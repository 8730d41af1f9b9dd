"""CPU tests of MoE through the port's request scheduler, against the JAX
``ScheduledEngine`` (smoke qwen3-moe-30b-a3b in float32, the reference's
weights carried over with ``params_from_jax``).

A MoE request's tokens are those of the reference engine's batch
composition, not those of a solo ``generate``: expert capacity couples
the rows of a batch. So the scenario is built to exercise the batches:
five staggered greedy requests on 3 slots with pages of 8 and
``max_prefill_batch=2``. The three requests of tick 0 share bucket 8 and
are prefilled as two chunks (2 + 1); the two later ones wait for slots
and are prefilled together at bucket 16; the decode steps run three and
then two slots.

* The port's streams equal the reference engine's, token for token, and
  its ``sched.*`` counters (``sched.prefill_batches`` included) and
  ``sched.prefill`` spans' ``batch`` / ``bucket`` equal the reference's.
* deepseek-v2-lite-16b (a leading dense layer: a second cache group) is
  refused with the reference's message; without that layer its MLA
  stack (the latent leaves in the pool) equals ``generate`` on its batch.
* ``SchedulerConfig(max_prefill_batch=0)`` is refused, as in the reference.
* A dense stack prefills each request alone: its tokens are the same at
  ``max_prefill_batch`` 1 and 4.
"""
import collections
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import repro.obs as j_obs
from repro.configs import get_smoke_config as j_smoke
from repro.models import model_init as j_model_init
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro.serving.scheduler import ScheduledEngine as JScheduledEngine
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig

import repro_torch.obs as obs
from repro_torch.configs import get_smoke_config
from repro_torch.models import model_init, params_from_jax
from repro_torch.serving.scheduler import (RequestState, SamplingParams, ScheduledEngine,
                                           SchedulerConfig)

ARCH = "qwen3-moe-30b-a3b"
SCHED = dict(n_slots=3, page_size=8, pages_per_slot=3, max_prefill_batch=2)
LENS, ARRIVALS, NEW = (5, 7, 3, 12, 14), (0, 0, 0, 1, 2), 6


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_caches(tmp_path_factory):
    """Both planners off any cached tournament winner."""
    from repro.streaming.cache import AutotuneCache as JCache
    from repro.streaming.cache import set_default_cache as j_set_default
    from repro_torch.streaming.cache import AutotuneCache, set_default_cache

    path = str(tmp_path_factory.mktemp("autotune") / "autotune.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    prev, jprev = set_default_cache(AutotuneCache(path)), j_set_default(JCache(path))
    yield
    set_default_cache(prev)
    j_set_default(jprev)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-width tensors on one intra-op thread: the suite runs a worker
    a core, and a pool of threads a worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear(pkg):
    pkg.trace.clear()
    pkg.metrics.reset()
    pkg.recorder.clear()


def _series(snap):
    """{(metric, labels): value, or a histogram's count} of ``sched.*``."""
    out = {}
    for name, m in snap["metrics"].items():
        if name.startswith("sched."):
            for s in m["series"]:
                key = (name, tuple(sorted(s["labels"].items())))
                out[key] = s["count"] if m["kind"] == "histogram" else s["value"]
    return out


def _j_init(jcfg):
    """The reference's weights, drawn under one ``jax.jit`` (one compile
    where eager dispatch compiles op after op); the port gets the same
    weights through ``params_from_jax``."""
    return jax.jit(lambda key: j_model_init(key, jcfg)[0])(jax.random.PRNGKey(0))


def _prefill_spans(snap):
    return [(sp["attrs"]["batch"], sp["attrs"]["bucket"]) for sp in snap["spans"]
            if sp["name"] == "sched.prefill"]


@pytest.fixture(scope="module")
def drains():
    """Both engines' drains of the scenario with obs on in both packages:
    (reference tokens, port tokens, port engine, reference snapshot, port
    snapshot)."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jp = _j_init(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in LENS]
    prev, jprev = obs.set_enabled(True), j_obs.set_enabled(True)
    try:
        _clear(obs)
        _clear(j_obs)
        jeng = JScheduledEngine(jp, jcfg, JSchedulerConfig(**SCHED))
        jr = [jeng.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=NEW), arrival=a)
              for p, a in zip(prompts, ARRIVALS)]
        jout = jeng.run()
        teng = ScheduledEngine(tp, tcfg, SchedulerConfig(**SCHED), device="cpu")
        tr = [teng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=NEW), arrival=a)
              for p, a in zip(prompts, ARRIVALS)]
        tout = teng.run()
        snaps = j_obs.snapshot(), obs.snapshot()
    finally:
        _clear(obs)
        _clear(j_obs)
        obs.set_enabled(prev)
        j_obs.set_enabled(jprev)
    return [jout[r] for r in jr], [tout[r] for r in tr], teng, *snaps


def test_moe_streams_equal_reference_engine(drains):
    want, got, eng, _, _ = drains
    for rid, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {rid}")
        assert eng.requests[rid].state is RequestState.DONE and len(g) == NEW
    # one decode step over every occupied slot: 3 slots, then the 2 late ones
    assert [n for _, n, _ in eng.tick_log] == [3] * (NEW - 1) + [2] * (NEW - 1)
    assert not eng.active and not len(eng.queue)
    assert eng.slots.free_slot_count == 3 and not eng.slots.page_table.any()
    assert eng.slots.free_page_count == eng.pool.n_pages - 1


def test_moe_sched_counters_equal_reference(drains):
    _, _, _, jsnap, snap = drains
    assert _series(snap) == _series(jsnap)
    assert _series(snap)[("sched.prefill_batches", ())] == 3
    # bucket 8 chunked to 2 + 1, then the two late requests at bucket 16
    assert _prefill_spans(snap) == _prefill_spans(jsnap) == [(2, 8), (1, 8), (2, 16)]
    names = collections.Counter(sp["name"] for sp in snap["spans"]
                                if sp["name"].startswith(("sched.", "req.", "request")))
    jnames = collections.Counter(sp["name"] for sp in jsnap["spans"]
                                 if sp["name"].startswith(("sched.", "req.", "request")))
    assert names == jnames


def test_deepseek_is_refused_with_the_reference_message():
    arch = "deepseek-v2-lite-16b"
    with pytest.raises(AssertionError) as want:
        JScheduledEngine(None, j_smoke(arch), JSchedulerConfig(**SCHED))
    cfg = get_smoke_config(arch)
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError) as got:
        ScheduledEngine(params, cfg, SchedulerConfig(**SCHED), device="cpu")
    assert str(got.value) == str(want.value) == (
        "paged slots need a homogeneous attention stack, got cache groups ['body', 'head']")


def test_mla_moe_without_a_head_equals_generate_on_its_batch():
    """deepseek-v2-lite-16b's smoke stack without its leading dense layer:
    one cache group of MLA's latent leaves, which the pool holds as the
    reference's does. Three 8-token prompts at tick 0 form one prefill
    batch (no pad) and then one decode batch, so the engine's tokens equal
    greedy ``generate`` on that (3, 8) batch with the slot capacity as its
    cache: the paged gather and write-back are copies of the contiguous
    cache (``generate`` itself is held to the reference by
    ``tests/test_torch_mla.py``)."""
    from repro_torch.serving import ServeConfig, generate

    cfg = get_smoke_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, first_dense_layers=0))
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    sc = SchedulerConfig(**{**SCHED, "max_prefill_batch": 3})
    eng = ScheduledEngine(params, cfg, sc, device="cpu")
    assert set(eng.pool.leaves) == {"ckv", "kpe"}
    rids = [eng.submit(t, SamplingParams(temperature=0.0, max_new_tokens=NEW)) for t in tokens]
    out = eng.run()
    want = generate(params, {"tokens": tokens, "lengths": np.full(3, 8, np.int32)}, cfg,
                    ServeConfig(max_new_tokens=NEW, temperature=0.0,
                                cache_len=sc.slot_capacity), device="cpu")["tokens"]
    np.testing.assert_array_equal(np.stack([out[r] for r in rids]), want)
    assert [n for _, n, _ in eng.tick_log] == [3] * (NEW - 1)


def test_max_prefill_batch_zero_is_refused():
    with pytest.raises(AssertionError):
        JSchedulerConfig(max_prefill_batch=0)
    with pytest.raises(AssertionError):
        SchedulerConfig(max_prefill_batch=0)
    assert SchedulerConfig().max_prefill_batch == JSchedulerConfig().max_prefill_batch == 4


def test_dense_tokens_do_not_depend_on_max_prefill_batch():
    """A dense stack prefills each admitted request alone, in bucket order:
    one prefill a request at either setting, the same tokens."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    outs = []
    for mpb in (1, 4):
        eng = ScheduledEngine(params, cfg, SchedulerConfig(
            **{**SCHED, "max_prefill_batch": mpb}), device="cpu")
        sizes, real = [], eng._prefill_launch
        eng._prefill_launch = lambda blen, reqs: sizes.append(len(reqs)) or real(blen, reqs)
        rids = [eng.submit(p, SamplingParams(k=8, temperature=0.8, seed=i,
                                             max_new_tokens=4), arrival=a)
                for i, (p, a) in enumerate(zip(prompts, ARRIVALS))]
        out = eng.run()
        assert sizes == [1] * len(LENS)
        outs.append([out[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
