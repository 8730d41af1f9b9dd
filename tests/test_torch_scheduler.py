"""CPU tests of the port's request scheduler (smoke config of Qwen3-8B,
float32).

* The contract: every request's tokens through ``ScheduledEngine`` equal
  a solo ``generate`` of that request at batch 1 with ``cache_len`` = the
  slot capacity and the same seed, whatever shares the batch (staggered
  arrivals, queueing, slot reuse, mixed k, nucleus, greedy, a finish at
  prefill), and do not depend on the slot reuse order.
* Greedy streams equal the JAX ``ScheduledEngine``'s on the same weights.
* The per-request-k sampler equals the reference's
  ``_sample_topk_ragged`` given the reference's own Gumbel noise.
* Load shedding, expiry and exhausted retries drain with no slot or page
  left allocated.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model_init as j_model_init
from repro.serving import sample as j_sample
from repro.serving.scheduler import SamplingParams as JSamplingParams
from repro.serving.scheduler import ScheduledEngine as JScheduledEngine
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import decode_step, init_cache, params_from_jax, prefill
from repro_torch.serving import ServeConfig, generate, sample
from repro_torch.serving.scheduler import (QueueFull, RequestState, SamplingParams,
                                           ScheduledEngine, SchedulerConfig)

SCHED = SchedulerConfig(n_slots=3, page_size=8, pages_per_slot=5)


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


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params): the
    reference's weights carried over."""
    jcfg = dataclasses.replace(j_smoke("qwen3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _requests():
    """Staggered mixed-k requests: a queue (3 slots for 6), slot reuse,
    nucleus, greedy, k=1, a finish at prefill."""
    rng = np.random.default_rng(0)
    sp = [SamplingParams(k=64, temperature=0.8, seed=1, max_new_tokens=10),
          SamplingParams(k=16, temperature=1.0, seed=2, max_new_tokens=12),
          SamplingParams(k=200, temperature=0.7, top_p=0.9, seed=3, max_new_tokens=9),
          SamplingParams(temperature=0.0, seed=4, max_new_tokens=8),
          SamplingParams(k=64, temperature=0.8, top_p=0.95, seed=5, max_new_tokens=1),
          SamplingParams(k=1, temperature=0.8, seed=6, max_new_tokens=8)]
    lens, arrivals = (20, 7, 13, 5, 30, 3), (0, 0, 1, 2, 3, 3)
    return [(rng.integers(0, 256, n).astype(np.int32), p, a)
            for n, p, a in zip(lens, sp, arrivals)]


def _drain(params, cfg, reqs, sched=SCHED):
    eng = ScheduledEngine(params, cfg, sched, device="cpu")
    rids = [eng.submit(pr, sp, arrival=a) for pr, sp, a in reqs]
    out = eng.run()
    return eng, [out[r] for r in rids]


def _no_leak(eng):
    assert not eng.active and not len(eng.queue)
    assert eng.slots.free_slot_count == eng.sc.n_slots
    assert eng.slots.free_page_count == eng.pool.n_pages - 1
    assert not eng.slots.page_table.any()


@pytest.fixture(scope="module")
def drained(model):
    _, _, tcfg, tp = model
    return _drain(tp, tcfg, _requests())


def test_scheduled_streams_equal_solo_generate(model, drained):
    _, _, tcfg, tp = model
    eng, got = drained
    for (prompt, sp, _), toks in zip(_requests(), got):
        solo = generate(tp, {"tokens": prompt[None]}, tcfg, ServeConfig(
            max_new_tokens=sp.max_new_tokens, top_k=sp.k, top_p=sp.top_p,
            temperature=sp.temperature, seed=sp.seed, cache_len=SCHED.slot_capacity),
            device="cpu")["tokens"][0]
        np.testing.assert_array_equal(toks, solo)
    _no_leak(eng)
    # queueing happened: at most 3 slots decoded at once, more ticks than tokens
    assert max(n for _, n, _ in eng.tick_log) == SCHED.n_slots
    assert any(len(ks) > 1 and len(set(ks)) > 1 for _, _, ks in eng.tick_log)


def test_decode_rows_are_batch_invariant(model):
    """One decode step gives each row the same logits bits alone as inside
    a batch of 4 (the rows are padded to ``DECODE_TILE``; attention is one
    batched call over the cache's rows)."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(5)
    lens, solo = (12, 7, 3, 9), []
    for n in lens:
        toks = torch.from_numpy(rng.integers(0, 256, (1, n)).astype(np.int32))
        lg, c = prefill(tp, {"tokens": toks}, init_cache(tcfg, 1, 16, "cpu"), tcfg)
        solo.append((torch.argmax(lg, -1).to(torch.int32)[:, None], c["body"]))

    def step(rows):
        body = [{"k": torch.cat([solo[r][1][i]["k"] for r in rows]),
                 "v": torch.cat([solo[r][1][i]["v"] for r in rows]),
                 "pos": torch.tensor([lens[r] for r in rows], dtype=torch.int32)}
                for i in range(tcfg.n_layers)]
        pos = torch.tensor([[lens[r]] for r in rows], dtype=torch.int32)
        return decode_step(tp, torch.cat([solo[r][0] for r in rows]), {"body": body},
                           tcfg, positions=pos)[0]

    batch = step(range(4))
    for r in range(4):
        assert torch.equal(batch[r], step([r])[0])


def test_slot_order_does_not_change_tokens(model, drained):
    _, _, tcfg, tp = model
    _, lifo = _drain(tp, tcfg, _requests(), dataclasses.replace(SCHED, slot_order="lifo"))
    for a, b in zip(drained[1], lifo):
        np.testing.assert_array_equal(a, b)


def test_greedy_streams_equal_reference_engine(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 4, 14)]
    jsched = JSchedulerConfig(n_slots=2, page_size=8, pages_per_slot=3)
    jeng = JScheduledEngine(jp, jcfg, jsched)
    jr = [jeng.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=5), arrival=i)
          for i, p in enumerate(prompts)]
    jout = jeng.run()
    teng = ScheduledEngine(tp, tcfg, SchedulerConfig(n_slots=2, page_size=8,
                                                     pages_per_slot=3), device="cpu")
    tr = [teng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=5), arrival=i)
          for i, p in enumerate(prompts)]
    tout = teng.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tout[b], jout[a])


def test_ragged_sampler_matches_reference_with_its_noise(monkeypatch):
    """Per-request k and top_p: the reference's categorical draw is
    argmax(logits + gumbel(key)); the port given that noise agrees."""
    from repro import segment_topk as j_segment_topk

    # the reference's auto route on the CPU is its per-segment XLA path
    monkeypatch.setattr(j_sample, "segment_topk",
                        lambda *a, **kw: j_segment_topk(*a, backend="auto", **kw))
    rng = np.random.default_rng(9)
    logits = (rng.integers(-20, 21, (4, 300)) * 0.25).astype(np.float32)
    ks, tps = (16, 1, 64, 5), (1.0, 0.5, 0.9, 1.0)
    key = jax.random.PRNGKey(4)
    want = j_sample._sample_topk_ragged(key, jnp.asarray(logits), ks, 0.8, tps)
    noise = np.array(jax.random.gumbel(key, (4, max(ks)), jnp.float32))
    got = sample.sample_topk(torch.from_numpy(logits), k=ks, temperature=0.8, top_p=tps,
                             gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_queue_full_ttl_and_failed_drain_clean(model, monkeypatch):
    _, _, tcfg, tp = model
    rng = np.random.default_rng(2)
    p = lambda n: rng.integers(0, 256, n)  # noqa: E731
    eng = ScheduledEngine(tp, tcfg, dataclasses.replace(
        SCHED, n_slots=1, max_queue=2, retry_backoff_s=0.0), device="cpu")
    a = eng.submit(p(5), SamplingParams(k=8, max_new_tokens=6, seed=1))
    b = eng.submit(p(5), SamplingParams(k=8, max_new_tokens=6, ttl_ticks=2), arrival=0)
    with pytest.raises(QueueFull):
        eng.submit(p(5), SamplingParams(k=8))
    eng.run()
    states = {r: eng.requests[r].state for r in eng.requests}
    assert states[a] is RequestState.DONE and len(eng.result(a)) == 6
    assert states[b] is RequestState.TIMED_OUT  # queued behind a past its ttl
    assert states[2] is RequestState.REJECTED
    _no_leak(eng)

    calls = {"n": 0}

    def broken(*args, **kw):
        calls["n"] += 1
        raise RuntimeError("injected decode fault")

    monkeypatch.setattr(eng, "_decode_tile", broken)
    c = eng.submit(p(6), SamplingParams(k=8, max_new_tokens=4), arrival=eng.t)
    d = eng.submit(p(3), SamplingParams(k=8, max_new_tokens=1), arrival=eng.t)
    eng.run()
    assert eng.requests[c].state is RequestState.FAILED
    assert "injected decode fault" in eng.requests[c].error
    assert calls["n"] == 1 + eng.sc.max_retries
    assert eng.requests[d].state is RequestState.DONE  # finished at prefill
    _no_leak(eng)


def test_launcher_engine_on_cpu(capsys):
    out = launcher.main(["--arch", "qwen3-8b", "--smoke", "--engine", "--batch", "3",
                         "--prompt-len", "6", "--new-tokens", "3", "--slots", "2",
                         "--page-size", "4", "--device", "cpu"])
    assert len(out["tokens"]) == 3 and all(len(t) == 3 for t in out["tokens"].values())
    assert "[serve] engine drained 3 requests" in capsys.readouterr().out
