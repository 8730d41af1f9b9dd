"""repro_torch.obs: spans, metrics, recorder, export, timing, the no-op
guarantees, and the telemetry the port's modules record, held against
the JAX package's ``repro.obs``.

* With obs off, instrumentation is invisible: one shared null context, no
  span, metric or event stored, under 5 µs a disabled span, and the same
  results and kernel calls as with it on.
* The port's counting rule (``repro_torch.obs.trace``): planning metrics
  count calls, not compilations.
* The exported Chrome trace passes its own schema check and the
  reference's, also under concurrent export; the Prometheus text is
  byte-equal to the reference's for the same mutations.
* A smoke-width greedy ``generate`` and a scheduler drain give the
  reference's span names and ``serve.*`` / ``sched.*`` values, apart from
  ``sched.prefill_batches`` (the port prefills each request alone).
* ``segmented.class_launches`` and ``grid_merge.launches`` equal the
  class-kernel and grid-merge calls, which are the launches on the card.
"""
import collections
import dataclasses
import json
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as j_obs

import repro_torch
import repro_torch.obs as obs
from repro_torch.obs import export, metrics, recorder, timing, trace

RNG = np.random.default_rng(0)


def _clear(pkg):
    pkg.trace.clear()
    pkg.metrics.reset()
    pkg.recorder.clear()


@pytest.fixture
def obs_on():
    prev = obs.set_enabled(True)
    _clear(obs)
    yield
    _clear(obs)
    obs.set_enabled(prev)


@pytest.fixture
def obs_off():
    prev = obs.set_enabled(False)
    _clear(obs)
    yield
    obs.set_enabled(prev)


@pytest.fixture
def both_on():
    """Obs on in both packages, each starting empty."""
    prev, jprev = obs.set_enabled(True), j_obs.set_enabled(True)
    _clear(obs)
    _clear(j_obs)
    yield
    _clear(obs)
    _clear(j_obs)
    obs.set_enabled(prev)
    j_obs.set_enabled(jprev)


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_caches(tmp_path_factory):
    """Both packages' planners off any cached tournament winner."""
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


# ---------------------------------------------------------------- spans


def test_span_nesting_records_parent_ids(obs_on):
    with obs.span("outer", kind="run", a=1):
        with obs.span("inner", kind="trace"):
            pass
    inner, outer = trace.spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert outer.attrs == {"a": 1} and inner.kind == "trace"
    assert outer.dur_ns >= inner.dur_ns >= 0


def test_span_disabled_is_shared_null_context(obs_off):
    a, b = obs.span("x", kind="run", n=1), obs.span("y", kind="trace")
    assert a is b is trace._NULL
    with a:
        pass
    assert trace.spans() == () and recorder.events() == []


def test_traced_decorator(obs_on):
    @obs.traced("deco.fn")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert [sp.name for sp in trace.spans()] == ["deco.fn"]


def test_run_span_is_a_profiler_range(obs_on):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("unit.region", kind="run"):
            torch.ones(8).sum()
    assert "unit.region" in {ev.key for ev in prof.key_averages()}


def test_disabled_span_overhead_under_5us(obs_off):
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("hot", kind="run", arg=1):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 5e-6, f"disabled span costs {per_call * 1e6:.2f}us/call"


def test_record_span_explicit_time(obs_on):
    sid = obs.record_span("req.queue_wait", 1000, 2500, rid=3)
    sp = trace.spans()[-1]
    assert sid == sp.span_id and sp.name == "req.queue_wait"
    assert (sp.t0_ns, sp.dur_ns, sp.attrs) == (1000, 2500, {"rid": 3})
    obs.record_span("x", 5000, -10)  # a negative duration clamps to zero
    assert trace.spans()[-1].dur_ns == 0


def test_record_span_disabled_returns_none(obs_off):
    assert obs.record_span("x", 0, 10) is None
    assert trace.spans() == ()


# --------------------------------------------------------------- metrics


def test_metrics_and_recorder_disabled_are_inert(obs_off):
    metrics.counter("c").inc(5)
    metrics.gauge("g").set(1.0)
    metrics.histogram("h").observe(2.0)
    recorder.emit("unit", "x", n=1)
    assert metrics.counter("c").total() == 0
    assert metrics.gauge("g").value() is None
    assert metrics.histogram("h").stats() is None
    assert recorder.events() == [] and recorder.total_events() == 0


def test_histogram_reservoir_exhaustion_is_visible(obs_on):
    h = metrics.histogram("res")
    for i in range(h.max_samples + 10):
        h.observe(float(i))
    row = h.series()[0]
    assert row["count"] == h.max_samples + 10
    assert row["samples"] == h.max_samples and row["reservoir_full"]
    assert row["p50"] <= row["p95"] <= row["p99"] <= row["max"]


def test_metric_kind_collision_asserts(obs_on):
    metrics.counter("kc").inc()
    with pytest.raises(AssertionError, match="already registered as counter"):
        metrics.gauge("kc")


def test_planning_counters_count_calls(obs_on):
    """The port's rule: eager calls, so three calls on one shape add
    three to ``plan.decisions`` (the reference adds one: a compilation),
    and ``plan_op`` counts every plan."""
    from repro_torch.streaming.planner import plan_op

    x = torch.from_numpy(RNG.normal(size=(2, 64)).astype(np.float32))
    for _ in range(3):
        repro_torch.sort(x)
    assert metrics.counter("plan.decisions").total() == 3
    assert trace.spans()[0].name == "plan" and trace.spans()[0].kind == "trace"
    plans = metrics.counter("plan.tile_plans")
    before = plans.value(op="sort", source="heuristic")
    for _ in range(2):
        plan_op("sort", (64,), batch=2)
    assert plans.value(op="sort", source="heuristic") == before + 2
    st = metrics.histogram("plan.vmem_bytes").stats(op="sort")
    assert st["count"] == before + 2 and st["min"] > 0


def test_autotune_cache_counters_and_quarantine(obs_on, tmp_path):
    from repro_torch.streaming.cache import AutotuneCache, plan_key

    cache = AutotuneCache(path=str(tmp_path / "at.json"))
    key = plan_key("sort", shapes=(4, 128), dtype="float32")
    c = metrics.counter("autotune.cache")
    assert cache.get(key) is None and c.value(op="sort", result="miss") == 1
    cache.put(key, {"kind": "loms", "n_cols": 8, "block_batch": 4, "use_mxu": False})
    assert cache.get(key) is not None and c.value(op="sort", result="hit") == 1
    cache._entries[key]["_schema"] = -1
    assert cache.get(key) is None and c.value(op="sort", result="stale_schema") == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{ torn")
    AutotuneCache(path=str(bad))
    assert c.value(op="-", result="quarantined") == 1
    assert [ev.kind for ev in recorder.events()] == ["quarantine"]
    assert (tmp_path / "bad.json.bad").exists()


def test_autotune_tournament_telemetry(obs_on, tmp_path):
    from repro_torch.streaming.cache import AutotuneCache
    from repro_torch.streaming.planner import autotune_topk

    cache = AutotuneCache(path=str(tmp_path / "t.json"))
    us = {16: 3.0, 32: 1.0, 64: 2.0, 128: 4.0}
    best = autotune_topk(128, 8, batch=2, cache=cache, device="cpu",
                         timer=lambda plan, fn: us[plan.block])
    assert best.block == 32 and best.us == 1.0
    assert any(sp.name == "autotune.topk" and sp.kind == "run" for sp in trace.spans())
    assert metrics.counter("autotune.sweeps").value(op="topk") == 1
    assert metrics.counter("tournament.picks").value(op="topk", family="loms") == 1
    ev = [e for e in recorder.events() if e.kind == "tournament"]
    assert len(ev) == 1 and ev[0].name == "topk:loms" and ev[0].attrs["us"] == 1.0


def test_segmented_and_grid_counters_equal_kernel_calls(obs_on, monkeypatch):
    """``segmented.class_launches`` counts the class-kernel calls (a class
    of width 1 none, a values-only sort spill its chunk sort) and
    ``grid_merge.launches`` the grid merges: on the card, each call is one
    launch (``LAUNCHES``)."""
    import repro_torch.segmented.core as core

    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(core, name, wrapper)

    for name in ("segment_class_sort", "segment_class_merge", "grid_merge2_rows"):
        counted(name, getattr(core, name))
    lens = [1, 5, 8, 16, 3, 2048, 2048]  # a width-1 class, three classes, a spill
    offs = tuple(np.concatenate([[0], np.cumsum(lens)]).tolist())
    x = torch.from_numpy(RNG.normal(size=(offs[-1],)).astype(np.float32))
    got = repro_torch.segment_sort(x, offs)
    want = torch.cat([torch.sort(x[a:b]).values for a, b in zip(offs[:-1], offs[1:])])
    assert torch.equal(got, want)
    la, lb = (4, 9, 2), (3, 7, 6)
    oa = tuple(np.concatenate([[0], np.cumsum(la)]).tolist())
    ob = tuple(np.concatenate([[0], np.cumsum(lb)]).tolist())
    a = torch.cat([torch.sort(torch.randn(n)).values for n in la])
    b = torch.cat([torch.sort(torch.randn(n)).values for n in lb])
    repro_torch.segment_merge(a, b, oa, ob)
    repro_torch.segment_topk(x[:offs[4]], offs[:5], 2)
    cl = metrics.counter("segmented.class_launches")
    assert cl.total() == calls["segment_class_sort"] + calls["segment_class_merge"] > 0
    assert cl.value(op="segment_sort") == 4  # three classes + the spill's chunk sort
    assert metrics.counter("segmented.spill_groups").value(op="segment_sort") == 1
    assert metrics.counter("grid_merge.launches").total() == calls["grid_merge2_rows"] == 2
    assert metrics.counter("grid_merge.refill_tiles").total() > 0
    assert metrics.histogram("segmented.padded_waste_frac").stats(op="segment_sort")["count"] == 1


# --------------------------------------------------------------- recorder


def test_recorder_ring_wraparound_keeps_newest(obs_on):
    old = recorder.capacity()
    recorder.set_capacity(8)
    try:
        for i in range(20):
            recorder.emit("unit", "tick", i=i)
        evs = recorder.events()
        assert len(evs) == 8 and [e.attrs["i"] for e in evs] == list(range(12, 20))
        assert evs[0].seq == 13 and recorder.overwritten() == 12
        assert recorder.dump()["meta"]["overwritten"] == 12
    finally:
        recorder.set_capacity(old)


def test_recorder_crash_dump_to_env_path_and_stderr(obs_on, tmp_path, monkeypatch, capsys):
    recorder.emit("sched", "request.failed", rid=1)
    path = tmp_path / "crash.jsonl"
    monkeypatch.setenv("REPRO_OBS_DUMP", str(path))
    assert recorder.crash_dump("unit", RuntimeError("boom")) == str(path)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[0]["type"] == "meta" and lines[0]["reason"] == "crash:unit:RuntimeError"
    assert lines[1]["name"] == "request.failed"
    monkeypatch.delenv("REPRO_OBS_DUMP")
    assert recorder.crash_dump("unit", ValueError("x")) is None
    assert "crash:unit:ValueError" in capsys.readouterr().err


def test_scheduler_run_dumps_on_an_unhandled_error(obs_on, tmp_path, monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_init
    from repro_torch.serving.scheduler import SamplingParams, ScheduledEngine

    cfg = get_smoke_config("qwen3-8b")
    eng = ScheduledEngine(model_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg,
                          device="cpu")
    eng.submit(np.arange(4, dtype=np.int32), SamplingParams(temperature=0.0))
    monkeypatch.setattr(eng, "_expire", lambda: (_ for _ in ()).throw(KeyError("wedged")))
    path = tmp_path / "sched.jsonl"
    monkeypatch.setenv("REPRO_OBS_DUMP", str(path))
    with pytest.raises(KeyError):
        eng.run()
    meta = json.loads(path.read_text().splitlines()[0])
    assert meta["reason"] == "crash:sched.run:KeyError"


def test_recorder_sigusr1_dump(obs_on, tmp_path):
    recorder.emit("unit", "alive", n=1)
    path = tmp_path / "sig.jsonl"
    assert recorder.install_signal_dump(str(path))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5.0
        while not path.exists() and time.time() < deadline:
            time.sleep(0.01)
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert lines[0]["reason"] == "SIGUSR1"
        assert any(ln.get("name") == "alive" for ln in lines[1:])
    finally:
        recorder.uninstall_signal_dump()


# --------------------------------------------------------------- export


def test_snapshot_and_jsonl_schema(obs_on, tmp_path):
    with obs.span("region", kind="run", tag="t"):
        pass
    metrics.counter("c").inc(op="sort")
    snap = obs.snapshot()
    assert set(snap) == {"meta", "spans", "metrics", "events"}
    meta = snap["meta"]
    assert meta["schema"] == 1 and meta["dropped_spans"] == 0
    assert meta["platform"] in ("cpu", "cuda") and meta["torch"] == torch.__version__
    assert {"cuda", "device"} <= set(meta) and meta["span_cap"] == trace.MAX_SPANS
    assert snap["spans"][0]["attrs"] == {"tag": "t"}
    assert [ev["kind"] for ev in snap["events"]] == ["span"]
    path = tmp_path / "out.jsonl"
    obs.write_jsonl(str(path), snap)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["type"] for ln in lines] == ["meta", "span", "metric", "event"]


def test_chrome_trace_valid_here_and_in_the_reference(obs_on, tmp_path):
    with obs.span("outer", kind="run"):
        with obs.span("inner", kind="trace"):
            pass
    metrics.counter("c").inc(3)
    recorder.emit("unit", "mark")
    obs.record_span("request", time.perf_counter_ns(), 10, rid=0, state="done")
    path = tmp_path / "t.trace.json"
    obs.write_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    assert obs.validate_chrome_trace(loaded) == []
    assert j_obs.validate_chrome_trace(loaded) == []
    assert j_obs.validate_chrome_trace(obs.request_chrome_trace()) == []
    evs = {ev["name"]: ev for ev in loaded["traceEvents"]}
    assert evs["outer"]["ph"] == "X" and evs["outer"]["cat"] == "run"
    assert evs["unit:mark"]["ph"] == "i"
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0, "ts": -1, "dur": 1},
                           {"ph": "Q"}]}
    errs = obs.validate_chrome_trace(bad)
    assert errs == j_obs.validate_chrome_trace(bad) and len(errs) == 5


def _mutate(pkg):
    pkg.metrics.counter("sched.completed", "done").inc(3)
    pkg.metrics.counter("plan.decisions").inc(op="sort", backend="cuda")
    pkg.metrics.counter("plan.decisions").inc(2, op="topk", backend='sch"ed')
    pkg.metrics.gauge("sched.queue_depth").set(2.0)
    h = pkg.metrics.histogram("sched.ttft_s")
    for v in (0.1, 0.2, 0.3, 0.05):
        h.observe(v, op="sort")
    pkg.metrics.histogram("serve.tok_per_s").observe(57.5)


def test_prom_text_byte_equal_to_reference(both_on, tmp_path):
    _mutate(obs)
    _mutate(j_obs)
    txt = obs.prom_text()
    assert txt == j_obs.prom_text()
    assert "repro_sched_completed_total 3" in txt
    assert 'repro_sched_ttft_s{op="sort",quantile="0.5"}' in txt
    p = tmp_path / "metrics.prom"
    obs.write_prom(str(p))
    assert p.read_text() == txt


def test_export_under_concurrency_schema_valid(obs_on, tmp_path):
    stop = threading.Event()

    def producer(tid):
        i = 0
        while not stop.is_set() and i < 400:
            with obs.span(f"conc.{tid}", kind="trace", i=i):
                metrics.counter("conc.ops").inc(tid=tid)
                recorder.emit("unit", f"conc.{tid}", i=i)
            i += 1

    threads = [threading.Thread(target=producer, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    try:
        for j in range(5):
            snap = obs.snapshot()
            assert obs.validate_chrome_trace(obs.chrome_trace(snap)) == []
            path = tmp_path / f"conc{j}.jsonl"
            obs.write_jsonl(str(path), snap)
            types = [json.loads(ln)["type"] for ln in path.read_text().splitlines()]
            assert types[0] == "meta" and set(types) <= {"meta", "span", "metric", "event"}
            assert all(ln.startswith(("# ", "repro_"))
                       for ln in obs.prom_text(snap).splitlines() if ln)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert {"conc.0", "conc.1"} <= {sp.name for sp in trace.spans()}


# --------------------------------------------------------------- timing


def test_time_jitted_stats_ordering(obs_on):
    x = torch.from_numpy(RNG.normal(size=(4, 256)).astype(np.float32))
    st = timing.time_jitted(torch.sort, x, warmup=1, iters=5, name="unit")
    assert st.n == 5 and len(st.samples_us) == 5
    assert st.min_us <= st.p50_us <= st.p95_us <= st.p99_us <= st.max_us
    assert st.p50_s == pytest.approx(st.p50_us * 1e-6)
    assert set(st.to_row()) == {"p50_us", "p95_us", "p99_us"}
    assert metrics.histogram("timing.unit").stats()["count"] == 1
    assert any(sp.name == "timing.unit" for sp in trace.spans())


def test_time_once_returns_the_result():
    x = torch.arange(6.0)
    (out, tup), dt = timing.time_once(lambda v: (v * 2, {"a": [v]}), x)
    assert torch.equal(out, x * 2) and tup["a"][0] is x and dt >= 0.0
    assert timing.block_until_ready(None) is None


# ------------------------------------------- serving against the reference


@pytest.fixture(scope="module")
def model():
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import model_init as j_model_init
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params_from_jax

    jcfg = dataclasses.replace(j_smoke("qwen3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _series(snap, prefix):
    """{(metric, labels): value, or a histogram's count} of a prefix."""
    out = {}
    for name, m in snap["metrics"].items():
        if name.startswith(prefix):
            for s in m["series"]:
                key = (name, tuple(sorted(s["labels"].items())))
                out[key] = s["count"] if m["kind"] == "histogram" else s["value"]
    return out


def _names(snap, prefixes):
    return collections.Counter(sp["name"] for sp in snap["spans"]
                               if sp["name"].startswith(prefixes))


def test_generate_telemetry_matches_reference(model, both_on):
    from repro.serving.engine import ServeConfig as JServeConfig
    from repro.serving.engine import generate as j_generate
    from repro_torch.serving import ServeConfig, generate

    jcfg, jp, tcfg, tp = model
    toks = np.random.default_rng(4).integers(0, 256, (2, 6)).astype(np.int32)
    want = j_generate(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))
    got = generate(tp, {"tokens": toks}, tcfg, ServeConfig(max_new_tokens=4, temperature=0.0),
                   device="cpu")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    snap, jsnap = obs.snapshot(), j_obs.snapshot()
    assert _names(snap, "serve.") == _names(jsnap, "serve.") == {
        "serve.prefill": 1, "serve.decode": 1}
    assert _series(snap, "serve.") == _series(jsnap, "serve.")
    assert metrics.counter("serve.tokens").total() == 2 * 4
    sp = {s["name"]: s for s in snap["spans"]}
    assert sp["serve.prefill"]["attrs"] == {"batch": 2, "prompt_len": 6}
    assert sp["serve.decode"]["attrs"] == {"batch": 2, "steps": 3}


def test_scheduler_drain_telemetry_matches_reference(model, both_on):
    from repro.serving.scheduler import SamplingParams as JSamplingParams
    from repro.serving.scheduler import ScheduledEngine as JScheduledEngine
    from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
    from repro_torch.serving.scheduler import (SamplingParams, ScheduledEngine,
                                               SchedulerConfig)

    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 4, 14)]
    jeng = JScheduledEngine(jp, jcfg, JSchedulerConfig(n_slots=2, page_size=8,
                                                       pages_per_slot=3))
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
    snap, jsnap = obs.snapshot(), j_obs.snapshot()
    names = ("sched.", "req.", "request")
    assert _names(snap, names) == _names(jsnap, names)
    by_design = {"sched.prefill_batches"}
    got = {k: v for k, v in _series(snap, "sched.").items() if k[0] not in by_design}
    want = {k: v for k, v in _series(jsnap, "sched.").items() if k[0] not in by_design}
    assert got == want
    assert metrics.counter("sched.completed").total() == 3
    assert metrics.counter("sched.prefill_batches").total() == 3  # one a request
    falls = obs.request_waterfalls(snap)
    assert [w["rid"] for w in falls] == [0, 1, 2]
    for w in falls:  # the stages tile the TTFT exactly, never past the total
        assert w["state"] == "done" and w["decode_ticks"] == 4
        assert w["ttft_ns"] == teng.requests[w["rid"]].t_first_ns - \
            teng.requests[w["rid"]].t_submit_ns
        assert w["unaccounted_ns"] >= 0
    assert sum(ev["kind"] == "sched" for ev in snap["events"]) == 3


def test_results_and_kernel_calls_equal_with_obs_on_and_off(model, monkeypatch):
    """Obs changes nothing the port computes: the same tokens, logits and
    kernel-wrapper calls with it on as off."""
    import repro_torch.kernels.ops as KO
    import repro_torch.segmented.core as core
    from repro_torch.serving import ServeConfig, generate

    tcfg, tp = model[2:]
    calls = collections.Counter()
    for mod, name in ((KO, "router_topk"), (KO, "vocab_topk"), (core, "segment_class_sort")):
        real = getattr(mod, name)

        def wrapper(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    toks = np.random.default_rng(5).integers(0, 256, (2, 6)).astype(np.int32)
    x = torch.from_numpy(RNG.normal(size=(300,)).astype(np.float32))
    offs = (0, 7, 40, 300)
    runs = []
    for on in (False, True, False):
        prev = obs.set_enabled(on)
        _clear(obs)
        calls.clear()
        try:
            out = generate(tp, {"tokens": toks}, tcfg,
                           ServeConfig(max_new_tokens=3, temperature=0.8, seed=1),
                           device="cpu")["tokens"]
            seg = repro_torch.segment_topk(x, offs, 5)
            runs.append((out, [t.clone() for t in seg[:2]], dict(calls),
                         len(trace.spans()), metrics.snapshot()))
        finally:
            obs.set_enabled(prev)
    (o0, s0, c0, n0, m0), (o1, s1, c1, n1, m1), (o2, s2, c2, n2, m2) = runs
    np.testing.assert_array_equal(o0, o1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert c0 == c1 == c2 and sum(c0.values()) > 0
    assert n0 == n2 == 0 and n1 > 0
    assert all(not m["series"] for m in m2.values())  # off: nothing recorded
    _clear(obs)
