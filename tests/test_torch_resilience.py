"""The port's resilience layer (``repro_torch.resilience``) against the
reference's (``repro.resilience``), on the CPU.

* failpoints: the trigger grammar, the seeded ``p:`` trigger firing on
  the same hits as the reference's, prefix matching, context restore,
  the environment, the ``failpoints.fired`` counter and events;
* breakers: the reference's ``CircuitBreaker`` and the port's on the
  same call sequence, the cooldown on a faked clock (never slept), peek;
* the ladder: ``rungs_for`` on a table of specs against the reference's
  (its ``pallas`` is the port's ``cuda``), degrade, explicit ask,
  disabled, exhaustion, skip, forced, the events' labels, the plan-time
  reroute, the segmented degrade under spill faults, only injected
  faults degrading a call on the card, and every seam
  armed ``off`` leaving results and counters as they were;
* the autotune cache: quarantine, concurrent writers, load and store
  failures;
* the scheduler (the port's smoke chatglm3-6b, float32): transient,
  persistent and seeded-chaos faults drained with every request terminal
  and no slot or page leaked, completed streams bit-equal to the port's
  fault-free drain (which ``test_torch_scheduler.py`` holds to the JAX
  engine); TTL and QueueFull;
* the tie order: each port rung against the reference's same rung on
  tied bf16 rows with ±0.0, ±inf and NaN, and which rungs agree with each
  other (the contract in ``resilience/ladder.py``'s docstring).
"""
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.api.spec import SortSpec as JSpec
from repro.resilience import breaker as j_breaker
from repro.resilience import ladder as j_ladder
from repro_torch.api.dispatch import Decision
from repro_torch.api.spec import SortSpec
from repro_torch.resilience import (CircuitBreaker, FailpointError, LadderSkip,
                                    ResilienceExhausted, arm, breaker_for, breaker_states,
                                    configure_breakers, failpoint, failpoints, fires, hits,
                                    reset_breakers, reset_failpoints, run_ladder, rungs_for,
                                    set_resilience_enabled)
from repro_torch.resilience import breaker as t_breaker

# the packages export the ``failpoints`` context manager under the module's name
j_failpoints = importlib.import_module("repro.resilience.failpoints")
t_failpoints = importlib.import_module("repro_torch.resilience.failpoints")


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_cache(tmp_path_factory):
    """Both packages on one empty cache: a cached winner would change the
    family, and the tie order."""
    from repro.streaming.cache import AutotuneCache as JCache
    from repro.streaming.cache import set_default_cache as j_set
    from repro_torch.streaming.cache import AutotuneCache, set_default_cache

    path = str(tmp_path_factory.mktemp("autotune") / "autotune.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    prev, jprev = set_default_cache(AutotuneCache(path)), j_set(JCache(path))
    yield
    set_default_cache(prev)
    j_set(jprev)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


@pytest.fixture(autouse=True)
def _clean():
    reset_failpoints()
    reset_breakers()
    yield
    reset_failpoints()
    reset_breakers()


@pytest.fixture
def obs_on():
    """The port's telemetry on and empty for the test, off and empty after."""
    from repro_torch import obs
    from repro_torch.obs import metrics, recorder, trace

    prev = obs.set_enabled(True)
    trace.clear()
    metrics.reset()
    recorder.clear()
    yield metrics, recorder
    trace.clear()
    metrics.reset()
    recorder.clear()
    obs.set_enabled(prev)


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same_values(a, b) -> bool:
    """Bit-equal, a NaN matching any NaN (its bits are the route's)."""
    a, b = _np(a), _np(b)
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)
                and np.array_equal(a[~na].view(np.int32), b[~nb].view(np.int32)))


# ---------------------------------------------------------------------------
# failpoints
# ---------------------------------------------------------------------------


def test_failpoint_triggers():
    with failpoints({"a": "once"}):
        with pytest.raises(FailpointError):
            failpoint("a")
        failpoint("a")
        assert hits("a") == 2 and fires("a") == 1
    with failpoints({"b": "times:2"}):
        for _ in range(2):
            with pytest.raises(FailpointError):
                failpoint("b")
        failpoint("b")
    with failpoints({"c": "every:3"}):
        failpoint("c")
        failpoint("c")
        with pytest.raises(FailpointError):
            failpoint("c")
        assert fires("c") == 1
    with failpoints({"d": "off"}):
        failpoint("d")
        assert hits("d") == 1 and fires("d") == 0
    with failpoints({"e": "always"}):
        for _ in range(3):
            with pytest.raises(FailpointError):
                failpoint("e")
    for bad in ("sometimes", "times:0", "p:1.5", "every:x"):
        with pytest.raises(ValueError):
            arm("f", bad)


@pytest.mark.parametrize("spec", ["p:0.5:7", "p:0.2:7", "p:0.25:13", "p:0.3"])
def test_seeded_trigger_fires_on_the_reference_hits(spec):
    """One draw of ``random.Random(seed)`` a hit: the port fires on the
    same hits as the reference, run after run."""
    def pattern(fp, ctx, err):
        out = []
        with ctx({"p": spec}):
            for _ in range(64):
                try:
                    fp("p.x")
                    out.append(0)
                except err:
                    out.append(1)
        return out

    got = pattern(failpoint, failpoints, FailpointError)
    assert got == pattern(failpoint, failpoints, FailpointError)
    assert got == pattern(j_failpoints.failpoint, j_failpoints.failpoints,
                          j_failpoints.FailpointError)
    assert 0 < sum(got) < 64


def test_failpoint_hierarchical_prefix_match():
    with failpoints({"kernel.launch": "always"}):
        with pytest.raises(FailpointError):
            failpoint("kernel.launch.sort")
        failpoint("kernel.launcher")  # not a dot-boundary match
    with failpoints({"k": "always", "k.x": "off"}):  # exact wins over a prefix
        failpoint("k.x")
        failpoint("k.x.y")  # the longest armed prefix
        with pytest.raises(FailpointError):
            failpoint("k.y")


def test_failpoint_error_carries_name():
    with failpoints({"seam": "always"}):
        with pytest.raises(FailpointError) as ei:
            failpoint("seam.child")
    assert ei.value.name == "seam.child" and isinstance(ei.value, RuntimeError)


def test_failpoints_context_restores_previous_arming():
    arm("outer", "times:2")
    with pytest.raises(FailpointError):
        failpoint("outer")
    with failpoints({"outer": "off", "inner": "always"}):
        failpoint("outer")
        with failpoints({"inner": "off"}):
            failpoint("inner")
        with pytest.raises(FailpointError):
            failpoint("inner")
    with pytest.raises(FailpointError):  # the outer arming's second fire
        failpoint("outer")
    failpoint("outer")
    assert hits("outer") == 3 and fires("outer") == 2
    failpoint("inner")  # the context's arming is gone


def test_failpoints_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FAILPOINTS", "cache.load=always, sched=p:0.5:3,x")
    t_failpoints._parse_env()
    assert t_failpoints.active() == {"cache.load": "always", "sched": "p", "x": "once"}
    with pytest.raises(FailpointError):
        failpoint("x")
    failpoint("x")


def test_fire_counts_and_events(obs_on):
    metrics, recorder = obs_on
    with failpoints({"kernel.launch": "times:2"}):
        for _ in range(3):
            try:
                failpoint("kernel.launch.sort")
            except FailpointError:
                pass
    assert metrics.counter("failpoints.fired").value(name="kernel.launch") == 2
    evs = [e for e in recorder.events() if e.kind == "failpoint"]
    assert [(e.name, e.attrs["armed_as"], e.attrs["fire"]) for e in evs] == [
        ("kernel.launch.sort", "kernel.launch", 1), ("kernel.launch.sort", "kernel.launch", 2)]


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


def _drive(br, calls):
    out = []
    for c in calls:
        if c == "fail":
            br.record_failure()
        elif c == "ok":
            br.record_success()
        else:
            out.append(getattr(br, c)())
        out.append((br.state, br.failures))
    return out


def test_breaker_matches_reference_on_one_sequence():
    """Open after the threshold, the half-open probe (cooldown 0), one
    probe at a time, close on success, reopen on a failed probe."""
    calls = (["fail", "allow"] * 3 + ["allow", "allow", "peek", "ok", "allow"]
             + ["fail"] * 3 + ["peek", "allow", "allow", "fail", "allow", "ok", "fail", "ok"])
    got = _drive(CircuitBreaker(("op", "rung", "cls"), threshold=3, cooldown_s=0.0), calls)
    want = _drive(j_breaker.CircuitBreaker(("op", "rung", "cls"), threshold=3,
                                           cooldown_s=0.0), calls)
    assert got == want
    assert ("half_open", 3) in got and ("open", 4) in got


def test_breaker_cooldown_on_a_faked_clock(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(t_breaker, "now", lambda: clock[0])
    br = CircuitBreaker(("op", "rung", "cls"), threshold=1, cooldown_s=30.0)
    br.record_failure()
    assert br.state == "open" and not br.allow() and not br.peek()
    clock[0] += 29.9
    assert not br.allow()
    clock[0] += 0.1
    assert br.peek() and br.state == "open"  # peek never takes the probe
    assert br.allow() and br.state == "half_open"
    assert not br.allow() and not br.peek()  # one probe in flight
    br.record_failure()  # the probe failed: another cooldown from now
    assert br.state == "open" and br.opened_at == 130.0
    clock[0] += 30.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.failures == 0


def test_registry_configure_reset_and_shape_class():
    for total, pay in ((0, False), (1, True), (7, False), (64, True), (65, False),
                       (151_936, False)):
        assert t_breaker.shape_class(total, pay) == j_breaker.shape_class(total, pay)
    assert breaker_states() == {} and not t_breaker.any_breakers()
    assert t_breaker.rung_allowed("merge", "cuda", "64v")
    assert breaker_states() == {}  # the plan-time check makes no breaker
    configure_breakers(threshold=2, cooldown_s=5.0)
    br = breaker_for("merge", "cuda", "64v")
    assert (br.threshold, br.cooldown_s) == (2, 5.0)
    br.record_failure()
    br.record_failure()
    assert breaker_states() == {("merge", "cuda", "64v"): "open"}
    assert not t_breaker.rung_allowed("merge", "cuda", "64v")
    reset_breakers()
    assert breaker_states() == {}
    assert breaker_for("merge", "cuda", "64v").threshold == t_breaker.DEFAULT_THRESHOLD


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

_RUNG_SPECS = [
    dict(op="merge", lengths=(32, 32)),
    dict(op="merge", lengths=(7, 5)),
    dict(op="merge", lengths=(100_000, 100_000)),
    dict(op="merge", lengths=(32, 32), has_payload=True),
    dict(op="merge", lengths=(32, 32), stable=True),
    dict(op="merge_k", lengths=(64,) * 4),
    dict(op="merge_k", lengths=(64,) * 4, has_payload=True),
    dict(op="sort", lengths=(1024,), batch=8),
    dict(op="sort", lengths=(1024,), batch=8, has_payload=True),
    dict(op="sort", lengths=(1024,), stable=True),
    dict(op="topk", lengths=(256,), k=8),
    dict(op="topk", lengths=(151_936,), k=64, has_payload=True),
    dict(op="topk", lengths=(256,), k=8, stable=True),
    dict(op="median", lengths=(7, 7, 7)),
    dict(op="median", lengths=(7, 5, 3)),
]


@pytest.mark.parametrize("kw", _RUNG_SPECS, ids=lambda kw: f"{kw['op']}{kw['lengths'][:2]}")
def test_rungs_for_matches_reference(kw):
    """Auto asks from every planned backend, and explicit asks, against
    the reference's ``rungs_for`` (``pallas`` named ``cuda``)."""
    from repro.api.dispatch import Decision as JDecision

    def ref_name(b):
        return "pallas" if b == "cuda" else b

    for backend in ("cuda", "schedule", "streaming", "lax"):
        for ask in ("auto", backend):
            spec, jspec = SortSpec(backend=ask, **kw), JSpec(backend=ref_name(ask), **kw)
            got = rungs_for(spec, Decision(backend))
            want = j_ladder.rungs_for(jspec, JDecision(ref_name(backend)))
            assert got == [("cuda" if r == "pallas" else r) for r in want], (backend, ask)
            assert got[-1] in ("lax", "schedule", backend) and len(set(got)) == len(got)


def _merge_inputs(rows=2, n=64):
    x = np.random.default_rng(0).standard_normal((rows, n)).astype(np.float32)
    h = n // 2
    a, b = np.sort(x[:, :h], -1), np.sort(x[:, h:], -1)
    return torch.from_numpy(a), torch.from_numpy(b), np.sort(x, -1)


ALL = {"executor.run": "always", "kernel.launch": "always", "fused.launch": "always"}


def test_ladder_degrades_to_the_same_values():
    """Every seam of every op armed: each call still answers, the values
    bit-equal to the healthy call's, and the failed rungs fed breakers."""
    a, b, ref = _merge_inputs()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 96)).astype(np.float32))
    lists = [torch.sort(torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32)))[0]
             for _ in range(3)]
    calls = {
        "merge": lambda: repro_torch.merge(a, b),
        "merge_k": lambda: repro_torch.merge_k(lists),
        "sort": lambda: repro_torch.sort(x),
        "sort_payload": lambda: repro_torch.sort(x, payload=x * 2)[1],
        "topk": lambda: repro_torch.topk(x, 5)[0],
        "median": lambda: repro_torch.median_of_lists(lists),
    }
    healthy = {name: fn() for name, fn in calls.items()}
    np.testing.assert_array_equal(healthy["merge"].numpy(), ref)
    with failpoints(ALL):
        for name, fn in calls.items():
            assert _same_values(fn(), healthy[name]), name
    got = breaker_states()
    assert {(op, rung) for op, rung, _ in got} == {
        ("merge", "fused"), ("merge_k", "fused"), ("merge_k", "cuda"), ("sort", "fused"),
        ("sort", "cuda"), ("sort", "schedule"), ("topk", "fused"), ("topk", "cuda"),
        ("topk", "schedule"), ("median", "cuda"), ("median", "schedule")}
    assert set(got.values()) == {"closed"}  # one failure each, under the threshold


def test_ladder_explicit_backend_ask_propagates():
    a, b, _ = _merge_inputs()
    with failpoints({"executor.run": "always"}):
        with pytest.raises(FailpointError):
            repro_torch.merge(a, b, backend="schedule")
    with failpoints({"fused.launch": "always"}):
        with pytest.raises(FailpointError):
            repro_torch.merge(a, b, backend="cuda")
    assert breaker_states() == {}  # explicit asks never feed breakers


def test_ladder_disabled_propagates_first_rung_failure(monkeypatch):
    a, b, _ = _merge_inputs()
    prev = set_resilience_enabled(False)
    try:
        with failpoints({"fused.launch": "always"}):
            with pytest.raises(FailpointError):
                repro_torch.merge(a, b)
    finally:
        set_resilience_enabled(prev)
    monkeypatch.setenv("REPRO_RESILIENCE", "0")
    with failpoints({"fused.launch.sort": "always"}):
        with pytest.raises(FailpointError):
            repro_torch.sort(a)
    assert breaker_states() == {}


def test_ladder_exhaustion_chains_last_error(monkeypatch):
    spec = SortSpec(op="merge", lengths=(8, 8))

    def attempt(rung):
        raise RuntimeError(f"boom {rung}")

    with pytest.raises(ResilienceExhausted) as ei:
        run_ladder(spec, ["schedule", "lax"], attempt)
    assert "boom lax" in str(ei.value.__cause__) and ei.value.rungs == ("schedule", "lax")
    # every rung of a real call failing: the sort's ladder ends at lax
    from repro_torch.api import registry

    def failing_lax(*args, **kw):
        raise MemoryError("lax")

    monkeypatch.setitem(registry.get_backend("lax").run, "sort", failing_lax)
    with failpoints(ALL):
        with pytest.raises(ResilienceExhausted) as ei:
            repro_torch.sort(torch.randn(2, 16))
    assert ei.value.rungs == ("fused", "cuda", "schedule", "lax")
    assert isinstance(ei.value.__cause__, MemoryError)


def test_ladder_skip_is_not_a_failure():
    spec = SortSpec(op="merge", lengths=(8, 8))
    seen = []

    def attempt(rung):
        seen.append(rung)
        if rung == "fused":
            raise LadderSkip
        return rung

    assert run_ladder(spec, ["fused", "schedule"], attempt) == "schedule"
    assert seen == ["fused", "schedule"] and breaker_states() == {}
    # a call every rung declines raises it (a ValueError, as before)
    with pytest.raises(ValueError):
        repro_torch.median_of_lists([torch.zeros(4), torch.zeros(4)], backend="schedule")


def test_ladder_forces_last_rung_when_all_blocked():
    spec = SortSpec(op="merge", lengths=(8, 8))
    configure_breakers(threshold=1, cooldown_s=3600.0)
    for rung in ("schedule", "lax"):
        breaker_for("merge", rung, "16v").record_failure()
    assert run_ladder(spec, ["schedule", "lax"], lambda r: f"ran {r}", cls="16v") == "ran lax"


def test_resilience_events_carry_op_rung_class_labels(obs_on):
    metrics, recorder = obs_on
    configure_breakers(threshold=1, cooldown_s=3600.0)
    spec = SortSpec(op="merge", lengths=(8, 8))

    def failing(rung):
        if rung == "schedule":
            raise RuntimeError("boom")
        return rung

    assert run_ladder(spec, ["schedule", "lax"], failing, cls="16v") == "lax"
    assert metrics.counter("resilience.fallbacks").value(
        op="merge", rung="schedule", cls="16v", err="RuntimeError") == 1
    assert metrics.counter("breaker.transitions").value(
        op="merge", rung="schedule", cls="16v", frm="closed", to="open") == 1
    assert metrics.gauge("breaker.state").value(op="merge", rung="schedule", cls="16v") == 1
    breaker_for("merge", "lax", "16v").record_failure()
    assert run_ladder(spec, ["schedule", "lax"], lambda r: f"ran {r}", cls="16v") == "ran lax"
    assert metrics.counter("resilience.forced").value(op="merge", rung="lax", cls="16v") == 1
    by_kind = {}
    for ev in recorder.events():
        by_kind.setdefault(ev.kind, []).append(ev)
    assert [e.name for e in by_kind["fallback"]] == ["merge/schedule/16v"]
    assert by_kind["fallback"][0].attrs["err"] == "RuntimeError"
    assert [e.name for e in by_kind["forced"]] == ["merge/lax/16v"]
    assert {e.name for e in by_kind["breaker"]} == {"merge/schedule/16v", "merge/lax/16v"}
    assert by_kind["breaker"][0].attrs["to"] == "open"


def test_open_breaker_reroutes_at_plan_time(monkeypatch):
    """Both kernel rungs of a sort failing: after the threshold their
    breakers open, the plan moves to the schedule executor
    (``source="breaker"``), and the half-open probe after the cooldown
    gives the kernels back."""
    clock = [0.0]
    monkeypatch.setattr(t_breaker, "now", lambda: clock[0])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32))
    want = repro_torch.sort(x)
    spec = SortSpec(op="sort", lengths=(64,), batch=4)
    with failpoints({"fused.launch.sort": "always", "kernel.launch.sort": "always"}):
        for _ in range(3):
            assert repro_torch.plan(spec).source == "rule"
            assert _same_values(repro_torch.sort(x), want)
        assert breaker_states() == {("sort", "fused", "64v"): "open",
                                    ("sort", "cuda", "64v"): "open"}
        dec = repro_torch.plan(spec)
        assert (dec.backend, dec.source, dec.detail) == ("schedule", "breaker", "degraded")
        assert hits("fused.launch.sort") == 3  # open: the kernels are no longer tried
        assert _same_values(repro_torch.sort(x), want)
        assert hits("fused.launch.sort") == 3
    clock[0] += t_breaker.DEFAULT_COOLDOWN_S
    assert repro_torch.plan(spec).source == "rule"  # peek: the probe may run
    assert _same_values(repro_torch.sort(x), want)  # the probe succeeds
    assert breaker_states()[("sort", "fused", "64v")] == "closed"


def test_segmented_degrade_unit():
    """The synthetic ``segmented_kernel`` rung: a failed kernel path is
    answered by the per-segment plain version and feeds the breaker; an
    open breaker skips the kernel path."""
    from repro_torch.api.ops import _segmented_degrade
    from repro_torch.resilience.ladder import spec_class

    spec = SortSpec(op="sort", lengths=(16,), segment_offsets=((0, 7, 16),))
    calls = []

    def call(use_kernel):
        calls.append(use_kernel)
        if use_kernel:
            raise RuntimeError("kernel boom")
        return "ref"

    assert _segmented_degrade(spec, call) == "ref" and calls == [True, False]
    key = ("sort", "segmented_kernel", spec_class(spec))
    assert key in breaker_states()
    _segmented_degrade(spec, call)
    _segmented_degrade(spec, call)  # the third failure opens the breaker
    calls.clear()
    assert _segmented_degrade(spec, call) == "ref" and calls == [False]
    explicit = SortSpec(op="sort", lengths=(16,), segment_offsets=((0, 7, 16),),
                        backend="segmented")
    with pytest.raises(RuntimeError):
        _segmented_degrade(explicit, call)


@pytest.mark.parametrize("device,err,degrades", [
    ("cpu", RuntimeError("kernel boom"), True),
    ("cpu", FailpointError("fused.launch.sort"), True),
    ("cuda:0", RuntimeError("kernel boom"), False),
    ("cuda:0", FailpointError("fused.launch.sort"), True),
])
def test_only_injected_faults_degrade_on_the_card(device, err, degrades):
    """Off the card every rung is a plain version, so any error degrades;
    on the card only an injected fault does: a real error of a kernel
    rung (a build, launch or allocation failure) propagates, feeds no
    breaker and is never answered by a slower rung. The same rule holds
    for the segmented fall-back. No card is needed: the rule reads the
    device only."""
    from repro_torch.api.ops import _segmented_degrade

    spec = SortSpec(op="sort", lengths=(16,))

    def attempt(rung):
        if rung == "fused":
            raise err
        return rung

    def call(use_kernel):
        if use_kernel:
            raise err
        return "ref"

    seg = SortSpec(op="sort", lengths=(16,), segment_offsets=((0, 7, 16),))
    dev = torch.device(device)
    if degrades:
        assert run_ladder(spec, ["fused", "schedule"], attempt, device=dev) == "schedule"
        assert _segmented_degrade(seg, call, dev) == "ref"
        assert len(breaker_states()) == 2
    else:
        with pytest.raises(type(err)):
            run_ladder(spec, ["fused", "schedule"], attempt, device=dev)
        with pytest.raises(type(err)):
            _segmented_degrade(seg, call, dev)
        assert breaker_states() == {}


def _tied(rng, n, dtype=torch.float32):
    x = np.round(rng.standard_normal(n) * 4).astype(np.float32) / 4 + np.float32(0)
    return torch.from_numpy(x).to(dtype)  # no -0.0: torch.sort would not order it


def test_segment_ops_answer_under_spill_faults():
    """Segments past the class width spill; a spill fault sends each op
    to the per-segment plain version: the values bit-equal to the
    healthy call and to the reference's."""
    rng = np.random.default_rng(3)
    offs = (0, 5, 12, 12, 1500, 1520)
    v = _tied(rng, 1520)
    pay = torch.arange(1520, dtype=torch.int32)
    a, b = torch.sort(_tied(rng, 1300))[0], torch.sort(_tied(rng, 900))[0]
    oa, ob = (0, 4, 1300), (0, 100, 900)
    a = torch.cat([torch.sort(a[:4])[0], torch.sort(a[4:])[0]])
    b = torch.cat([torch.sort(b[:100])[0], torch.sort(b[100:])[0]])
    calls = {
        "sort": lambda: repro_torch.segment_sort(v, offs),
        "sort_payload": lambda: repro_torch.segment_sort(v, offs, payload=pay)[0],
        "topk": lambda: repro_torch.segment_topk(v, offs, 9)[0],
        "merge": lambda: repro_torch.segment_merge(a, b, oa, ob)[0],
        "argmax": lambda: repro_torch.segment_argmax(v, offs)[0],
    }
    healthy = {n: fn() for n, fn in calls.items()}
    np.testing.assert_array_equal(
        healthy["sort"].numpy(), np.asarray(repro.segment_sort(jnp.asarray(v.numpy()), offs)))
    with failpoints({"segmented.spill": "always", "grid_merge.refill": "always"}):
        for name, fn in calls.items():
            assert _same_values(fn(), healthy[name]), name
    assert {(op, rung) for op, rung, _ in breaker_states()} == {
        ("sort", "segmented_kernel"), ("topk", "segmented_kernel"),
        ("merge", "segmented_kernel")}
    with failpoints({"segmented.spill": "always"}):
        with pytest.raises(FailpointError):
            repro_torch.segment_sort(v, offs, backend="segmented")


def test_segmented_fallback_tie_order():
    """The segment ops' fallback on tied bf16 rows (±0.0, ±inf, NaN): a
    sort's values and payload come out as the class path's (both order
    ties by position); a top-k's values too, but its ties in the
    per-segment version's order (ascending position), not the class
    kernels'."""
    rng = np.random.default_rng(0)
    offs = (0, 5, 12, 12, 40, 1500, 1530)
    v, _ = _tied_rows(rng, (1530,))
    pay = torch.arange(1530, dtype=torch.int32)

    def run():
        return (repro_torch.segment_sort(v, offs, payload=pay),
                repro_torch.segment_topk(v, offs, 9, payload=pay))

    (hs, hp), (hv, hi, hpp, ho) = run()
    with failpoints({"segmented.spill": "always"}):
        (ds, dp), (dv, di, dpp, do) = run()
    assert {rung for _, rung, _ in breaker_states()} == {"segmented_kernel"}
    assert _same_values(ds, hs) and torch.equal(dp, hp)
    assert _same_values(dv, hv) and ho == do and torch.equal(dpp, pay[di.long() + torch.cat(
        [torch.full((c,), o) for o, c in zip(offs, np.diff(ho))])])
    assert not torch.equal(di, hi)
    for lo, hi_ in zip(ho, ho[1:]):  # ties by ascending position in each segment
        seg_v, seg_i = _np(dv[lo:hi_]), di[lo:hi_].numpy()
        for j in range(len(seg_i) - 1):
            if _same_values(seg_v[j:j + 1], seg_v[j + 1:j + 2]):
                assert seg_i[j] < seg_i[j + 1]


def test_seams_armed_off_change_nothing(obs_on):
    """Every seam armed ``off``: each is reached (its hits count), and the
    results and every counter the calls record stay as they were."""
    metrics, _ = obs_on
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 96)).astype(np.float32))
    a, b, _ = _merge_inputs()
    offs = (0, 5, 1500)
    v = _tied(rng, 1500)

    def run():
        return (repro_torch.sort(x), repro_torch.topk(x, 7)[1], repro_torch.merge(a, b),
                repro_torch.sort(x, stable=True), repro_torch.segment_sort(v, offs),
                repro_torch.chunked_merge(a, b))

    healthy = run()
    snap = metrics.snapshot()
    metrics.reset()
    names = ("kernel.launch", "fused.launch", "executor.run", "segmented.spill",
             "grid_merge.refill", "cache")
    with failpoints({n: "off" for n in names}):
        armed = run()
        reached = {n: hits(n) for n in names}
    assert metrics.snapshot() == snap
    for h, g in zip(healthy, armed):
        assert _same_values(h, g)
    assert reached == {"kernel.launch": 0, "fused.launch": 3, "executor.run": 1,
                       "segmented.spill": 1, "grid_merge.refill": 3, "cache": 0}


# ---------------------------------------------------------------------------
# the autotune cache
# ---------------------------------------------------------------------------


def test_cache_quarantines_corrupt_json(tmp_path):
    from repro_torch.streaming.cache import AutotuneCache

    path = str(tmp_path / "autotune.json")
    with open(path, "w") as f:
        f.write('{"torn": ')
    c = AutotuneCache(path=path)
    assert len(c) == 0
    assert os.path.exists(path + ".bad") and not os.path.exists(path)
    c.put("merge|8x8|k-|float32|cpu", {"block_batch": 8})
    assert AutotuneCache(path=path).get("merge|8x8|k-|float32|cpu") is not None


def test_cache_concurrent_writers_merge(tmp_path):
    from repro_torch.streaming.cache import AutotuneCache

    path = str(tmp_path / "autotune.json")
    c1, c2 = AutotuneCache(path=path), AutotuneCache(path=path)
    c1.put("k1", {"v": 1})
    c2.put("k2", {"v": 2})  # must not clobber c1's entry
    c3 = AutotuneCache(path=path)
    assert c3.get("k1") is not None and c3.get("k2") is not None


def test_cache_store_failure_degrades_to_memory(tmp_path, obs_on):
    from repro_torch.streaming.cache import AutotuneCache

    metrics, _ = obs_on
    c = AutotuneCache(path=str(tmp_path / "autotune.json"))
    with failpoints({"cache.store": "always"}):
        c.put("k|x", {"v": 1})  # must not raise
    assert c.get("k|x") is not None
    assert AutotuneCache(path=c.path).get("k|x") is None  # never reached the disk
    assert metrics.counter("autotune.cache").value(op="k", result="store_failed") == 1
    c.put("k2", {"v": 2})
    assert AutotuneCache(path=c.path).get("k|x") is not None  # flushed now


def test_cache_load_failure_starts_empty(tmp_path, obs_on):
    from repro_torch.streaming.cache import AutotuneCache

    metrics, _ = obs_on
    path = str(tmp_path / "autotune.json")
    AutotuneCache(path=path).put("k", {"v": 1})
    with failpoints({"cache.load": "always"}):
        c = AutotuneCache(path=path)
    assert len(c) == 0
    assert os.path.exists(path) and not os.path.exists(path + ".bad")  # not corruption
    assert metrics.counter("autotune.cache").value(op="-", result="load_failed") == 1


def test_grid_merge_refill_seam():
    """The streaming rung's seam: a merge past the routing budget runs the
    grid merge; with its refill failing, the schedule executor answers
    the same values, and an explicit streaming ask raises."""
    from repro_torch.streaming.grid_merge import grid_chunked_merge2

    a, b, ref = _merge_inputs(n=8192)
    assert repro_torch.plan(SortSpec(op="merge", lengths=(4096, 4096), batch=2)).backend \
        == "streaming"
    with failpoints({"grid_merge.refill": "always"}):
        with pytest.raises(FailpointError):
            grid_chunked_merge2(a, b)
        with pytest.raises(FailpointError):
            repro_torch.merge(a, b, backend="streaming")
        np.testing.assert_array_equal(repro_torch.merge(a, b).numpy(), ref)
    assert set(breaker_states()) == {("merge", "streaming", "8192v")}


# ---------------------------------------------------------------------------
# the scheduler under failure
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_init

    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), dtype="float32")
    return cfg, model_init(torch.Generator().manual_seed(0), cfg, "cpu")


def _specs():
    from repro_torch.serving.scheduler import SamplingParams

    return [(5, SamplingParams(k=8, temperature=1.0, max_new_tokens=5, seed=11), 0),
            (9, SamplingParams(k=1, temperature=1.0, max_new_tokens=4, seed=33), 0),
            (3, SamplingParams(k=4, top_p=0.9, temperature=0.7, max_new_tokens=4,
                               seed=22), 1)]


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n, _, _ in _specs()]


def _engine(cfg, params, **kw):
    from repro_torch.serving.scheduler import ScheduledEngine, SchedulerConfig

    kw.setdefault("retry_backoff_s", 0.0)
    kw.setdefault("n_slots", 2)
    return ScheduledEngine(params, cfg, SchedulerConfig(page_size=8, pages_per_slot=4, **kw),
                           device="cpu")


def _drain_invariants(eng):
    from repro_torch.serving.scheduler import TERMINAL_STATES

    assert all(r.state in TERMINAL_STATES for r in eng.requests.values())
    assert not len(eng.queue) and not eng.active
    assert eng.slots.free_slot_count == eng.sc.n_slots, "leaked slot"
    assert eng.slots.free_page_count == eng.pool.n_pages - 1, "leaked pages"


def _submit_all(eng, cfg):
    return [eng.submit(p, sp, arrival=a) for p, (_, sp, a) in zip(_prompts(cfg), _specs())]


@pytest.fixture(scope="module")
def oracle(model):
    cfg, params = model
    eng = _engine(cfg, params)
    rids = _submit_all(eng, cfg)
    out = eng.run()
    return [out[r] for r in rids]


def test_transient_faults_retry_to_completion(model, oracle, obs_on):
    metrics, _ = obs_on
    cfg, params = model
    eng = _engine(cfg, params)
    rids = _submit_all(eng, cfg)
    with failpoints({"sched.prefill": "once", "sched.insert": "once", "sched.decode": "once"}):
        out = eng.run()
    _drain_invariants(eng)
    for rid, want in zip(rids, oracle):
        np.testing.assert_array_equal(out[rid], want)
    assert {w: metrics.counter("sched.retries").value(what=w)
            for w in ("prefill", "insert", "decode")} == {"prefill": 1, "insert": 1,
                                                          "decode": 1}


def test_persistent_prefill_fault_fails_and_drains(model):
    from repro_torch.serving.scheduler import RequestState

    cfg, params = model
    eng = _engine(cfg, params, max_retries=1)
    rids = _submit_all(eng, cfg)
    with failpoints({"sched.prefill": "always"}):
        out = eng.run()
    _drain_invariants(eng)
    assert out == {}
    for rid in rids:
        r = eng.requests[rid]
        assert r.state is RequestState.FAILED and "prefill" in r.error


def test_persistent_decode_fault_fails_active_and_drains(model):
    from repro_torch.serving.scheduler import RequestState

    cfg, params = model
    eng = _engine(cfg, params, max_retries=0)
    _submit_all(eng, cfg)
    with failpoints({"sched.decode": "always"}):
        eng.run()
    _drain_invariants(eng)
    states = {r.state for r in eng.requests.values()}
    assert states <= {RequestState.FAILED, RequestState.DONE}
    assert RequestState.FAILED in states


@pytest.mark.parametrize("spec,retries", [("p:0.25:13", 1), ("p:0.2:7", 50)])
def test_seeded_chaos_drains_and_matches_the_fault_free_drain(model, oracle, spec, retries):
    """Seeded faults on every scheduler seam: the engine drains with no
    leak, and every completed stream is the fault-free one (with retries
    enough, all complete)."""
    cfg, params = model
    eng = _engine(cfg, params, max_retries=retries)
    rids = _submit_all(eng, cfg)
    with failpoints({"sched": spec}):
        out = eng.run()
        fired = fires("sched")
    _drain_invariants(eng)
    assert fired > 0
    for rid, want in zip(rids, oracle):
        if rid in out:
            np.testing.assert_array_equal(out[rid], want)
    if retries == 50:
        assert sorted(out) == sorted(rids)


def test_ttl_ticks_times_out_running_request(model):
    from repro_torch.serving.scheduler import RequestState, SamplingParams

    cfg, params = model
    eng = _engine(cfg, params)
    prompt = _prompts(cfg)[0]
    rid_t = eng.submit(prompt, SamplingParams(k=8, max_new_tokens=12, seed=1, ttl_ticks=2),
                       arrival=0)
    rid_ok = eng.submit(prompt, SamplingParams(k=8, max_new_tokens=3, seed=2), arrival=0)
    out = eng.run()
    _drain_invariants(eng)
    r = eng.requests[rid_t]
    assert r.state is RequestState.TIMED_OUT and rid_t not in out
    assert 0 < len(r.tokens) < 12
    solo = _engine(cfg, params)
    rid = solo.submit(prompt, SamplingParams(k=8, max_new_tokens=3, seed=2), arrival=0)
    np.testing.assert_array_equal(out[rid_ok], solo.run()[rid])


def test_ttl_ticks_times_out_queued_request(model):
    from repro_torch.serving.scheduler import RequestState, SamplingParams

    cfg, params = model
    eng = _engine(cfg, params, n_slots=1)
    prompt = _prompts(cfg)[0]
    blocker = eng.submit(prompt, SamplingParams(max_new_tokens=8, seed=5), arrival=0)
    rid = eng.submit(prompt, SamplingParams(max_new_tokens=2, ttl_ticks=2), arrival=0)
    out = eng.run()
    _drain_invariants(eng)
    r = eng.requests[rid]
    assert r.state is RequestState.TIMED_OUT and r.slot is None and not r.tokens
    assert blocker in out and len(out[blocker]) == 8


def test_queue_full_rejects_with_retry_hint(model):
    from repro_torch.serving.scheduler import QueueFull, RequestState, SamplingParams

    cfg, params = model
    eng = _engine(cfg, params, max_queue=2)
    prompt = _prompts(cfg)[0]
    eng.submit(prompt, SamplingParams(max_new_tokens=2), arrival=0)
    eng.submit(prompt, SamplingParams(max_new_tokens=2), arrival=0)
    with pytest.raises(QueueFull) as ei:
        eng.submit(prompt, SamplingParams(max_new_tokens=2), arrival=0)
    assert ei.value.depth == 2 and ei.value.max_queue == 2 and ei.value.retry_after_ticks >= 1
    rejected = [r for r in eng.requests.values() if r.state is RequestState.REJECTED]
    assert len(rejected) == 1 and "full" in rejected[0].error
    assert len(eng.run()) == 2
    _drain_invariants(eng)


# ---------------------------------------------------------------------------
# the tie order: each rung against the reference's, and across rungs
# ---------------------------------------------------------------------------

_POOL = np.array([-1.5, -0.0, 0.0, 0.5, 2.0, np.inf, -np.inf, np.nan], np.float32)
_ORDER = np.array([1, 2, 3, 4, 5, 6, 0, 7])  # each pool value's rank in the key order


def _tied_rows(rng, shape, sort=False):
    """bf16 rows of eight values (±0.0, ±inf, NaN among them), so ties
    everywhere; ``sort``: ascending in the total key order."""
    idx = rng.integers(0, len(_POOL), shape)
    if sort:
        idx = np.take_along_axis(idx, np.argsort(_ORDER[idx], axis=-1, kind="stable"), -1)
    x = _POOL[idx]
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def tied():
    rng = np.random.default_rng(0)
    x, jx = _tied_rows(rng, (4, 64))
    lists = [_tied_rows(rng, (4, 32), sort=True) for _ in range(3)]
    pos = np.arange(4 * 96, dtype=np.int32).reshape(4, 96)
    return x, jx, lists, pos


F, K, E = {"fused.launch": "always"}, {"kernel.launch": "always"}, {"executor.run": "always"}
G = {"grid_merge.refill": "always"}

#: per op: the rung that answers under each arming (the ladder's walk)
_LADDERS = {
    "sort+payload": {"fused": {}, "schedule": F, "lax": {**F, **E}},
    "topk": {"fused": {}, "cuda": F, "schedule": {**F, **K}, "lax": {**F, **K, **E}},
    "merge+payload": {"fused": {}, "schedule": F, "lax": {**F, **E}},
    "merge_k+payload": {"fused": {}, "schedule": F, "lax": {**F, **E}},
    "sort": {"fused": {}, "cuda": F, "schedule": {**F, **K}, "lax": {**F, **K, **E}},
    "merge": {"fused": {}, "cuda": F},  # the unfused merge adapter has no seam
    "merge_k": {"fused": {}, "cuda": F, "streaming": {**F, **K}},
}

#: the measured finding: rungs grouped by equal tie order (indices,
#: permutations, payload lanes) on the ``tied`` rows
_TIE_GROUPS = {
    "sort+payload": [["fused", "lax"], ["schedule"]],
    "topk": [["fused", "cuda"], ["schedule"], ["lax"]],
    "merge+payload": [["fused"], ["schedule"], ["lax"]],
    "merge_k+payload": [["fused", "schedule"], ["lax"]],
    "sort": [["fused", "cuda", "schedule", "lax"]],  # values only: no order to see
    "merge": [["fused", "cuda"]],
    "merge_k": [["fused", "cuda", "streaming"]],
}


def _port_call(op, tied):
    x, _, lists, pos = tied
    tp = torch.from_numpy(pos)
    (a, _), (b, _), (c, _) = lists
    if op == "sort+payload":
        return lambda: repro_torch.sort(x, payload=tp[:, :64])
    if op == "topk":
        return lambda: repro_torch.topk(x, 16)
    if op == "merge+payload":
        return lambda: repro_torch.merge(a, b, payload=(tp[:, :32], tp[:, 32:64]))
    if op == "merge_k+payload":
        return lambda: repro_torch.merge_k([a, b, c], payload=[tp[:, :32], tp[:, 32:64],
                                                               tp[:, 64:]])
    if op == "sort":
        return lambda: (repro_torch.sort(x), tp)
    if op == "merge":
        return lambda: (repro_torch.merge(a, b), tp)
    return lambda: (repro_torch.merge_k([a, b, c]), tp)


@pytest.mark.parametrize("op", list(_LADDERS))
def test_tie_order_across_rungs(op, tied):
    """Each arming makes the ladder answer from the named rung (the failed
    rungs' breakers say so); the values are the same on every rung, the
    tie order is the answering rung's, grouped as measured."""
    fn = _port_call(op, tied)
    out = {}
    for rung, armed in _LADDERS[op].items():
        reset_breakers()
        with failpoints(armed):
            out[rung] = fn()
        failed = {r for _, r, _ in breaker_states()}
        order = list(_LADDERS[op])
        assert failed == set(order[:order.index(rung)]), (rung, failed)
    first = out["fused"]
    groups = []
    for rung, (vals, order) in out.items():
        assert _same_values(vals, first[0]), rung
        for g in groups:
            if np.array_equal(_np(out[g[0]][1]), _np(order)):
                g.append(rung)
                break
        else:
            groups.append([rung])
    assert groups == _TIE_GROUPS[op]


def _jit(fn, *arrays, **static):
    """The reference's call ``fn(*arrays, **static)`` under one ``jax.jit``:
    one compile of the whole network where eager dispatch compiles op
    after op; the compares and selects give the same bits either way."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


@pytest.mark.parametrize("rung", ["fused", "cuda", "schedule", "lax"])
def test_tie_order_each_rung_matches_the_reference(rung, tied):
    """The port's fused, cuda, schedule and lax rungs against the
    reference's same rungs, pinned on both sides: values (a NaN as a
    NaN) and the tie order bit-equal."""
    from repro.api import fused as jf
    from repro.api.fused import fused_topk as j_fused_topk
    from repro.api.keys import encode_keys as j_encode
    from repro.api.registry import get_backend as j_get_backend
    from repro_torch.api.fused import fused_cfg_for, fused_merge_k, fused_sort

    x, jx, lists, pos = tied
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    (a, ja), (b, jb), (c, jc) = lists

    def check(got, want):
        assert _same_values(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_np(g), _np(w))

    def cfgs(op, lens, pay, k=None):
        kw = dict(op=op, lengths=lens, batch=4, dtype="bfloat16", has_payload=pay, k=k)
        return (fused_cfg_for(SortSpec(**kw), 4, torch.bfloat16),
                jf.fused_cfg_for(JSpec(device="tpu", **kw), 4, jnp.bfloat16))

    if rung == "fused":
        tc, jcfg = cfgs("sort", (64,), True)
        v, (p,) = fused_sort(tc, x, (tp[:, :64],))
        wv, (wp,) = jf.fused_sort(jcfg, jx, (jp[:, :64],))
        check((v, p), (wv, wp))
        for lens, ts, js in (((32, 32), (a, b), (ja, jb)), ((32,) * 3, (a, b, c), (ja, jb, jc))):
            tc, jcfg = cfgs("merge" if len(lens) == 2 else "merge_k", lens, True)
            n = sum(lens)
            v, (p,) = fused_merge_k(tc, ts, (tp[:, :n],))
            wv, (wp,) = jf.fused_merge_k(jcfg, js, (jp[:, :n],))
            check((v, p), (wv, wp))
        jcfg = jf.fused_cfg_for(JSpec(op="topk", lengths=(64,), batch=4, dtype="bfloat16", k=16),
                                4, jnp.bfloat16)
        check(repro_torch.topk(x, 16), j_fused_topk(jcfg, jx))
    elif rung == "cuda":  # the unfused top-k rung, reached past a failed fused one
        with failpoints(F):
            got = repro_torch.topk(x, 16)
        assert set(breaker_states()) == {("topk", "fused", "64v")}
        jspec = JSpec(op="topk", lengths=(64,), batch=4, dtype="int32", k=16)
        _, widx = j_get_backend("pallas").run["topk"](j_encode(jx), 16, spec=jspec)
        check(got, (np.take_along_axis(_np(jx), np.asarray(widx), -1), widx))
    else:  # the reference's calls under one jax.jit each (_jit)
        check(repro_torch.sort(x, payload=tp[:, :64], backend=rung),
              _jit(lambda v, p: repro.sort(v, payload=p, backend=rung), jx, jp[:, :64]))
        check(repro_torch.topk(x, 16, backend=rung), _jit(repro.topk, jx, k=16, backend=rung))
        check(repro_torch.merge(a, b, payload=(tp[:, :32], tp[:, 32:64]), backend=rung),
              _jit(lambda u, v, p: repro.merge(u, v, payload=(p[:, :32], p[:, 32:64]),
                                               backend=rung), ja, jb, jp))
        check(repro_torch.merge_k([a, b, c], payload=[tp[:, :32], tp[:, 32:64], tp[:, 64:]],
                                  backend=rung),
              _jit(lambda u, v, w, p: repro.merge_k(
                  [u, v, w], payload=[p[:, :32], p[:, 32:64], p[:, 64:]], backend=rung),
                  ja, jb, jc, jp))


def test_unsafe_signed_zeros_follow_the_answering_rung():
    """Under ``nan_policy="unsafe"`` -0.0 and +0.0 tie, so which zero comes
    first in the values is the answering rung's too."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.array([-1.5, -0.0, 0.0, 0.5], np.float32)[
        rng.integers(0, 4, (4, 64))]).to(torch.bfloat16)
    out = {}
    for rung, armed in _LADDERS["topk"].items():
        with failpoints(armed):
            out[rung] = (repro_torch.sort(x, nan_policy="unsafe"),
                         repro_torch.topk(x, 16, nan_policy="unsafe")[0])
    same = {r: all(_np(o).view(np.int32).tolist() == _np(f).view(np.int32).tolist()
                   for o, f in zip(out[r], out["fused"])) for r in out}
    assert same == {"fused": True, "cuda": True, "schedule": False, "lax": False}
    for r in out:  # equal as numbers all the same
        for o, f in zip(out[r], out["fused"]):
            np.testing.assert_array_equal(_np(o), _np(f))
