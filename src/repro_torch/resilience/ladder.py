"""The degradation ladder: fused → cuda → streaming → schedule → lax,
with a circuit breaker a rung (counterpart of
``repro.resilience.ladder``; the reference's ``pallas`` rung is the
port's ``cuda``).

The unified ops (:mod:`repro_torch.api.ops`) build one ``attempt(rung)``
closure a call and hand it here. :func:`run_ladder` walks the rungs the
plan gives (:func:`rungs_for`). With resilience on and an auto-routed
spec it catches a failed rung that may degrade (:func:`degradable`),
records it against that rung's breaker, counts ``resilience.fallbacks``
and emits a ``fallback`` event, and tries the next rung. The walk never
passes silently: every fallback feeds a breaker, so an empty breaker
registry (``breaker.states() == {}``) proves that every call was
answered by its planned rung.

Which failures degrade: an injected fault (:class:`FailpointError`) on
any device, and any error of a call whose tensors lie off the card,
where every rung is a plain version. On the card any other error (a
build error, a launch-configuration error, an allocation failure, a
sticky CUDA error) propagates from the rung that raised it: no slower
rung answers for a kernel that failed, and a poisoned context ends in
that error, never in a wrong answer.

What a fallback answers, as measured (``tests/test_torch_resilience.py``
on tied bf16 rows with ±0.0, ±inf and NaN; ``chip_smoke.py`` phase 3p on
the card): **the values are the same on every rung** under
``nan_policy="last"``, bit for bit except a NaN's bits (a NaN stays a
NaN in its place; the fused rungs decode the key's NaN, the others
gather the input's). **The tie order (int32 indices, permutations,
payload lanes) is that of the answering rung.** On the pinned rows the
fused and cuda top-k agree and the schedule and lax top-k each differ;
a sort with a payload agrees on fused and lax, not on schedule; a merge
with a payload differs on every rung; a k-way merge with a payload
agrees on fused and schedule, not on lax. Each port rung equals the
reference's same rung, values and tie order. Under
``nan_policy="unsafe"`` -0.0 and +0.0 tie, so which zero comes first is
the answering rung's too. A sampled token reads only the candidates'
values, so it is the same whichever rung answered. The segment ops'
fallback (the per-segment plain version) gives a sort's values and
payload as the class path does, and a top-k's values too, its ties by
ascending position where the class kernels order them otherwise.

Semantics that keep it invisible in healthy runs:

* resilience off (``REPRO_RESILIENCE=0`` or :func:`set_resilience_enabled`)
  or an explicit ``backend=``: the first rung that does not decline
  (:class:`LadderSkip`) runs and its error propagates;
* no failure ever recorded: the registry is empty, so the plan-time
  check (:func:`reroute`) is one dict miss and the walk takes the first
  rung.

The scheduler's retry (:mod:`repro_torch.serving.scheduler.engine`)
owns a failed step.

Under distribution (a ``sharded`` rung, or any call that a ``par``
makes part of a collective) every rank must take the same rung: a rank
that degrades while its peers sit in a collective hangs the group. The
ladder decides from each rank's own state, so the failpoints and the
breakers must decide alike on every rank. A seeded trigger (``p:P:seed``,
``times:N``, ``every:N``) on identical call sequences does; so does a
breaker fed by identical failures. A failure that only one rank sees (a
card's real error, which propagates on the card anyway) ends that
rank's call, and the group's collective times out. The sharded rung's
tie order is the sample-sort's and the device tree's: bit-equal to the
reference's sharded rung on the CPU, where the local phases are the
reference's schedule routes; on the card the local phases are the
kernels, whose tie order is the kernels' (values bit-equal everywhere;
``stable=True`` pins one order).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

from .breaker import any_breakers, breaker_for, rung_allowed, shape_class
from .failpoints import FailpointError

_ENABLED = True

#: degradation tail, most to least specialised; ``fused`` / ``cuda`` go
#: in front where the plan picked the kernels
LADDER_TAIL = ("streaming", "schedule", "lax")


def resilience_enabled() -> bool:
    """``REPRO_RESILIENCE=0`` pins every call to its planned rung (a
    failure then propagates instead of degrading)."""
    return _ENABLED and os.environ.get("REPRO_RESILIENCE", "1") != "0"


def set_resilience_enabled(enabled: bool) -> bool:
    """Turn the ladder on or off from code; returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


class LadderSkip(ValueError):
    """Raised by an ``attempt`` to decline a rung without failing it (the
    fused config resolved to None, a median device that cannot take the
    lists). Never counted against a breaker; a call that every rung
    declines raises it."""


class ResilienceExhausted(RuntimeError):
    """Every rung of the ladder failed for this call."""

    def __init__(self, op: str, rungs: Sequence[str]):
        super().__init__(f"every ladder rung failed for op {op!r} (tried {list(rungs)})")
        self.op = op
        self.rungs = tuple(rungs)


def _backend_of(rung: str) -> str:
    return "cuda" if rung == "fused" else rung


def spec_class(spec) -> str:
    return shape_class(spec.total, spec.has_payload)


def degradable(err: BaseException, device=None) -> bool:
    """Whether a failed rung may hand its call down the ladder: an
    injected fault anywhere; any error where ``device`` (the call's
    tensors' device; None for none) is not the card."""
    return isinstance(err, FailpointError) or not str(device).startswith("cuda")


def record_fallback(op: str, rung: str, cls: str, err: BaseException, br=None) -> None:
    """A rung that failed: its breaker records the failure (made here at
    the first), ``resilience.fallbacks`` counts it and a ``fallback``
    event names it."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import recorder as obs_recorder

    (br or breaker_for(op, rung, cls)).record_failure()
    obs_metrics.counter("resilience.fallbacks").inc(op=op, rung=rung, cls=cls,
                                                    err=type(err).__name__)
    obs_recorder.emit("fallback", f"{op}/{rung}/{cls}", err=type(err).__name__)


def rungs_for(spec, dec) -> List[str]:
    """The ordered rungs of one planned call, capability-filtered.

    An explicit ask gets its backend (and the fused rung in front of
    ``cuda``: fused or not is how the kernels run it, not a route). An
    auto ask gets the planned rung, then the degradation tail; a rung
    whose backend cannot run the spec (``supports``) is dropped, and so
    is unfused ``cuda`` for a spec that carries a permutation (its
    adapters are values-only), except ``topk`` (its indices are native)."""
    from repro_torch.api.registry import get_backend
    from repro_torch.api.spec import BACKEND_AUTO

    if spec.backend != BACKEND_AUTO:
        if dec.backend != "cuda":
            return [dec.backend]
        if spec.needs_perm and spec.op != "topk":
            return ["fused", "schedule"]
        return ["fused", "cuda"]
    head = ["fused", "cuda"] if dec.backend == "cuda" else [dec.backend]
    out: List[str] = []
    for r in head + [b for b in LADDER_TAIL if b not in head]:
        if r == "fused":
            out.append(r)  # eligibility resolves at attempt time
        elif r == "cuda" and spec.needs_perm and spec.op != "topk":
            continue
        elif get_backend(r).supports(spec):
            out.append(r)
    return out or ["schedule"]


def reroute(spec, dec):
    """Plan-time breaker avoidance: where the planned rung's breaker is
    open for this (op, shape class), move the decision to the first
    allowed rung (``source="breaker"``). Peeks only: the half-open probe
    is admitted at run time."""
    from repro_torch.api.spec import BACKEND_AUTO

    if (not any_breakers() or not resilience_enabled() or spec.backend != BACKEND_AUTO
            or dec.backend == "segmented"):
        return dec
    cls = spec_class(spec)
    for rung in rungs_for(spec, dec):
        if not rung_allowed(spec.op, rung, cls):
            continue
        backend = _backend_of(rung)
        if backend == dec.backend:
            return dec
        return dataclasses.replace(
            dec, backend=backend, detail="degraded", source="breaker",
            reason=f"breaker open for ({spec.op}, {dec.backend}, {cls}): degraded to {backend}")
    return dec  # every rung open: keep the plan, run_ladder force-runs the last


def run_ladder(spec, rungs: Sequence[str], attempt: Callable[[str], object],
               cls: Optional[str] = None, *, device=None):
    """Run ``attempt`` down the rungs; ``device`` is where the call's
    tensors lie.

    With resilience off or an explicit ask: the first rung that does not
    decline, no error caught. Otherwise a failed rung whose error is
    :func:`degradable` feeds its breaker and the walk goes on (any other
    error propagates); if every rung was blocked by an open breaker the
    last is force-run (an answer beats a refusal); if every rung failed,
    the last error chains into :class:`ResilienceExhausted`."""
    from repro_torch.api.spec import BACKEND_AUTO
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import recorder as obs_recorder

    if not (resilience_enabled() and spec.backend == BACKEND_AUTO):
        for rung in rungs:
            try:
                return attempt(rung)
            except LadderSkip:
                continue
        raise LadderSkip(f"no rung of {list(rungs)} can run {spec.describe()}")

    cls = cls or spec_class(spec)
    last_exc: Optional[BaseException] = None
    blocked: List[str] = []
    for rung in rungs:
        br = breaker_for(spec.op, rung, cls, create=False)
        if br is not None and not br.allow():
            blocked.append(rung)
            continue
        try:
            result = attempt(rung)
        except LadderSkip:
            continue
        except Exception as e:  # noqa: BLE001 — degradable() decides
            if not degradable(e, device):
                raise
            record_fallback(spec.op, rung, cls, e, br)
            last_exc = e
            continue
        if br is not None:
            br.record_success()
        return result
    if last_exc is None and blocked:
        obs_metrics.counter("resilience.forced").inc(op=spec.op, rung=blocked[-1], cls=cls)
        obs_recorder.emit("forced", f"{spec.op}/{blocked[-1]}/{cls}")
        return attempt(blocked[-1])
    raise ResilienceExhausted(spec.op, rungs) from last_exc
