"""Lightweight span tracer for the whole stack (counterpart of
``repro.obs.trace``; DESIGN.md §13).

One process-global span buffer, fed by a context manager / decorator that
is a **strict no-op when observability is off**: ``span(...)`` returns a
shared null context object, no state is touched and nothing is allocated,
so instrumented hot paths (``plan()``, the serve loop, the scheduler)
pay nanoseconds.

Two span kinds, as in the reference:

* ``kind="trace"``: planning work (backend planning, tile plans,
  bucketing). The reference runs it while Python traces a jit function
  and enters ``jax.named_scope``; the port runs eagerly, so such a span
  is a host region and enters no profiler range. **Counting rule:** the
  metrics recorded beside these spans (``plan.decisions``,
  ``plan.tile_plans``, ``segmented.*``, ``grid_merge.*``) count *calls*
  in the port, where the reference's count compilations: three calls of
  ``repro_torch.sort`` on one shape add three to ``plan.decisions``, and
  ``segmented.class_launches`` / ``grid_merge.launches`` count the class
  and grid launches the calls make.
* ``kind="run"``: host-timed execution regions whose caller has made the
  duration meaningful (a synchronise before exit: prefill, decode, a
  scheduler tick). Enters ``torch.profiler.record_function(name)`` (the
  reference's ``jax.profiler.TraceAnnotation``), so the region shows up
  as a range in a ``torch.profiler`` trace.

Enablement: the ``REPRO_OBS`` env var (any value but ``""``/``"0"``) or
:func:`set_enabled` (tests / embedding apps). Spans nest through a
thread-local stack; each records its parent id, so the exporter can
rebuild the tree.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_ENV = "REPRO_OBS"

#: programmatic override: None = follow the env var, True/False = forced
_forced: Optional[bool] = None

#: span buffer cap — beyond it spans are counted as dropped, not stored
MAX_SPANS = 100_000


def enabled() -> bool:
    """Whether observability is on (``REPRO_OBS`` or a forced override)."""
    if _forced is not None:
        return _forced
    return os.environ.get(_ENV, "") not in ("", "0")


def set_enabled(on: Optional[bool]) -> Optional[bool]:
    """Force obs on/off from code (``None`` = follow ``REPRO_OBS``).

    Returns the previous override so callers can restore it."""
    global _forced
    prev = _forced
    _forced = None if on is None else bool(on)
    return prev


@dataclasses.dataclass
class Span:
    """One recorded region. Times are ``time.perf_counter_ns`` host time."""

    name: str
    kind: str  # 'trace' (planning) | 'run' (host-timed execution)
    t0_ns: int
    dur_ns: int
    span_id: int
    parent_id: Optional[int]
    thread: int
    attrs: Dict[str, Any]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "ts_us": self.t0_ns / 1e3,
            "dur_us": self.dur_ns / 1e3,
            # integer-ns twins: stage spans reconcile *exactly* against
            # request latency in ns; the µs floats are display-only
            "ts_ns": self.t0_ns,
            "dur_ns": self.dur_ns,
            "id": self.span_id,
            "parent": self.parent_id,
            "thread": self.thread,
            "attrs": self.attrs,
        }


_lock = threading.Lock()
_spans: List[Span] = []
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()


def _store(sp: Span) -> None:
    """Append one completed span (respecting the cap) and feed the
    flight recorder's span-close event stream."""
    global _dropped
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(sp)
        else:
            _dropped += 1
    from . import recorder as _recorder

    _recorder.emit("span", sp.name, dur_us=sp.dur_ns / 1e3,
                   span_kind=sp.kind, **sp.attrs)


class _NullSpan:
    """The disabled-path context: shared, stateless, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _LiveSpan:
    __slots__ = ("name", "kind", "attrs", "span_id", "parent_id",
                 "_t0", "_range")

    def __init__(self, name: str, kind: str, attrs: Dict[str, Any]):
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id: Optional[int] = None
        self._t0 = 0
        self._range = None

    def __enter__(self) -> "_LiveSpan":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        if self.kind == "run":
            from torch.profiler import record_function

            # a range in torch.profiler traces (host and device tracks)
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = getattr(_tls, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()
        _store(Span(name=self.name, kind=self.kind, t0_ns=self._t0,
                    dur_ns=dur, span_id=self.span_id,
                    parent_id=self.parent_id,
                    thread=threading.get_ident(), attrs=self.attrs))
        return False


def span(name: str, kind: str = "run", **attrs):
    """Context manager recording one region; no-op context when disabled.

    ``kind="trace"`` for planning spans (host only), ``kind="run"`` for
    host-timed execution (a ``torch.profiler`` range); ``attrs`` are
    JSON-scalar annotations carried into the export."""
    if not enabled():
        return _NULL
    assert kind in ("trace", "run"), kind
    return _LiveSpan(name, kind, attrs)


def traced(name: Optional[str] = None, kind: str = "trace"):
    """Decorator form of :func:`span`; defaults to the function name."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with _LiveSpan(label, kind, {}):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def record_span(name: str, t0_ns: int, dur_ns: int, *, kind: str = "run",
                parent_id: Optional[int] = None,
                **attrs) -> Optional[int]:
    """Record a completed span with explicit host timestamps.

    The context-manager form times a code region; this form records a
    *derived* region, e.g. a request's queue-wait, which spans two call
    sites (``submit`` -> admission) and belongs to no single ``with``
    block. ``t0_ns``/``dur_ns`` are ``time.perf_counter_ns`` values so
    explicit and context-managed spans share one clock. Returns the span
    id (``None`` when disabled: a strict no-op, nothing allocated)."""
    if not enabled():
        return None
    assert kind in ("trace", "run"), kind
    sid = next(_ids)
    _store(Span(name=name, kind=kind, t0_ns=int(t0_ns),
                dur_ns=max(int(dur_ns), 0), span_id=sid,
                parent_id=parent_id, thread=threading.get_ident(),
                attrs=attrs))
    return sid


def spans() -> Tuple[Span, ...]:
    """Snapshot of every recorded span (completion order)."""
    with _lock:
        return tuple(_spans)


def span_count() -> int:
    """How many spans the buffer currently holds (cap: MAX_SPANS)."""
    with _lock:
        return len(_spans)


def dropped() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    """Drop all recorded spans (tests / between export epochs)."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
