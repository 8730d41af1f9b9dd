"""Flight recorder: a bounded ring buffer of structured events for
post-mortems (counterpart of ``repro.obs.recorder``; DESIGN.md §17).

Spans answer "where did the time go"; metrics answer "how much". The
recorder answers the post-mortem question — *what happened, in order,
just before things went wrong* — without unbounded memory. One
process-global, thread-safe ring of the last ``capacity`` events:

* span closes (fed by :mod:`repro_torch.obs.trace`),
* circuit-breaker transitions, ladder fallbacks and failpoint fires
  (``breaker``, ``fallback`` / ``forced``, ``failpoint``: fed by
  :mod:`repro_torch.resilience`),
* autotune tournament picks (``tournament``),
* autotune-cache quarantines (``quarantine``),
* scheduler lifecycle marks (``sched``).

Every producer calls :func:`emit`, which is a strict no-op when
``REPRO_OBS`` is off (one predicate call, no allocation) — the same
contract as spans and metrics, re-gated by ``tests/test_torch_obs.py``.

Dumps happen three ways:

* on demand — :func:`dump` returns ``{meta, events}``; with a path it
  writes one JSON object per line (JSONL);
* on unhandled engine exception — :func:`crash_dump` (called by the
  serving scheduler's ``run()``) writes to ``REPRO_OBS_DUMP`` if set,
  else prints a bounded tail to stderr, then the exception propagates;
* on ``SIGUSR1`` — :func:`install_signal_dump` registers a handler so a
  wedged process can be asked for its recent history from outside.

Exporters: :func:`chrome_trace_events` maps events onto the existing
chrome-trace schema as instant (``ph: "i"``) events — mergeable with the
span export and checked by the same ``validate_chrome_trace`` — and
:func:`write_jsonl` is the event log sink. The Prometheus text-format
exporter for the metric registry lives in
:func:`repro_torch.obs.export.write_prom`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from .trace import enabled

_DUMP_ENV = "REPRO_OBS_DUMP"

#: default ring capacity — events beyond it overwrite the oldest
DEFAULT_CAPACITY = 4096


@dataclasses.dataclass
class Event:
    """One recorded occurrence. ``seq`` is a monotonically increasing
    id that survives ring wraparound, so consumers can tell how much
    history was overwritten (``first seq > 1`` ⇒ older events lost)."""

    seq: int
    t_ns: int
    kind: str
    name: str
    attrs: Dict[str, Any]

    def to_dict(self) -> dict:
        return {"seq": self.seq, "ts_us": self.t_ns / 1e3,
                "kind": self.kind, "name": self.name, "attrs": self.attrs}


_lock = threading.Lock()
_ring: Deque[Event] = collections.deque(maxlen=DEFAULT_CAPACITY)
_seq = 0


def emit(kind: str, name: str, **attrs) -> None:
    """Record one event; strict no-op when observability is off."""
    if not enabled():
        return
    global _seq
    t = time.perf_counter_ns()
    with _lock:
        _seq += 1
        _ring.append(Event(seq=_seq, t_ns=t, kind=kind, name=name,
                           attrs=attrs))


def events() -> List[Event]:
    """Snapshot of the ring, oldest first."""
    with _lock:
        return list(_ring)


def total_events() -> int:
    """How many events were ever emitted (≥ ``len(events())``)."""
    with _lock:
        return _seq


def overwritten() -> int:
    """How many events the ring has discarded to stay bounded."""
    with _lock:
        return _seq - len(_ring)


def capacity() -> int:
    return _ring.maxlen or 0


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest events that still fit)."""
    global _ring
    assert n >= 1, n
    with _lock:
        _ring = collections.deque(_ring, maxlen=int(n))


def clear() -> None:
    """Drop every recorded event and reset the sequence (tests)."""
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0


# ---------------------------------------------------------------- dumps


def _dump_meta(reason: str) -> dict:
    with _lock:
        n, total = len(_ring), _seq
    return {
        "schema": 1,
        "reason": reason,
        "generated_unix": int(time.time()),
        "pid": os.getpid(),
        "events": n,
        "total_events": total,
        "overwritten": total - n,
        "capacity": capacity(),
    }


def dump(path: Optional[str] = None, reason: str = "on_demand") -> dict:
    """The ring as ``{meta, events}``; with ``path``, also written as
    JSONL (one ``{"type": "meta"|"event"}`` object per line)."""
    snap = {"meta": _dump_meta(reason),
            "events": [ev.to_dict() for ev in events()]}
    if path:
        write_jsonl(path, snap)
    return snap


def write_jsonl(path: str, snap: Optional[dict] = None) -> str:
    snap = snap if snap is not None else dump()
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", **snap["meta"]}) + "\n")
        for ev in snap["events"]:
            f.write(json.dumps({"type": "event", **ev}, default=str) + "\n")
    return path


def crash_dump(context: str, error: BaseException) -> Optional[str]:
    """Best-effort dump for an unhandled exception: to the
    ``REPRO_OBS_DUMP`` path when set, else a bounded tail to stderr.
    Never raises (the original exception is the story); returns the
    path written, if any."""
    if not enabled():
        return None
    reason = f"crash:{context}:{type(error).__name__}"
    try:
        path = os.environ.get(_DUMP_ENV)
        if path:
            dump(path, reason=reason)
            return path
        import sys

        tail = [ev.to_dict() for ev in events()[-50:]]
        print(f"[repro_torch.obs.recorder] {reason}: last {len(tail)} events:",
              file=sys.stderr)
        for ev in tail:
            print(f"  {json.dumps(ev, default=str)}", file=sys.stderr)
    except Exception:  # noqa: BLE001 — never mask the original error
        pass
    return None


_prev_handler = None
_signal_installed = False


def install_signal_dump(path: Optional[str] = None) -> bool:
    """Register a ``SIGUSR1`` handler that dumps the ring (idempotent;
    main thread only — returns False where signals are unavailable).
    ``path`` defaults to ``REPRO_OBS_DUMP`` or
    ``flight_recorder.<pid>.jsonl`` in the cwd."""
    global _prev_handler, _signal_installed
    if _signal_installed:
        return True
    import signal

    target = path or os.environ.get(_DUMP_ENV)

    def _handler(signum, frame):  # pragma: no cover - exercised via kill
        dump(target or f"flight_recorder.{os.getpid()}.jsonl",
             reason="SIGUSR1")

    try:
        _prev_handler = signal.signal(signal.SIGUSR1, _handler)
    except (ValueError, AttributeError, OSError):
        return False  # non-main thread / platform without SIGUSR1
    _signal_installed = True
    return True


def uninstall_signal_dump() -> None:
    """Restore the previous ``SIGUSR1`` handler (tests)."""
    global _prev_handler, _signal_installed
    if not _signal_installed:
        return
    import signal

    try:
        signal.signal(signal.SIGUSR1, _prev_handler or signal.SIG_DFL)
    except (ValueError, OSError):  # pragma: no cover
        pass
    _prev_handler = None
    _signal_installed = False


# ------------------------------------------------------------ exporters


def chrome_trace_events(snap: Optional[dict] = None) -> List[dict]:
    """Recorder events as chrome-trace instant events (``ph: "i"``),
    mergeable into the span export's ``traceEvents`` and valid under
    :func:`repro_torch.obs.export.validate_chrome_trace`."""
    snap = snap if snap is not None else dump()
    pid = snap["meta"]["pid"]
    out = []
    for ev in snap["events"]:
        out.append({
            "name": f"{ev['kind']}:{ev['name']}",
            "cat": ev["kind"],
            "ph": "i",
            "s": "p",
            "ts": ev["ts_us"],
            "pid": pid,
            "tid": 0,
            "args": dict(ev["attrs"], seq=ev["seq"]),
        })
    return out
