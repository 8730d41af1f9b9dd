"""Export sinks for the observability layer (counterpart of
``repro.obs.export``; DESIGN.md §13).

Three consumers, three shapes:

* :func:`snapshot` — one JSON-ready dict ``{meta, spans, metrics}``, the
  programmatic API (tests, the serve benchmark, future planner cost
  models read this).
* :func:`write_jsonl` — line-oriented sink (one ``{"type": ...}`` object
  per line: ``meta``, then every span, then every metric) for log
  shippers and offline analysis.
* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome trace-event
  JSON (``traceEvents`` with ``ph: "X"`` complete events), loadable in
  ``chrome://tracing`` and perfetto. Span kinds become categories, so
  trace-time (planning/lowering) and run-time spans are separately
  filterable.

``REPRO_OBS_EXPORT=<path>`` auto-writes at interpreter exit when obs is
on: ``*.jsonl`` selects the JSONL sink, anything else the Chrome trace.

:func:`validate_chrome_trace` is the schema check CI gates the exported
trace against — it returns a list of violations (empty = valid) instead
of raising, so callers can aggregate.
"""
from __future__ import annotations

import atexit
import json
import os
import time
from typing import List, Optional

from . import metrics as _metrics
from . import recorder as _recorder
from . import trace as _trace

_EXPORT_ENV = "REPRO_OBS_EXPORT"


def _platform() -> dict:
    """The reference's ``jax.default_backend()``, for the port: the
    platform (``"cuda"`` with a card, else ``"cpu"``), torch, CUDA and
    the device's name."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "platform": "cuda" if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def _meta() -> dict:
    return {
        "schema": 1,
        "generated_unix": int(time.time()),
        "pid": os.getpid(),
        **_platform(),
        # buffer health: dropped > 0 or recorded == cap means the span
        # buffer saturated and percentile/waterfall views are truncated
        "dropped_spans": _trace.dropped(),
        "spans_recorded": _trace.span_count(),
        "span_cap": _trace.MAX_SPANS,
        "events_overwritten": _recorder.overwritten(),
    }


def snapshot() -> dict:
    """Everything recorded so far: ``{meta, spans, metrics, events}``."""
    return {
        "meta": _meta(),
        "spans": [sp.to_dict() for sp in _trace.spans()],
        "metrics": _metrics.snapshot(),
        "events": [ev.to_dict() for ev in _recorder.events()],
    }


def write_jsonl(path: str, snap: Optional[dict] = None) -> str:
    """One JSON object per line: meta, spans, metrics, recorder events."""
    snap = snap if snap is not None else snapshot()
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", **snap["meta"]}) + "\n")
        for sp in snap["spans"]:
            f.write(json.dumps({"type": "span", **sp}, default=str) + "\n")
        for m in snap["metrics"].values():
            f.write(json.dumps({"type": "metric", **m}) + "\n")
        for ev in snap.get("events", ()):
            f.write(json.dumps({"type": "event", **ev}, default=str) + "\n")
    return path


def chrome_trace(snap: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON (perfetto-loadable) from recorded spans.

    Spans map to ``ph: "X"`` complete events (ts/dur in µs on the
    host-monotonic clock); metric totals ride along as one ``ph: "C"``
    counter sample each so headline counts are visible on the timeline."""
    snap = snap if snap is not None else snapshot()
    pid = snap["meta"]["pid"]
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"repro_torch.obs ({snap['meta']['platform']})"},
    }]
    t0 = min((sp["ts_us"] for sp in snap["spans"]), default=0.0)
    for sp in snap["spans"]:
        events.append({
            "name": sp["name"],
            "cat": sp["kind"],
            "ph": "X",
            "ts": sp["ts_us"] - t0,
            "dur": sp["dur_us"],
            "pid": pid,
            "tid": sp["thread"] % (1 << 31),
            "args": dict(sp["attrs"], span_id=sp["id"],
                         parent=sp["parent"]),
        })
    for ev in snap.get("events", ()):
        # flight-recorder events ride along as instant marks on the same
        # normalized clock, filterable by their kind category
        events.append({
            "name": f"{ev['kind']}:{ev['name']}",
            "cat": ev["kind"],
            "ph": "i",
            "s": "p",
            "ts": max(ev["ts_us"] - t0, 0.0),
            "pid": pid,
            "tid": 0,
            "args": dict(ev["attrs"], seq=ev["seq"]),
        })
    for name, m in snap["metrics"].items():
        if m["kind"] != "counter":
            continue
        total = sum(s["value"] for s in m["series"])
        events.append({
            "name": name, "ph": "C", "ts": 0.0, "pid": pid, "tid": 0,
            "args": {"total": total},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, snap: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(snap), f)
        f.write("\n")
    return path


def validate_chrome_trace(obj: dict) -> List[str]:
    """Schema check for the exported trace; returns violations (empty =
    valid). Covers the invariants chrome://tracing / perfetto require:
    a ``traceEvents`` list whose events carry name/ph/pid/tid, complete
    (``X``) events with numeric non-negative ts/dur."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                errs.append(f"{where}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "B", "E", "i"):
            errs.append(f"{where}: unknown phase {ph!r}")
        if ph == "X":
            for field in ("ts", "dur"):
                v = ev.get(field)
                if not isinstance(v, (int, float)) or v < 0:
                    errs.append(f"{where}: {field} not a non-negative number")
            if not isinstance(ev.get("cat", ""), str):
                errs.append(f"{where}: cat not a string")
    return errs


# --------------------------------------------------- prometheus export


def _prom_name(name: str, suffix: str = "") -> str:
    """Metric-name mapping (DESIGN.md §17): ``repro_`` prefix, dots and
    other non-alphanumerics to underscores — ``sched.ttft_s`` becomes
    ``repro_sched_ttft_s``."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"repro_{safe}{suffix}"


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", "\\\\").replace('"', '\\"')
           for k, v in labels.items()}
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(esc.items()))
    return "{" + inner + "}"


def prom_text(snap: Optional[dict] = None) -> str:
    """The metric registry in Prometheus text exposition format.

    Counters get the ``_total`` suffix, gauges export verbatim,
    histograms export ``_count``/``_sum``/``_min``/``_max`` plus
    reservoir percentiles as ``{quantile="0.5|0.95|0.99"}`` series (a
    summary-style view; the reservoir keeps the first 1024 samples)."""
    metrics = (snap["metrics"] if snap is not None
               else _metrics.snapshot())
    lines = []
    for name in sorted(metrics):
        m = metrics[name]
        kind = m["kind"]
        prom_kind = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
        base = _prom_name(name, "_total" if kind == "counter" else "")
        if m.get("help"):
            lines.append(f"# HELP {base} {m['help']}")
        lines.append(f"# TYPE {base} {prom_kind}")
        for s in m["series"]:
            labels = s["labels"]
            if kind in ("counter", "gauge"):
                lines.append(f"{base}{_prom_labels(labels)} {s['value']}")
                continue
            stem = _prom_name(name)
            lines.append(f"{stem}_count{_prom_labels(labels)} {s['count']}")
            lines.append(f"{stem}_sum{_prom_labels(labels)} {s['sum']}")
            lines.append(f"{stem}_min{_prom_labels(labels)} {s['min']}")
            lines.append(f"{stem}_max{_prom_labels(labels)} {s['max']}")
            for p, q in ((50, "0.5"), (95, "0.95"), (99, "0.99")):
                if f"p{p}" in s:
                    lines.append(
                        f"{stem}{_prom_labels(dict(labels, quantile=q))} "
                        f"{s[f'p{p}']}")
    return "\n".join(lines) + "\n"


def write_prom(path: str, snap: Optional[dict] = None) -> str:
    """Write :func:`prom_text` to ``path`` (node-exporter textfile /
    scrape-target style)."""
    with open(path, "w") as f:
        f.write(prom_text(snap))
    return path


# -------------------------------------------- per-request waterfalls


#: per-request stage spans the scheduler emits (engine.py); ``request``
#: is the root span recorded at the terminal state
REQUEST_ROOT = "request"
REQUEST_STAGES = ("req.queue_wait", "req.prefill", "req.insert",
                  "req.decode")


def request_waterfalls(snap: Optional[dict] = None) -> List[dict]:
    """Per-request causal timelines from the scheduler's request spans.

    Groups ``req.*`` stage spans by their ``rid`` attribute under each
    ``request`` root span and checks the reconciliation contract:
    queue-wait, prefill, and insert are *contiguous* (shared endpoints),
    so their sum equals TTFT exactly; decode ticks account for the rest
    up to scheduler overhead, surfaced as ``unaccounted_us`` (≥ 0 —
    stages never overlap or exceed the measured request latency)."""
    snap = snap if snap is not None else snapshot()
    roots: dict = {}
    stages: dict = {}
    for sp in snap["spans"]:
        rid = sp["attrs"].get("rid")
        if rid is None:
            continue
        if sp["name"] == REQUEST_ROOT:
            roots[rid] = sp
        elif sp["name"] in REQUEST_STAGES:
            stages.setdefault(rid, []).append(sp)
    out = []
    for rid in sorted(roots):
        root = roots[rid]
        st = sorted(stages.get(rid, []), key=lambda s: s["ts_us"])
        # reconcile on the integer-ns twins: stage endpoints are shared
        # by construction, so exact equality holds (no float µs rounding)
        total_ns = root["dur_ns"]
        accounted_ns = sum(s["dur_ns"] for s in st)
        ttft_ns = sum(s["dur_ns"] for s in st
                      if s["name"] != "req.decode")
        decode_ticks = sum(1 for s in st if s["name"] == "req.decode")
        out.append({
            "rid": rid,
            "state": root["attrs"].get("state"),
            "total_us": total_ns / 1e3,
            "ttft_us": ttft_ns / 1e3,
            "decode_ticks": decode_ticks,
            "accounted_us": accounted_ns / 1e3,
            "unaccounted_us": (total_ns - accounted_ns) / 1e3,
            "total_ns": total_ns,
            "ttft_ns": ttft_ns,
            "accounted_ns": accounted_ns,
            "unaccounted_ns": total_ns - accounted_ns,
            "stages": [{"name": s["name"], "t0_us": s["ts_us"],
                        "dur_us": s["dur_us"], "t0_ns": s["ts_ns"],
                        "dur_ns": s["dur_ns"], "attrs": s["attrs"]}
                       for s in st],
        })
    return out


def request_chrome_trace(snap: Optional[dict] = None) -> dict:
    """Chrome-trace view with one timeline row per request (tid = rid),
    so the per-request waterfall reads top-to-bottom in perfetto. Spans
    without a ``rid`` keep their thread row; recorder events and counter
    samples ride along unchanged."""
    snap = snap if snap is not None else snapshot()
    base = chrome_trace(snap)
    pid = snap["meta"]["pid"]
    rids = set()
    # chrome_trace lays out [process-meta] + spans (in order) + events +
    # counters, so zipping the tail against snap["spans"] pairs them up
    for ev, sp in zip(base["traceEvents"][1:], snap["spans"]):
        rid = sp["attrs"].get("rid")
        if rid is None:
            continue
        ev["tid"] = 1 + int(rid)
        rids.add(int(rid))
    for rid in sorted(rids):
        base["traceEvents"].append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 1 + rid,
            "args": {"name": f"request {rid}"},
        })
    base["waterfalls"] = request_waterfalls(snap)
    return base


def _export_at_exit() -> None:  # pragma: no cover - exit hook
    path = os.environ.get(_EXPORT_ENV)
    if not path or not _trace.enabled():
        return
    try:
        if path.endswith(".jsonl"):
            write_jsonl(path)
        else:
            write_chrome_trace(path)
    except Exception as e:  # noqa: BLE001 — never fail interpreter exit
        print(f"[repro_torch.obs] export to {path} failed: {e}")


_atexit_registered = False


def install_atexit_export() -> None:
    """Idempotently register the ``REPRO_OBS_EXPORT`` exit hook."""
    global _atexit_registered
    if not _atexit_registered:
        atexit.register(_export_at_exit)
        _atexit_registered = True


if os.environ.get(_EXPORT_ENV):
    install_atexit_export()
