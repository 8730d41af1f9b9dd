"""repro_torch.obs — observability: spans, metrics, timing, recorder,
export (the counterpart of ``repro.obs``, with its names, series and env
vars: ``REPRO_OBS``, ``REPRO_OBS_EXPORT``, ``REPRO_OBS_DUMP``).

The measured-telemetry layer of the stack (DESIGN.md §13, §17): the
paper characterizes every sorter by measured speed and resource cost;
this package gives the port the same footing. Span tracing
(``trace``, including explicit-time ``record_span`` for per-request
timelines), a process-global metric registry (``metrics``), the one
shared timing helper (``timing``), a bounded flight recorder of
structured events for post-mortems (``recorder``), and JSONL /
Chrome-trace / Prometheus-text export (``export``). Everything is a
strict no-op unless ``REPRO_OBS`` is set (or :func:`set_enabled` forces
it on).

    import repro_torch.obs as obs
    obs.set_enabled(True)
    with obs.span("my.region", kind="run"):
        obs.timing.block_until_ready(fn(x))
    obs.snapshot()                      # {meta, spans, metrics, events}
    obs.write_chrome_trace("out.trace.json")   # perfetto-loadable
    obs.write_prom("metrics.prom")             # Prometheus text format
    obs.recorder.dump("flight.jsonl")          # ring-buffer post-mortem
"""
from . import export, metrics, recorder, timing, trace  # noqa: F401
from .export import (  # noqa: F401
    chrome_trace,
    prom_text,
    request_chrome_trace,
    request_waterfalls,
    snapshot,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
    write_prom,
)
from .metrics import counter, gauge, histogram  # noqa: F401
from .timing import TimingStats, time_jitted, time_once  # noqa: F401
from .trace import enabled, record_span, set_enabled, span, traced  # noqa: F401

__all__ = [
    "TimingStats",
    "chrome_trace",
    "counter",
    "enabled",
    "export",
    "gauge",
    "histogram",
    "metrics",
    "prom_text",
    "record_span",
    "recorder",
    "request_chrome_trace",
    "request_waterfalls",
    "set_enabled",
    "snapshot",
    "span",
    "time_jitted",
    "time_once",
    "timing",
    "trace",
    "traced",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "write_prom",
]
