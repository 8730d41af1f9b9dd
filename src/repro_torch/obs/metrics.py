"""Process-global metric registry: counters, gauges, histograms
(counterpart of ``repro.obs.metrics``, with its names and semantics).

The registry is the numeric half of the observability layer (spans are
the temporal half): dispatch decisions per backend, autotune cache
hit/miss/stale-schema, segmented padded-slot waste, grid-merge refill
tiles, per-plan working-set estimates, the serving and scheduler series.

Semantics:

* Every mutator (``inc``/``set``/``observe``) is gated on
  :func:`repro_torch.obs.trace.enabled`: with ``REPRO_OBS`` unset the
  whole registry is inert and costs one predicate call.
* Labels are keyword arguments; each distinct label combination is one
  series. Keep cardinality low (op names, backends; never shapes-per-
  element or request ids).
* The reference records its planning metrics while JAX traces a jit
  function, so they count compilations. The port runs eagerly and its
  planning metrics count calls (the rule :mod:`repro_torch.obs.trace`
  states).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .trace import enabled

_LabelKey = Tuple[Tuple[str, Any], ...]


def _lkey(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted(labels.items()))


class Metric:
    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def series(self) -> List[dict]:  # pragma: no cover - overridden
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "help": self.help,
                "series": self.series()}


class Counter(Metric):
    """Monotonic sum per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[_LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if not enabled():
            return
        key = _lkey(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_lkey(labels), 0)

    def total(self) -> float:
        with self._lock:
            return sum(self._vals.values())

    def series(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._vals.items())]


class Gauge(Metric):
    """Last-written value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        if not enabled():
            return
        with self._lock:
            self._vals[_lkey(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._vals.get(_lkey(labels))

    def series(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._vals.items())]


class Histogram(Metric):
    """count/sum/min/max plus a bounded sample reservoir (first
    ``max_samples`` observations) for percentile estimates in exports."""

    kind = "histogram"
    max_samples = 1024

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._stats: Dict[_LabelKey, dict] = {}

    def observe(self, value: float, **labels) -> None:
        if not enabled():
            return
        value = float(value)
        key = _lkey(labels)
        with self._lock:
            st = self._stats.get(key)
            if st is None:
                st = self._stats[key] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                    "samples": [],
                }
            st["count"] += 1
            st["sum"] += value
            st["min"] = min(st["min"], value)
            st["max"] = max(st["max"], value)
            if len(st["samples"]) < self.max_samples:
                st["samples"].append(value)

    def stats(self, **labels) -> Optional[dict]:
        with self._lock:
            st = self._stats.get(_lkey(labels))
            return dict(st, samples=list(st["samples"])) if st else None

    def series(self) -> List[dict]:
        with self._lock:
            out = []
            for k, st in sorted(self._stats.items()):
                # ``samples`` (reservoir occupancy) rides along so an
                # exhausted reservoir is visible: count > samples means
                # the percentiles below cover only the first
                # ``max_samples`` observations, not the full series
                row = {"labels": dict(k), "count": st["count"],
                       "sum": st["sum"], "min": st["min"], "max": st["max"],
                       "samples": len(st["samples"]),
                       "reservoir_full": len(st["samples"]) >= self.max_samples}
                samples = sorted(st["samples"])
                if samples:
                    for p in (50, 95, 99):
                        idx = min(len(samples) - 1,
                                  int(round(p / 100 * (len(samples) - 1))))
                        row[f"p{p}"] = samples[idx]
                out.append(row)
            return out


_reg_lock = threading.Lock()
_registry: Dict[str, Metric] = {}


def _get_or_create(name: str, cls, help: str) -> Metric:
    with _reg_lock:
        m = _registry.get(name)
        if m is None:
            m = _registry[name] = cls(name, help)
        assert isinstance(m, cls), (
            f"metric {name!r} already registered as {m.kind}")
        return m


def counter(name: str, help: str = "") -> Counter:
    return _get_or_create(name, Counter, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get_or_create(name, Gauge, help)


def histogram(name: str, help: str = "") -> Histogram:
    return _get_or_create(name, Histogram, help)


def registry() -> Dict[str, Metric]:
    with _reg_lock:
        return dict(_registry)


def snapshot() -> Dict[str, dict]:
    """All metrics as JSON-ready dicts, keyed by metric name."""
    with _reg_lock:
        items = list(_registry.items())
    return {name: m.to_dict() for name, m in items}


def reset() -> None:
    """Drop every registered metric (tests / between export epochs)."""
    with _reg_lock:
        _registry.clear()
