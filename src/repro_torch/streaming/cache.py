"""Disk-backed autotune cache for the merge planner (counterpart of
``repro.streaming.cache``: the same file format, schema and keys, so a
cache either package writes reads in the other).

One JSON file maps a plan key — ``(op, shapes, k, dtype, backend)`` encoded
as a string — to the winning :class:`~repro_torch.streaming.planner.MergePlan`
fields plus the measured time. Writes are atomic (tmp file +
``os.replace``) so concurrent benchmark runs can never leave a torn file;
``save`` first merges entries another writer landed since our load (last
writer wins per key, nobody's keys are dropped). Reads tolerate a missing
file by starting empty; a *corrupt* file (torn write from a crashed
pre-atomic tool, disk garbage) is quarantined to a ``<path>.bad`` sidecar,
so the next run starts clean instead of crashing on the same bytes
forever (an autotune cache is always reconstructible). I/O failures in
``put``/``save`` degrade to in-memory-only operation rather than failing
the sort that triggered the write.

Entries are stamped with :data:`SCHEMA_VERSION`. ``get`` ignores entries
written under a different schema (or none): when the plan fields change
meaning across releases, stale entries silently degrade to a heuristic
re-plan instead of mis-parameterizing a kernel.

The default location is ``$REPRO_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json``. A key's platform tag is the
process's (``"cuda"`` with a card, else ``"cpu"``), as the reference's is
``jax.default_backend()``: a card's timings never rank against a host's.

Telemetry, when ``REPRO_OBS`` is on: the ``autotune.cache`` counter
(``op``, ``result``: hit / miss / stale_schema / quarantined /
load_failed / store_failed) and a ``quarantine`` recorder event, as in
the reference.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder

#: entry-format version; bump when MergePlan fields change meaning.
#: v2 added the fused-pipeline knobs (``block``) and the VMEM-fit
#: (non-divisor) block_batch semantics. v3 added the segmented size-class
#: plan family (``segmented|batch x widths`` keys, block_batch counting
#: segments per tile) — pre-segmented caches are ignored wholesale rather
#: than risking a dense-era entry mis-tiling a class launch. v4 added the
#: ``network`` field (the per-size-class family-tournament winner:
#: "loms" | "s2ms" | "periodic3" | "bitonic") — v3 entries were tuned
#: LOMS-only, so replaying them would silently pin every size class to
#: the column device and skip the tournament's measured choice.
SCHEMA_VERSION = 4


def default_cache_path() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"
    )


def platform() -> str:
    """The platform tag of this process's keys."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def plan_key(op: str, *, shapes, dtype, k: Optional[int] = None,
             backend: Optional[str] = None) -> str:
    """Stable string key for one tuning point.

    ``shapes`` is any nested int structure (list lengths + batch); ``k`` the
    truncation (top-k) if any; ``backend`` defaults to :func:`platform`."""
    if backend is None:
        backend = platform()
    shp = "x".join(str(int(s)) for s in _flat_ints(shapes))
    return f"{op}|{shp}|k{k if k is not None else '-'}|{dtype}|{backend}"


def _flat_ints(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _flat_ints(o)
    else:
        yield int(obj)


class AutotuneCache:
    """get/put dict-of-json-scalars entries keyed by :func:`plan_key`."""

    def __init__(self, path: Optional[str] = None, autosave: bool = True):
        self.path = path or default_cache_path()
        self.autosave = autosave
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.load()

    def load(self) -> None:
        self._entries = {}
        try:
            data = self._read_disk()
        except FileNotFoundError:
            return  # first run: nothing to load, nothing to report
        except ValueError:
            # corrupt JSON: quarantine the bytes and start empty — the
            # sidecar keeps the evidence without re-crashing every run
            self._quarantine()
            return
        except OSError:  # unreadable: the cache is reconstructible
            obs_metrics.counter("autotune.cache").inc(op="-", result="load_failed")
            return
        if isinstance(data, dict):
            self._entries = {str(k): dict(v) for k, v in data.items()
                             if isinstance(v, dict)}

    def _read_disk(self) -> Any:
        with open(self.path) as f:
            return json.load(f)

    def _quarantine(self) -> None:
        obs_metrics.counter("autotune.cache").inc(op="-", result="quarantined")
        obs_recorder.emit("quarantine", self.path, sidecar=self.path + ".bad")
        try:
            os.replace(self.path, self.path + ".bad")
        except OSError:
            pass  # racing writer already replaced it; nothing to keep

    def save(self) -> None:
        with self._lock:
            self._save_locked()

    def _save_locked(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # merge entries a concurrent writer landed since our load: ours
        # win per-key, theirs survive wholesale (corrupt on-disk state is
        # ignored here — load() owns quarantine)
        merged: Dict[str, Dict[str, Any]] = {}
        try:
            data = self._read_disk()
            if isinstance(data, dict):
                merged = {str(k): dict(v) for k, v in data.items()
                          if isinstance(v, dict)}
        except (OSError, ValueError):
            pass
        merged.update(self._entries)
        self._entries = merged
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._entries, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic swap
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._entries.get(key)
        # hit / miss / stale-schema telemetry: the op is the key's first
        # component (low-cardinality by construction)
        op = key.split("|", 1)[0]
        if entry is None:
            obs_metrics.counter("autotune.cache").inc(op=op, result="miss")
            return None
        if entry.get("_schema") != SCHEMA_VERSION:
            obs_metrics.counter("autotune.cache").inc(op=op, result="stale_schema")
            return None  # stale-schema entries degrade to a heuristic plan
        obs_metrics.counter("autotune.cache").inc(op=op, result="hit")
        return entry

    def put(self, key: str, value: Dict[str, Any]) -> None:
        with self._lock:
            self._entries[key] = dict(value, _schema=SCHEMA_VERSION)
            if not self.autosave:
                return
            try:
                self._save_locked()
            except OSError:  # keep tuning in memory
                obs_metrics.counter("autotune.cache").inc(
                    op=key.split("|", 1)[0], result="store_failed")

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries


_default: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    global _default
    if _default is None:
        _default = AutotuneCache()
    return _default


def set_default_cache(cache: Optional[AutotuneCache]) -> Optional[AutotuneCache]:
    """Swap the process-default cache (``None`` resets to lazy re-init).
    Returns the previous instance — tests point dispatch/planner lookups
    at a temp file without monkeypatching module internals."""
    global _default
    prev = _default
    _default = cache
    return prev
