"""Deterministic fault injection: named failpoints at the risky seams
(counterpart of ``repro.resilience.failpoints``: the same names, trigger
grammar and environment variable).

A *failpoint* is a named call site (``failpoint("kernel.launch.sort")``)
threaded through the places where the stack can die in production: the
kernel launch wrappers, the fused rungs, the schedule executor's
adapters, autotune-cache I/O, the grid merge, the segmented spills, and
the scheduler's prefill / insert / decode. Disarmed (the default) every
call is one truthiness check on an empty dict: no allocation, no RNG
draw, nothing on the device.

Armed, a failpoint raises :class:`FailpointError` according to its
*trigger*, each deterministic given the arming spec:

=============  ========================================================
``once``       fire on the first hit, then never again
``always``     fire on every hit
``times:N``    fire on the first N hits
``every:N``    fire on every Nth hit (N, 2N, ...)
``p:P[:S]``    fire with probability P a hit: one draw of
               ``random.Random(S)`` (S defaults to 0) a hit, so a hit
               sequence fires on the same hits in every run and in both
               packages
``off``        never fire (still counts hits)
=============  ========================================================

Arming comes from ``REPRO_FAILPOINTS`` (``"name=trigger,name=trigger"``,
parsed once at import) or from the context manager::

    with failpoints({"kernel.launch": "once", "cache.load": "p:0.5:7"}):
        ...

which nests and restores the previous arming, counters included. Names
match hierarchically on dot boundaries: arming ``kernel.launch`` arms
``kernel.launch.sort`` and ``kernel.launch.topk``, and an exact arming
wins over a prefix. :func:`hits` and :func:`fires` read the counters; a
fire also bumps the ``failpoints.fired`` counter and emits a
``failpoint`` recorder event when ``REPRO_OBS`` is on.

A seam sits on the host, before the launch it guards: it never runs
inside a captured CUDA graph's region in a way that changes what is
captured, and a fire leaves the inputs untouched, so a retry sees them
whole.
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Dict, Iterator, Optional

_ENV = "REPRO_FAILPOINTS"


class FailpointError(RuntimeError):
    """The injected failure; ``name`` is the seam that fired, so handlers
    and tests tell an injected fault from a genuine one."""

    def __init__(self, name: str):
        super().__init__(f"injected failpoint {name!r} fired")
        self.name = name


class _Failpoint:
    """One armed failpoint: a trigger and its hit / fire counters."""

    __slots__ = ("name", "mode", "arg", "seed", "hits", "fires", "_rng")

    def __init__(self, name: str, spec: str):
        self.name = name
        parts = str(spec).split(":")
        self.mode = parts[0]
        self.arg = 0.0
        self.seed = 0
        if self.mode in ("times", "every"):
            self.arg = int(parts[1])
            if self.arg < 1:
                raise ValueError(f"failpoint trigger {spec!r} needs N >= 1")
        elif self.mode == "p":
            self.arg = float(parts[1])
            if not 0.0 <= self.arg <= 1.0:
                raise ValueError(f"failpoint trigger {spec!r} needs 0 <= P <= 1")
            self.seed = int(parts[2]) if len(parts) > 2 else 0
        elif self.mode not in ("once", "always", "off"):
            raise ValueError(
                f"unknown failpoint trigger {spec!r} for {name!r} "
                "(want once|always|times:N|every:N|p:P[:seed]|off)")
        self.hits = 0
        self.fires = 0
        self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        self.hits += 1
        if self.mode == "off":
            return False
        if self.mode == "always":
            return True
        if self.mode == "once":
            return self.hits == 1
        if self.mode == "times":
            return self.hits <= self.arg
        if self.mode == "every":
            return self.hits % int(self.arg) == 0
        return self._rng.random() < self.arg  # "p": one seeded draw a hit


_lock = threading.Lock()
#: the armed set; empty means disabled (the hot-path predicate)
_active: Dict[str, _Failpoint] = {}


def _parse_env() -> None:
    raw = os.environ.get(_ENV, "").strip()
    for item in raw.split(","):
        name, _, spec = item.strip().partition("=")
        if name.strip():
            _active[name.strip()] = _Failpoint(name.strip(), spec.strip() or "once")


_parse_env()


def _lookup(name: str) -> Optional[_Failpoint]:
    """The arming that covers ``name``: its own, else the longest armed
    prefix on a dot boundary."""
    n = name
    while True:
        fp = _active.get(n)
        if fp is not None:
            return fp
        cut = n.rfind(".")
        if cut < 0:
            return None
        n = n[:cut]


def failpoint(name: str) -> None:
    """The seam: raise :class:`FailpointError` if ``name`` is armed and its
    trigger fires. A no-op when nothing is armed."""
    if not _active:
        return
    with _lock:
        fp = _lookup(name)
        if fp is None or not fp.should_fire():
            return
        fp.fires += 1
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import recorder as obs_recorder

    obs_metrics.counter("failpoints.fired").inc(name=fp.name)
    obs_recorder.emit("failpoint", name, armed_as=fp.name, fire=fp.fires)
    raise FailpointError(name)


def arm(name: str, spec: str = "once") -> None:
    """Arm one failpoint (the environment's trigger grammar)."""
    with _lock:
        _active[name] = _Failpoint(name, spec)


def disarm(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def reset() -> None:
    """Disarm everything (does not read the environment again)."""
    with _lock:
        _active.clear()


def active() -> Dict[str, str]:
    """The armed failpoints as ``{name: mode}``."""
    with _lock:
        return {n: fp.mode for n, fp in _active.items()}


def hits(name: str) -> int:
    """Times the failpoint armed as ``name`` was reached."""
    with _lock:
        fp = _active.get(name)
        return fp.hits if fp else 0


def fires(name: str) -> int:
    """Times the failpoint armed as ``name`` raised."""
    with _lock:
        fp = _active.get(name)
        return fp.fires if fp else 0


@contextlib.contextmanager
def failpoints(specs: Dict[str, str]) -> Iterator[None]:
    """Arm ``{name: trigger}`` for the body; the previous arming, its
    counters included, comes back on exit."""
    with _lock:
        saved = dict(_active)
        for name, spec in specs.items():
            _active[name] = _Failpoint(name, spec)
    try:
        yield
    finally:
        with _lock:
            _active.clear()
            _active.update(saved)
