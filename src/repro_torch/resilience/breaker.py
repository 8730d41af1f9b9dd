"""Per-(op, rung, shape-class) circuit breakers of the degradation ladder
(counterpart of ``repro.resilience.breaker``).

A breaker guards one *rung* of the ladder (``"fused"``, ``"cuda"``,
``"streaming"``, ...) for one op at one shape class:

* **closed**: healthy, every call flows; ``threshold`` consecutive
  recorded failures (default :data:`DEFAULT_THRESHOLD`) open it;
* **open**: the rung is skipped at plan time (``plan()`` reroutes down
  the ladder, ``source="breaker"``) and at run time; after ``cooldown_s``
  the next :meth:`CircuitBreaker.allow` is the half-open probe;
* **half-open**: one probe goes through; its success closes the breaker
  (failures reset), its failure opens it for another cooldown. Calls
  during the probe stay rerouted.

Shape classes bucket problems by the pow2 ceiling of the total element
count and payload / plain, so one bad shape neither poisons nor hides
every other size while the count of breakers stays bounded. Transitions
surface as the ``breaker.state`` gauge (0 closed, 1 open, 2 half-open),
the ``breaker.transitions`` counter and a ``breaker`` recorder event when
``REPRO_OBS`` is on.

The registry starts empty and a breaker is made at the first recorded
*failure*: a healthy process pays one dict lookup a plan. The clock is
:func:`now`, one function, so a test drives the cooldown without
sleeping.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 30.0

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_NUM = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def now() -> float:
    """The breakers' clock (seconds, monotonic)."""
    return time.monotonic()


def shape_class(total: int, has_payload: bool) -> str:
    """Bounded-cardinality shape bucket: the pow2 ceiling of the total
    element count, then ``p`` (payload) or ``v`` (values only)."""
    p2 = 1
    while p2 < max(int(total), 1):
        p2 <<= 1
    return f"{p2}{'p' if has_payload else 'v'}"


class CircuitBreaker:
    def __init__(self, key: Tuple[str, str, str], threshold: int = DEFAULT_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        self.key = key  # (op, rung, shape_class)
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """Whether a call may take this rung now. The first call past the
        cooldown is the half-open probe and is let through; the calls
        after it stay blocked until the probe reports."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN and now() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
                return True
            return False

    def peek(self) -> bool:
        """:meth:`allow` without its effect: plan-time rerouting peeks, so
        it never takes the probe's place."""
        with self._lock:
            if self.state == CLOSED:
                return True
            return self.state == OPEN and now() - self.opened_at >= self.cooldown_s

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == HALF_OPEN or (self.state == CLOSED
                                           and self.failures >= self.threshold):
                self.opened_at = now()
                self._transition(OPEN)

    def record_success(self) -> None:
        with self._lock:
            if self.state != CLOSED or self.failures:
                self.failures = 0
                self._transition(CLOSED)

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import recorder as obs_recorder

        op, rung, cls = self.key
        obs_metrics.gauge("breaker.state").set(_STATE_NUM[state], op=op, rung=rung, cls=cls)
        obs_metrics.counter("breaker.transitions").inc(op=op, rung=rung, cls=cls, frm=prev,
                                                       to=state)
        obs_recorder.emit("breaker", f"{op}/{rung}/{cls}", frm=prev, to=state,
                          failures=self.failures)


_reg_lock = threading.Lock()
_registry: Dict[Tuple[str, str, str], CircuitBreaker] = {}
_threshold = DEFAULT_THRESHOLD
_cooldown_s = DEFAULT_COOLDOWN_S


def breaker_for(op: str, rung: str, cls: str, create: bool = True) -> Optional[CircuitBreaker]:
    """The breaker guarding (op, rung, cls); ``create=False`` gives None
    instead of making one (the plan-time path)."""
    key = (op, rung, cls)
    with _reg_lock:
        br = _registry.get(key)
        if br is None and create:
            br = _registry[key] = CircuitBreaker(key, _threshold, _cooldown_s)
        return br


def rung_allowed(op: str, rung: str, cls: str) -> bool:
    """Plan-time check: True unless an existing breaker blocks the rung.
    Makes no breaker and changes none (:meth:`CircuitBreaker.peek`)."""
    br = breaker_for(op, rung, cls, create=False)
    return True if br is None else br.peek()


def any_breakers() -> bool:
    """Whether any breaker exists: the healthy path's short cut."""
    return bool(_registry)


def configure(threshold: Optional[int] = None, cooldown_s: Optional[float] = None) -> None:
    """The threshold and cooldown of breakers made after this call."""
    global _threshold, _cooldown_s
    if threshold is not None:
        _threshold = int(threshold)
    if cooldown_s is not None:
        _cooldown_s = float(cooldown_s)


def reset() -> None:
    """Drop every breaker and restore the default threshold and cooldown."""
    global _threshold, _cooldown_s
    with _reg_lock:
        _registry.clear()
    _threshold = DEFAULT_THRESHOLD
    _cooldown_s = DEFAULT_COOLDOWN_S


def states() -> Dict[Tuple[str, str, str], str]:
    """Every existing breaker's state."""
    with _reg_lock:
        return {k: br.state for k, br in _registry.items()}
