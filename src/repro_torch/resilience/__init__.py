"""The resilience layer (counterpart of ``repro.resilience``):
deterministic fault injection, the degradation ladder, circuit breakers.

* :mod:`.failpoints`: named, seeded fault-injection seams
  (``REPRO_FAILPOINTS`` or the :func:`failpoints` context manager) at the
  kernel launches, the fused rungs, the schedule executor, autotune-cache
  I/O, the grid merge, the segmented spills and the scheduler; a no-op
  when nothing is armed.
* :mod:`.breaker`: per-(op, rung, shape-class) circuit breakers:
  failures open, cooldown, half-open probe, close.
* :mod:`.ladder`: the ladder the unified ops run through, fused → cuda →
  streaming → schedule → lax; ``REPRO_RESILIENCE=0`` turns it off. Its
  docstring states what a fallback answers.
"""
from .breaker import (CircuitBreaker, breaker_for, rung_allowed,  # noqa: F401
                      shape_class)
from .breaker import configure as configure_breakers  # noqa: F401
from .breaker import reset as reset_breakers  # noqa: F401
from .breaker import states as breaker_states  # noqa: F401
from .failpoints import (FailpointError, arm, disarm, failpoint, failpoints,  # noqa: F401
                         fires, hits)
from .failpoints import reset as reset_failpoints  # noqa: F401
from .ladder import (LadderSkip, ResilienceExhausted, reroute,  # noqa: F401
                     resilience_enabled, run_ladder, rungs_for, set_resilience_enabled)

__all__ = [
    "CircuitBreaker", "FailpointError", "LadderSkip", "ResilienceExhausted",
    "arm", "breaker_for", "breaker_states", "configure_breakers", "disarm",
    "failpoint", "failpoints", "fires", "hits", "reroute",
    "reset_breakers", "reset_failpoints", "resilience_enabled", "run_ladder",
    "rungs_for", "rung_allowed", "set_resilience_enabled", "shape_class",
]
