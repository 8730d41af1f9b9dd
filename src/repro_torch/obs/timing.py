"""The one timing helper (counterpart of ``repro.obs.timing``; DESIGN.md
§13).

* :func:`time_jitted`: warm up, then measure ``iters`` synchronised
  calls and report p50/p95/p99 (plus mean/min/max and the raw samples).
  The planner's autotune tournament times its candidates with it.
* :func:`time_once`: one synchronised call, for code that times real
  work as it happens (``generate``'s prefill, decode and steps) rather
  than re-running it.

Both synchronise on the devices of the *returned* tensors
(``torch.cuda.synchronize`` for each card among them; the reference's
``jax.block_until_ready``), so the measured interval covers device
execution, not just the launches. A result that holds no card tensor
(CPU work) needs no synchronise. When observability is on,
:func:`time_jitted` also emits a ``run`` span so timings land in the
export.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from . import metrics
from .trace import span


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Percentile summary of one measured callable (microseconds)."""

    n: int
    mean_us: float
    p50_us: float
    p95_us: float
    p99_us: float
    min_us: float
    max_us: float
    samples_us: Tuple[float, ...] = ()

    @property
    def p50_s(self) -> float:
        return self.p50_us * 1e-6

    def to_row(self, prefix: str = "") -> dict:
        """A benchmark row fragment: p50/p95/p99 stamped columns."""
        return {
            f"{prefix}p50_us": round(self.p50_us, 1),
            f"{prefix}p95_us": round(self.p95_us, 1),
            f"{prefix}p99_us": round(self.p99_us, 1),
        }

    @classmethod
    def from_samples(cls, samples_s: Sequence[float]) -> "TimingStats":
        us = np.asarray(samples_s, np.float64) * 1e6
        assert us.size, "at least one sample required"
        return cls(
            n=int(us.size),
            mean_us=float(us.mean()),
            p50_us=float(np.percentile(us, 50)),
            p95_us=float(np.percentile(us, 95)),
            p99_us=float(np.percentile(us, 99)),
            min_us=float(us.min()),
            max_us=float(us.max()),
            samples_us=tuple(float(x) for x in us),
        )


def _tensors(tree):
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif hasattr(tree, "device") and hasattr(tree, "is_cuda"):
        yield tree


def block_until_ready(result):
    """Wait for the cards that hold the tensors of ``result`` (a tensor
    or tuples, lists and dicts of them); returns ``result``."""
    devices = {t.device for t in _tensors(result) if t.is_cuda}
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)
    return result


def time_jitted(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    name: Optional[str] = None,
    **kwargs,
) -> TimingStats:
    """Measure a callable: warm up, then ``iters`` host-timed
    synchronised calls. Returns percentile stats in µs.

    ``name`` (optional) tags the emitted span and feeds the
    ``timing.<name>`` histogram so repeated measurements accumulate."""
    for _ in range(max(warmup, 0)):
        block_until_ready(fn(*args, **kwargs))
    samples = []
    with span(f"timing.{name}" if name else "timing", kind="run",
              iters=iters):
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            block_until_ready(fn(*args, **kwargs))
            samples.append(time.perf_counter() - t0)
    stats = TimingStats.from_samples(samples)
    if name:
        metrics.histogram(f"timing.{name}").observe(stats.p50_us)
    return stats


def time_once(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """One synchronised call: returns ``(result, seconds)``.

    Synchronises on every card that holds a tensor of the result, so the
    duration covers device execution."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    block_until_ready(result)
    return result, time.perf_counter() - t0
