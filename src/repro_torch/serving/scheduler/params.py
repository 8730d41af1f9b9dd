"""Per-request sampling parameters (a copy of
``repro.serving.scheduler.params``).

``greedy`` and ``topp_active`` mirror the solo path's shortcuts exactly,
so a scheduled request draws as ``generate`` draws it alone. ``seed``
seeds the request's own ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request samples. Mirrors the knobs of
    :class:`repro_torch.serving.engine.ServeConfig` at per-request granularity."""

    k: int = 64
    top_p: float = 1.0
    temperature: float = 1.0
    max_new_tokens: int = 16
    seed: int = 0
    #: wall-clock deadline from ``submit()``: the request times out (slot
    #: and pages reclaimed) once this many milliseconds have elapsed —
    #: whether still queued or mid-decode. Wall time is inherently
    #: non-deterministic; chaos tests use ``ttl_ticks`` instead.
    deadline_ms: Optional[float] = None
    #: virtual-tick TTL: the request times out once
    #: ``tick - arrival >= ttl_ticks``. Deterministic under the
    #: scheduler's tick clock — the replayable deadline for tests.
    ttl_ticks: Optional[int] = None

    def __post_init__(self):
        assert self.k >= 1, self.k
        assert 0.0 < self.top_p <= 1.0, self.top_p
        assert self.max_new_tokens >= 1, self.max_new_tokens
        assert self.deadline_ms is None or self.deadline_ms > 0, self.deadline_ms
        assert self.ttl_ticks is None or self.ttl_ticks >= 1, self.ttl_ticks

    @property
    def greedy(self) -> bool:
        """Mirrors ``sample_topk``'s argmax shortcut (``temperature <= 0``
        or ``k == 1``) so scheduler draws match the solo path exactly."""
        return self.temperature <= 0.0 or self.k == 1

    @property
    def topp_active(self) -> bool:
        """Whether the nucleus mask applies — must mirror the solo path's
        ``top_p if top_p < 1.0 else None`` (p=1.0 with float-rounded
        cumsums could otherwise mask real lanes and change the draw)."""
        return not self.greedy and self.top_p < 1.0

