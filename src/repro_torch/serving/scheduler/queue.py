"""FIFO admission queue ordered by (arrival tick, request id) (a copy of
``repro.serving.scheduler.queue``).

Admission is head-of-line blocking on purpose: if the oldest arrived
request does not fit (no free slot / pages), nothing younger jumps it.
That makes the admission order — and therefore every compiled batch
composition — a pure function of the arrival trace, which the
determinism tests rely on.

Backpressure (DESIGN.md §16): construct with ``max_queue`` to bound the
depth — ``push`` past the bound raises :class:`QueueFull` instead of
letting an overload grow the queue (and every queued deadline slip)
without limit. Deadline-expired queued requests are removed wholesale
with :func:`drain_expired`, which preserves the FIFO order of the
survivors.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional

from .request import Request


class QueueFull(RuntimeError):
    """Load-shed signal: the admission queue is at ``max_queue``.

    Carries the observed ``depth`` and bound, plus ``retry_after_ticks``
    — a hint of how many scheduler ticks until space is plausible (the
    caller backs off instead of hammering submit)."""

    def __init__(self, depth: int, max_queue: int,
                 retry_after_ticks: int = 1):
        super().__init__(
            f"admission queue full ({depth}/{max_queue}); "
            f"retry after ~{retry_after_ticks} tick(s)")
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_ticks = retry_after_ticks


class AdmissionQueue:
    def __init__(self, max_queue: Optional[int] = None):
        assert max_queue is None or max_queue >= 1, max_queue
        self.max_queue = max_queue
        self._heap: List[tuple] = []

    def push(self, req: Request) -> None:
        if self.max_queue is not None and len(self._heap) >= self.max_queue:
            raise QueueFull(len(self._heap), self.max_queue)
        heapq.heappush(self._heap, (req.arrival, req.rid, req))

    def peek(self) -> Optional[Request]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def next_arrival(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def drain_expired(self, expired: Callable[[Request], bool]) -> List[Request]:
        """Remove and return every queued request for which ``expired``
        holds; the survivors keep their (arrival, rid) order."""
        out = [req for _, _, req in self._heap if expired(req)]
        if out:
            self._heap = [e for e in self._heap if not expired(e[2])]
            heapq.heapify(self._heap)
        return sorted(out, key=lambda r: (r.arrival, r.rid))

    def __len__(self) -> int:
        return len(self._heap)
