"""Request lifecycle state (a copy of ``repro.serving.scheduler.request``;
DESIGN.md §14, §16): QUEUED → RUNNING → DONE, plus the three failure
terminals.

Prefill + slot insert happen within one scheduler tick, so there is no
separate PREFILL state — a request is QUEUED until its cache row lands
in a slot, RUNNING while the slot decodes, DONE after eviction. The
failure terminals (each releasing any held slot and pages):

* **TIMED_OUT** — the request's ``deadline_ms`` / ``ttl_ticks`` elapsed,
  queued or running;
* **FAILED** — prefill/insert/decode exhausted the engine's bounded
  retries (``error`` records why);
* **REJECTED** — load-shed at ``submit()``: the admission queue was at
  ``max_queue`` (the raised :class:`~.queue.QueueFull` carries a
  retry-after hint).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from .params import SamplingParams


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    TIMED_OUT = "timed_out"
    FAILED = "failed"
    REJECTED = "rejected"


#: states a request can never leave (everything but QUEUED / RUNNING)
TERMINAL_STATES = frozenset({RequestState.DONE, RequestState.TIMED_OUT,
                             RequestState.FAILED, RequestState.REJECTED})


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    params: SamplingParams
    arrival: int = 0  # virtual tick (admission is tick-deterministic)
    #: per-request trace id (engine-assigned at submit): groups this
    #: request's stage spans (queue-wait → prefill → insert → decode
    #: ticks) in the obs export so TTFT and tail latency decompose into
    #: named stages (DESIGN.md §17)
    trace_id: str = ""

    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    #: generated tokens (first one sampled from the prefill logits)
    tokens: List[int] = dataclasses.field(default_factory=list)
    #: cache depth: positions filled in the slot so far
    length: int = 0
    #: the request's own generator (seeded with ``params.seed``): it draws
    #: the same noise, in the same order, as a solo ``generate``
    generator: Optional[object] = None

    # wall-clock latency markers (metrics only; never affect scheduling —
    # except deadline_ms, which is wall-clock by definition)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0
    # ns twins on the perf_counter_ns clock, shared with the span tracer
    # so per-request stage spans reconcile *exactly* (integer ns) with
    # the measured TTFT / request latency
    t_submit_ns: int = 0
    t_first_ns: int = 0
    t_finish_ns: int = 0
    admit_tick: int = -1
    finish_tick: int = -1
    #: why a FAILED/TIMED_OUT/REJECTED request ended (human-readable)
    error: Optional[str] = None

    def expired(self, tick: int, now: float) -> bool:
        """Whether the deadline has passed at virtual ``tick`` / wall
        ``now`` (perf_counter seconds)."""
        p = self.params
        if p.ttl_ticks is not None and tick - self.arrival >= p.ttl_ticks:
            return True
        return (p.deadline_ms is not None and self.t_submit > 0.0
                and (now - self.t_submit) * 1e3 >= p.deadline_ms)
