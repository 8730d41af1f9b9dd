"""The request scheduler of the port (counterpart of
``repro.serving.scheduler``).

An admission queue feeds prefill; each admitted request gets a
page-granular KV-cache slot from a fixed pool; one decode step per tick
advances every occupied slot and draws every sampling request's next token
from one ``segment_topk`` call. Each request's tokens equal running it
alone through :func:`repro_torch.serving.engine.generate` with
``cache_len`` equal to the slot capacity (DESIGN.md §14).
"""
from .engine import ScheduledEngine, SchedulerConfig  # noqa: F401
from .paged import PagedKVCache, SlotManager  # noqa: F401
from .params import SamplingParams  # noqa: F401
from .queue import AdmissionQueue, QueueFull  # noqa: F401
from .request import TERMINAL_STATES, Request, RequestState  # noqa: F401
