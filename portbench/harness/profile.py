"""The traced run's ranges and its reading of the profiler.

:class:`Ranges` wraps calls into the program's layers, from outside, in a
``torch.profiler.record_function`` range each, and times each call on the
host: attention (``attention.prefill`` / ``attention.decode``), the MoE
router and expert products, the sampler's top-k. It also notes the rows
of every vocab top-k kernel launch while the profiler runs, so the
kernels' roofline has its bytes. The scheduler's own spans
(``sched.prefill``, ``sched.decode``) are ranges too when ``REPRO_OBS``
is on.

:func:`read_profile` reduces a profile to what the per-layer metrics and
the ``breakdown`` read: each kernel's device time, the union of the
device's busy intervals over the profiled stretch, each range's device
time (its busy time inside the range's mark on the device timeline),
and the device's idle gaps named by the innermost range that was open on
the host during each.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import time
from typing import Dict, List, Optional, Tuple

STRETCH = "portbench.stretch"
STEP = "engine.step"
#: (module, attribute, label); label None: attention, by its mode
WRAPPED = (
    ("repro_torch.models.transformer", "attn_apply", None),
    ("repro_torch.models.moe", "router_topk", "moe.router_topk"),
    ("repro_torch.models.moe", "_expert_ffn", "moe.expert_ffn"),
    ("repro_torch.api", "segment_topk", "sampler.segment_topk"),
    ("repro_torch.serving.scheduler.engine", "sample_topk", "sampler.sample_topk"),
)
SPANS = ("sched.prefill", "sched.decode")
RANGE_PREFIXES = ("attention.", "moe.", "sampler.", "sched.", "engine.", "portbench.")


@dataclasses.dataclass
class HostTimes:
    calls: int = 0
    seconds: float = 0.0


class Ranges:
    """The wrappers, installed for the whole traced run (``close`` takes
    them off). ``profiling`` is set while the profiler runs: the host
    times leave those calls out, and vocab top-k launches are noted."""

    def __init__(self):
        from torch.profiler import record_function

        self.record_function = record_function
        self.profiling = False
        #: label -> host times of the calls outside the profiled stretch
        self.host: Dict[str, HostTimes] = {}
        #: (rows, width, itemsize, k) of each vocab top-k launch profiled
        self.vocab_launches: List[Tuple[int, int, int, int]] = []
        self._saved = []
        for mod_name, attr, label in WRAPPED:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            self._saved.append((mod, attr, real))
            setattr(mod, attr, self._wrap(real, label))
        topk = importlib.import_module("repro_torch.kernels.topk")
        real = topk.vocab_phase1
        self._saved.append((topk, "vocab_phase1", real))

        def phase1(x, k, *args, **kw):
            if self.profiling:
                self.vocab_launches.append((int(x.shape[0]), int(x.shape[1]),
                                            int(x.element_size()), int(k)))
            return real(x, k, *args, **kw)
        topk.vocab_phase1 = phase1

    def reset(self) -> None:
        """Forget the host times so far (the window opens)."""
        self.host.clear()

    def _wrap(self, fn, label):
        def wrapped(*args, **kw):
            name = label or f"attention.{kw.get('mode', 'train')}"
            t0 = time.perf_counter()
            with self.record_function(name):
                out = fn(*args, **kw)
            if not self.profiling:
                h = self.host.setdefault(name, HostTimes())
                h.calls += 1
                h.seconds += time.perf_counter() - t0
            return out
        return wrapped

    def close(self) -> None:
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []


def profile_stretch(ranges: Ranges, run_steps) -> "ProfileReading":
    """``run_steps()`` under ``torch.profiler`` (host and device), the
    device synchronised at both ends; the reading of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        ranges.profiling = True
        with ranges.record_function(STRETCH):
            run_steps()
            sync()
        ranges.profiling = False
    return read_profile(prof, set(SPANS) | {STRETCH, STEP})


@dataclasses.dataclass
class ProfileReading:
    window_s: float  # the stretch on the profiler's timeline
    busy_s: float  # union of the device's intervals in it
    kernel_s: Dict[str, float]  # device seconds by kernel name
    range_device_s: Dict[str, float]  # device seconds of the kernels under a range
    idle_by_range: Dict[str, float]  # idle device seconds by the host range open

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:n]]


def _is_range(name: str, labels) -> bool:
    return name in labels or name.startswith(RANGE_PREFIXES)


def _busy_within(merged: List[Tuple[float, float]], starts: List[float], a: float,
                 b: float) -> float:
    """The device's busy time inside [a, b]: ``merged`` is the union of the
    kernels' intervals, sorted, ``starts`` their starts."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        total += max(hi - lo, 0.0)
        i += 1
    return total


def read_profile(prof, span_names) -> ProfileReading:
    """A range's device time is the device's busy time inside the range's
    own mark on the device timeline (from its first kernel's start to its
    last one's end; one stream, so no other range's kernels run there)."""
    from torch.autograd import DeviceType

    labels = set(span_names)
    kernels: List[Tuple[float, float]] = []
    kernel_s: Dict[str, float] = {}
    host: List[Tuple[float, float, str]] = []
    marks: List[Tuple[float, float, str]] = []
    stretch: Optional[Tuple[float, float]] = None
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if _is_range(ev.name, labels):  # a range's mark on the device timeline
                marks.append((tr.start, tr.end, ev.name))
                continue
            kernels.append((tr.start, tr.end))
            kernel_s[ev.name] = kernel_s.get(ev.name, 0.0) + (tr.end - tr.start) * 1e-6
        elif ev.device_type == DeviceType.CPU and _is_range(ev.name, labels):
            if ev.name == STRETCH:
                stretch = (tr.start, tr.end)
            else:
                host.append((tr.start, tr.end, ev.name))
    if stretch is None and kernels:
        stretch = (min(a for a, _ in kernels), max(b for _, b in kernels))
    if stretch is None:
        return ProfileReading(0.0, 0.0, {}, {}, {})
    lo, hi = stretch
    busy, gaps, merged = _busy_and_gaps(kernels, lo, hi)
    starts = [a for a, _ in merged]
    range_device_s: Dict[str, float] = {}
    for a, b, name in marks:
        range_device_s[name] = range_device_s.get(name, 0.0) + _busy_within(
            merged, starts, a, b) * 1e-6
    return ProfileReading(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, kernel_s=kernel_s,
                          range_device_s=range_device_s, idle_by_range=_name_gaps(gaps, host))


def _busy_and_gaps(kernels, lo: float, hi: float):
    """The union of the intervals clipped to [lo, hi]: its length, the gaps
    between its pieces, and the pieces."""
    busy, gaps, merged, cur = 0.0, [], [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in kernels if b > lo and a < hi):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps, merged


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host range open at each gap's middle
    (ranges nest on the one host thread); "(none)" outside them all."""
    points = sorted([(a, 0, i) for i, (a, _, _) in enumerate(host)]
                    + [((a + b) / 2, 1, j) for j, (a, b) in enumerate(gaps)])
    out: Dict[str, float] = {}
    stack: List[int] = []
    for t, kind, i in points:
        while stack and host[stack[-1]][1] < t:
            stack.pop()
        if kind == 0:
            stack.append(i)
            continue
        name = host[stack[-1]][2] if stack else "(none)"
        a, b = gaps[i]
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out
