"""The closed loop that drives ``ScheduledEngine`` and times it.

Every client sends its next request as soon as its previous one has ended,
right after the ``step()`` that ended it, with no think time. The clients
start before the window; the window opens once every client's first
request has ended, so the first wave's pile-up is not timed. It then runs
whole steps until ``seconds`` have passed: its length is the time from its
opening to the end of its last step, so every token the window counts was
made inside it. Past ``seconds`` it runs on until the requests ended in
it reach a whole number of the mix's blocks (at the crossing, the next
multiple of ``block``): where a step ends a block exactly, as in a
prefill pool, every seed's window does the same work in another order.
After it closes the clients send no more, and the engine steps on until
every request sent in the window holds its first token.

What the check judges is kept as the program made it, by reference (no
copy, no launch): the logits each token was drawn from, and the
candidate values the sampler's top-k returned for it.

A request's time to first token runs from its send to the return of the
``step()`` after which it holds that token, on the harness's own clock.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from .traffic import RequestSpec, RequestStream
from portbench.work import step_flops


@dataclasses.dataclass
class Rec:
    rid: int
    client: int
    spec: RequestSpec
    t_send: float
    arrival: int  # the engine tick it was submitted for
    t_first: Optional[float] = None
    t_end: Optional[float] = None
    n_seen: int = 0  # tokens seen after the last step
    state: str = "queued"


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    prompt_tokens: int  # real prompt tokens prefilled
    gen_tokens: int  # tokens made (a prefill's first token included)
    flops: float  # model FLOPs of the step (portbench.work)
    ticks: tuple  # the engine.tick_s entries of the step: (start, end)
    profiled: bool = False
    in_window: bool = False


class ClosedLoop:
    def __init__(self, engine, stream: RequestStream, clients: int, cfg: dict):
        from repro_torch.serving.scheduler import SamplingParams

        self.SamplingParams = SamplingParams
        self.engine = engine
        self.stream = stream
        self.clients = clients
        self.cfg = cfg
        self.recs: Dict[int, Rec] = {}
        self.open: Dict[int, Rec] = {}  # rid -> rec not yet ended
        self.steps: List[Step] = []
        self.sending = True
        self._next = 0
        self._ended = 0  # requests ended so far
        #: rid -> {token index: (V,) logits it was drawn from}
        self.logits: Dict[int, Dict[int, torch.Tensor]] = {}
        #: rid -> {token index: (k,) candidate values the sampler drew from}
        self.candidates: Dict[int, Dict[int, torch.Tensor]] = {}
        self._drawing = None  # [(rid, token index)] of the top-k call under way
        prefill, tile = engine._prefill_launch, engine._decode_tile
        first_token, decode = engine._first_token, engine._decode

        def launch(blen, reqs):
            logits, body = prefill(blen, reqs)
            for i, r in enumerate(reqs):
                self.logits.setdefault(r.rid, {})[0] = logits[i]
            return logits, body

        def decode_tile(slots, reqs):
            logits = tile(slots, reqs)
            for i, r in enumerate(reqs):
                self.logits.setdefault(r.rid, {})[len(r.tokens)] = logits[i]
            return logits

        def first_token_(row, r):
            self._drawing = [(r.rid, 0)]
            try:
                return first_token(row, r)
            finally:
                self._drawing = None

        def decode_(slots, reqs):
            self._drawing = [(r.rid, len(r.tokens)) for r in reqs if not r.params.greedy]
            try:
                return decode(slots, reqs)
            finally:
                self._drawing = None
        engine._prefill_launch = launch
        engine._decode_tile = decode_tile
        engine._first_token = first_token_
        engine._decode = decode_
        self._patched = []
        self._patch("repro_torch.serving.sample", "topk", self._topk_taker)
        self._patch("repro_torch.api", "segment_topk", self._segment_topk_taker)

    def _patch(self, mod_name: str, attr: str, make) -> None:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        self._patched.append((mod, attr, real))
        setattr(mod, attr, make(real))

    def close(self) -> None:
        """Take the module-level takers off again."""
        for mod, attr, real in reversed(self._patched):
            setattr(mod, attr, real)
        self._patched = []

    def _topk_taker(self, real):
        """The first token's top-k (``sample_topk``): (1, k) values."""
        def topk(x, k, *args, **kw):
            vals, idx = real(x, k, *args, **kw)
            if self._drawing is not None and len(self._drawing) == 1:
                rid, j = self._drawing[0]
                self.candidates.setdefault(rid, {})[j] = vals[0]
            return vals, idx
        return topk

    def _segment_topk_taker(self, real):
        """A decode step's one ``segment_topk`` over its sampled rows, in
        slot order: each row's k values."""
        def segment_topk(x, offsets, k, *args, **kw):
            vals, idx, out_offs = real(x, offsets, k, *args, **kw)
            if self._drawing is not None and len(self._drawing) == len(out_offs) - 1:
                for j, (rid, pos) in enumerate(self._drawing):
                    self.candidates.setdefault(rid, {})[pos] = vals[out_offs[j]:out_offs[j + 1]]
            return vals, idx, out_offs
        return segment_topk

    def send(self, client: int) -> Rec:
        spec = self.stream.spec(self._next)
        self._next += 1
        params = self.SamplingParams(k=spec.k, temperature=spec.temperature,
                                     max_new_tokens=spec.max_new_tokens, seed=spec.seed)
        arrival = self.engine.t
        rid = self.engine.submit(self.stream.tokens(spec), params, arrival=arrival)
        rec = Rec(rid=rid, client=client, spec=spec, t_send=time.perf_counter(),
                  arrival=arrival)
        self.recs[rid] = rec
        self.open[rid] = rec
        return rec

    def step(self, profiled: bool = False) -> Step:
        from repro_torch.serving.scheduler import RequestState

        eng = self.engine
        n_ticks = len(eng.tick_s)
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        prompt, gen, prefills, contexts = 0, 0, [], []
        ended = []
        for rid, rec in list(self.open.items()):
            r = eng.requests[rid]
            n = len(r.tokens)
            if n > rec.n_seen:
                if rec.n_seen == 0:
                    rec.t_first = t1
                    prompt += rec.spec.prompt_len
                    prefills.append(rec.spec.prompt_len)
                # token j >= 1 came from a decode step over prompt + j keys
                contexts += [rec.spec.prompt_len + j for j in range(max(rec.n_seen, 1), n)]
                gen += n - rec.n_seen
                rec.n_seen = n
            if r.state not in (RequestState.QUEUED, RequestState.RUNNING):
                rec.state = r.state.value
                rec.t_end = t1
                ended.append(rec)
                del self.open[rid]
        self._ended += len(ended)
        st = Step(t0=t0, t1=t1, prompt_tokens=prompt, gen_tokens=gen,
                  flops=step_flops(self.cfg, prefills, contexts),
                  ticks=(n_ticks, len(eng.tick_s)), profiled=profiled)
        self.steps.append(st)
        if self.sending:
            for rec in ended:
                self.send(rec.client)
        return st

    def run(self, seconds: float, on_window_open: Callable[[], None] = lambda: None,
            profile: Optional[Callable] = None, profile_at: float = 0.3,
            profile_steps: int = 0, block: int = 1) -> dict:
        """Fill, then the window of ``seconds`` and whole blocks of
        ``block`` requests (the module docstring), then the requests sent
        in it up to their first token. ``profile(step)`` runs
        ``profile_steps`` calls of ``step`` under the profiler, at the first
        step after ``profile_at`` of the window with a request waiting to
        be prefilled."""
        first = [self.send(c) for c in range(self.clients)]
        while any(r.rid in self.open for r in first):
            self.step()
        t_open = self.steps[-1].t1  # the clients' next sends fall in the window
        ended_open = self._ended
        target = None  # requests to end in the window, set once ``seconds`` have passed
        on_window_open()
        profiled = profile is None or profile_steps <= 0
        while True:
            if (not profiled and len(self.engine.queue)
                    and time.perf_counter() - t_open >= profile_at * seconds):
                profiled = True
                profile(lambda: self.step(profiled=True))
                for st in self.steps[-profile_steps:]:
                    st.in_window = True
            else:
                self.step().in_window = True
            ended = self._ended - ended_open
            if target is None and self.steps[-1].t1 - t_open >= seconds:
                target = max(1, math.ceil(ended / block)) * block
            if target is not None and ended >= target:
                break
        t_close = self.steps[-1].t1
        self.sending = False
        sent = [r for r in self.recs.values() if t_open <= r.t_send < t_close]
        ended = [r for r in self.recs.values()
                 if r.t_end is not None and t_open < r.t_end <= t_close]
        while any(r.t_first is None and r.rid in self.open for r in sent):
            self.step()
        return {"t_open": t_open, "t_close": t_close, "sent": sent, "ended": ended}


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at
    least ``q`` of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def window_stats(loop: ClosedLoop, window: dict) -> dict:
    """The end-to-end numbers of the window: every request sent in it
    (one that ended without a first token counts as infinitely late) and
    all the work of all its steps over all its time."""
    sent = window["sent"]
    ttft = [(r.t_first - r.t_send) if r.t_first is not None else math.inf for r in sent]
    steps = [s for s in loop.steps if s.in_window]
    window_s = window["t_close"] - window["t_open"]
    tokens = sum(s.prompt_tokens + s.gen_tokens for s in steps)
    failed = sum(1 for r in sent if r.t_first is None or r.state in
                 ("failed", "timed_out", "rejected"))
    return {"attempted": len(sent), "failed": failed, "window_s": window_s,
            "ttft_s": ttft, "ttft_p90_s": nearest_rank(ttft, 0.9) if ttft else math.inf,
            "tokens": tokens, "tok_per_s": tokens / window_s,
            "steps": len(steps), "prompt_tokens": sum(s.prompt_tokens for s in steps),
            "gen_tokens": sum(s.gen_tokens for s in steps)}


def unprofiled(loop: ClosedLoop) -> List[Step]:
    """The window's steps the profiler did not slow."""
    return [s for s in loop.steps if s.in_window and not s.profiled]
