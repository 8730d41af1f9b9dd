"""Scheduled serving engine: admit -> prefill -> slot insert ->
continuous-batching decode, bit-identical per request to a solo
``generate``.

Counterpart of ``repro.serving.scheduler.engine``. One scheduler tick
expires requests past their ``ttl_ticks`` / ``deadline_ms``, admits
everything that has arrived (FIFO with head-of-line blocking), prefills
and inserts the admissions, then runs one decode step over all occupied
slots and draws every sampling request's next token from a single
``segment_topk`` call over their vocab rows.

The contract (DESIGN.md §14): each request's tokens equal running it
alone through :func:`repro_torch.serving.engine.generate` at batch 1 with
``ServeConfig(cache_len=slot capacity, seed=params.seed)``. What makes it
hold in the port:

  * prefill runs each admitted request alone at its exact length. The
    reference pads admissions to a pow2 bucket and prefills them as one
    batch; in the port a batched or padded prefill changes the bits of
    the valid rows (the products and the chunked attention take other
    shapes), so admissions are grouped by the reference's bucket only
    for their order;
  * the decode step is invariant to how many slots share it
    (``models.decode_step`` pads the rows to a tile), and the engine
    runs it on tiles of at most ``DECODE_TILE`` slots;
  * candidate values from ``segment_topk`` equal ``topk``'s bit for bit
    (selection copies values), and the token is canonicalised to the
    lowest vocab id with the drawn value;
  * every request owns a ``torch.Generator`` seeded with its seed; a
    greedy request never draws, a sampled one draws ``(1, k)`` noise for
    its first token and for every step, the sequence the solo path draws;
  * the gathered slot view has the solo cache's capacity.

A decode tick in which every slot is greedy scores nothing (no
``segment_topk`` call, no launch): nothing would read the candidates.

Telemetry (``REPRO_OBS`` on), at the reference's sites and with its
names: the ``sched.prefill`` / ``sched.decode`` spans, the per-request
``req.queue_wait`` / ``req.prefill`` / ``req.insert`` / ``req.decode``
stage spans and the ``request`` root span (``obs.request_waterfalls``
rebuilds each request's timeline from them), the ``sched.*`` counters,
gauges and histograms, ``sched`` recorder events at each terminal state,
and a flight-recorder dump (:func:`repro_torch.obs.recorder.crash_dump`)
when ``run()`` meets an unhandled exception. Series that differ from the
reference by design, because the port prefills each admitted request
alone: ``sched.prefill_batches`` counts one a request, and the
``sched.prefill`` span's ``batch`` is 1 and its ``bucket`` the request's
pow2 bucket (``req.prefill``'s likewise); the reference counts one a
batch of up to ``max_prefill_batch`` requests of a bucket. ``req.decode``'s
``compiled`` marks the first tick of a batch signature, as the
reference's does, though the port compiles nothing there. The
reference's failpoints are the resilience layer's (not ported: ROADMAP
Queue 1, item 8); the bounded retry around every prefill, insert and
decode launch is kept.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.model import DECODE_TILE
from repro_torch.models.transformer import check_family
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.timing import block_until_ready
from repro_torch.obs.trace import enabled as obs_enabled
from repro_torch.obs.trace import record_span, span

from ..sample import canonical_token, sample_greedy, sample_topk, scored_draw
from .paged import PagedKVCache, SlotManager, gather_view, scatter_col, split_pages, take_col
from .params import SamplingParams
from .queue import AdmissionQueue
from .request import Request, RequestState


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class SchedulerConfig:
    n_slots: int = 4
    page_size: int = 16
    pages_per_slot: int = 8
    #: pool size; the default reserves page 0 as scratch and gives every
    #: slot a full complement
    n_pages: Optional[int] = None
    #: free-slot reuse order ("fifo" | "lifo"); tokens must not depend on it
    slot_order: str = "fifo"
    #: admission-queue bound; ``submit`` past it raises ``QueueFull``
    max_queue: Optional[int] = None
    #: retries per prefill/insert/decode launch before its requests FAIL
    max_retries: int = 2
    #: base of the exponential retry backoff (seconds)
    retry_backoff_s: float = 0.05

    def __post_init__(self):
        assert self.page_size >= 1 and (self.page_size & (self.page_size - 1)) == 0, \
            f"page_size must be a power of two, got {self.page_size}"
        assert self.max_queue is None or self.max_queue >= 1
        assert self.max_retries >= 0 and self.retry_backoff_s >= 0.0

    @property
    def slot_capacity(self) -> int:
        return self.pages_per_slot * self.page_size


class ScheduledEngine:
    """Continuous-batching engine over a paged slot pool. ``submit()``
    requests (each with its :class:`SamplingParams` and arrival tick),
    then ``run()`` to drain, or drive ``step()`` tick by tick.
    ``device`` must be where ``params`` live; it defaults to the card."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 sched: Optional[SchedulerConfig] = None, device: DeviceLike = None):
        sched = sched or SchedulerConfig()
        check_family(cfg)
        if cfg.family in ("ssm", "hybrid", "vlm", "audio"):
            raise ValueError(
                f"{cfg.name}: the scheduler serves attention stacks of token "
                f"prompts, not the {cfg.family} family (as "
                "repro.serving.scheduler.ScheduledEngine: its paged slots hold KV caches)")
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: MoE through the scheduler is not ported: expert capacity "
                "couples the rows of a decode batch, so a request's tokens would depend on "
                "the requests beside it (ROADMAP Queue 1, item 7: MoE through "
                "ScheduledEngine)")
        self.dev = resolve_device(device)
        if params["embed"]["emb"].device.type != self.dev.type:
            raise ValueError(f"params live on {params['embed']['emb'].device}, "
                             f"not on {self.dev}")
        self.params = params
        self.cfg = cfg
        self.sc = sched
        n_pages = sched.n_pages or 1 + sched.n_slots * sched.pages_per_slot
        self.pool = PagedKVCache(cfg, n_pages, sched.page_size, self.dev)
        self.slots = SlotManager(sched.n_slots, sched.pages_per_slot, n_pages,
                                 order=sched.slot_order)
        self.queue = AdmissionQueue(sched.max_queue)
        self.requests: Dict[int, Request] = {}
        self.active: Dict[int, Request] = {}  # slot -> request
        self.t = 0
        self._next_rid = 0
        #: per decode tick: (tick, slots decoded, k of each sampling slot)
        self.tick_log: List[tuple] = []
        #: wall seconds of each decode tick
        self.tick_s: List[float] = []
        #: batch signatures already decoded: the first tick of each is
        #: tagged ``compiled=True`` on its ``req.decode`` spans
        self._decode_seen: set = set()
        self._trace_prefix = f"{os.getpid():x}-{id(self) & 0xFFFF:04x}"

    # ----------------------------------------------------------------- API

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               arrival: int = 0) -> int:
        params = params or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size >= 1, "empty prompt"
        need = prompt.size + params.max_new_tokens
        if need > self.sc.slot_capacity:
            raise ValueError(
                f"prompt+max_new_tokens = {need} exceeds slot capacity "
                f"{self.sc.slot_capacity} (pages_per_slot * page_size)")
        if not params.greedy and params.k > self.cfg.vocab_size:
            raise ValueError(f"k={params.k} exceeds the vocabulary "
                             f"({self.cfg.vocab_size})")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, params=params, arrival=int(arrival),
                      trace_id=f"{self._trace_prefix}-{rid}")
        req.t_submit_ns = time.perf_counter_ns()
        req.t_submit = req.t_submit_ns * 1e-9
        self.requests[rid] = req
        try:
            self.queue.push(req)
        except Exception as e:  # QueueFull: kept as REJECTED, never queued
            req.state = RequestState.REJECTED
            req.error = str(e)
            self._mark_finish(req)
            obs_metrics.counter("sched.rejected").inc()
            self._record_request(req)
            raise
        obs_metrics.counter("sched.submitted").inc()
        return rid

    @torch.no_grad()
    def step(self) -> None:
        """One tick: expire -> admit -> prefill/insert -> one decode step."""
        self._expire()
        admitted = self._admit()
        if admitted:
            self._run_prefill(admitted)
        if self.active:
            self._run_decode()
        self._gauges()
        self.t += 1

    def run(self, max_steps: int = 1_000_000) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens} of the DONE
        requests. An unhandled exception dumps the flight recorder (to
        ``REPRO_OBS_DUMP`` if set, else a bounded event tail to stderr)
        before it propagates."""
        steps = 0
        try:
            while (len(self.queue) or self.active) and steps < max_steps:
                if not self.active:
                    nxt = self.queue.next_arrival()
                    if nxt is not None and nxt > self.t:
                        self.t = nxt  # idle fast-forward to the next arrival
                self.step()
                steps += 1
        except Exception as e:  # noqa: BLE001 — dump context, re-raise
            obs_recorder.crash_dump("sched.run", e)
            raise
        assert not len(self.queue) and not self.active, \
            f"drain incomplete after {steps} steps"
        return {rid: np.asarray(r.tokens, np.int32)
                for rid, r in self.requests.items() if r.state is RequestState.DONE}

    def result(self, rid: int) -> np.ndarray:
        r = self.requests[rid]
        assert r.state is RequestState.DONE, (
            f"request {rid} is {r.state.value}" + (f": {r.error}" if r.error else ""))
        return np.asarray(r.tokens, np.int32)

    # ----------------------------------------- deadlines, failures, retries

    def _expire(self) -> None:
        now = time.perf_counter()
        for r in self.queue.drain_expired(lambda q: q.expired(self.t, now)):
            self._end(r, RequestState.TIMED_OUT, f"deadline elapsed at tick {self.t}")
        for r in [r for r in self.active.values() if r.expired(self.t, now)]:
            self._end(r, RequestState.TIMED_OUT, f"deadline elapsed at tick {self.t}")

    def _mark_finish(self, r: Request) -> None:
        r.finish_tick = self.t
        r.t_finish_ns = time.perf_counter_ns()
        r.t_finish = r.t_finish_ns * 1e-9

    def _record_request(self, r: Request) -> None:
        """Close the request's root span at its terminal state: the whole
        submit -> terminal window and the trace id, so the exporter
        (``obs.request_waterfalls``) rebuilds its timeline from the stage
        spans recorded as the stages ran."""
        if not obs_enabled():
            return
        record_span("request", r.t_submit_ns,
                    (r.t_finish_ns or time.perf_counter_ns()) - r.t_submit_ns,
                    rid=r.rid, trace_id=r.trace_id, state=r.state.value,
                    tokens=len(r.tokens), arrival=r.arrival, finish_tick=r.finish_tick)
        obs_recorder.emit("sched", f"request.{r.state.value}", rid=r.rid,
                          trace_id=r.trace_id, tokens=len(r.tokens))

    def _end(self, r: Request, state: RequestState, err: Optional[str] = None) -> None:
        """Make ``r`` terminal, give back its slot and pages, and record
        it (``sched.completed`` / ``timed_out`` / ``failed``)."""
        r.state = state
        r.error = err
        self._mark_finish(r)
        if r.slot is not None:
            self.slots.release(r.slot)
            self.active.pop(r.slot, None)
            r.slot = None
        self._record_request(r)
        if state is RequestState.DONE:
            obs_metrics.counter("sched.completed").inc()
            obs_metrics.histogram("sched.request_latency_s").observe(r.t_finish - r.t_submit)
            if len(r.tokens) > 1 and r.t_first:
                obs_metrics.histogram("sched.tpot_s").observe(
                    (r.t_finish - r.t_first) / (len(r.tokens) - 1))
        else:
            obs_metrics.counter(f"sched.{state.value}").inc()

    def _with_retry(self, what: str, fn):
        """Run one launch with bounded retry and exponential backoff."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception:
                if attempt >= self.sc.max_retries:
                    raise
                obs_metrics.counter("sched.retries").inc(what=what)
                if self.sc.retry_backoff_s:
                    time.sleep(self.sc.retry_backoff_s * (2 ** attempt))
                attempt += 1

    # ----------------------------------------------------------- admission

    def _npg_need(self, req: Request) -> int:
        return math.ceil((req.prompt.size + req.params.max_new_tokens) / self.sc.page_size)

    def _admit(self) -> List[Request]:
        admitted = []
        free_slots = self.slots.free_slot_count
        free_pages = self.slots.free_page_count
        while len(self.queue):
            req = self.queue.peek()
            npg = self._npg_need(req)
            if req.arrival > self.t:
                break
            if free_slots < 1 or free_pages < npg:
                break  # head-of-line blocking keeps admission deterministic
            free_slots -= 1
            free_pages -= npg
            self.queue.pop()
            req.admit_tick = self.t
            admitted.append(req)
        if admitted:
            obs_metrics.counter("sched.admitted").inc(len(admitted))
        return admitted

    # ------------------------------------------------------------- prefill

    def _bucket(self, plen: int) -> int:
        return max(self.sc.page_size, _next_pow2(plen))

    def _prefill_one(self, r: Request):
        """Prefill one prompt at its exact length: (logits (V,), caches)."""
        ps = self.sc.page_size
        npg = math.ceil(r.prompt.size / ps)
        cache = init_cache(self.cfg, 1, npg * ps, self.dev)
        tokens = torch.as_tensor(r.prompt[None], dtype=torch.int32).to(self.dev)
        logits, cache = prefill(self.params, {"tokens": tokens}, cache, self.cfg)
        return logits[0], cache["body"]

    def _first_token(self, logits_row: torch.Tensor, r: Request) -> int:
        """The head of ``generate``: greedy never draws; otherwise one
        ``sample_topk`` at batch 1 with the request's own generator."""
        p = r.params
        if p.temperature <= 0.0:
            return int(sample_greedy(logits_row[None])[0])
        return int(sample_topk(logits_row[None], k=p.k, temperature=p.temperature,
                               top_p=p.top_p, generator=r.generator)[0])

    def _run_prefill(self, admitted: List[Request]) -> None:
        ps = self.sc.page_size
        traced = obs_enabled()
        order = sorted(admitted, key=lambda r: self._bucket(r.prompt.size))
        for r in order:  # stable: arrival order within a bucket
            blen = self._bucket(r.prompt.size)
            t_pf0 = time.perf_counter_ns()
            with span("sched.prefill", kind="run", batch=1, bucket=blen):
                try:
                    logits, body = self._with_retry("prefill", lambda: self._prefill_one(r))
                    block_until_ready(logits)  # the span times the device work
                except Exception as e:  # noqa: BLE001 — retries exhausted
                    self._end(r, RequestState.FAILED,
                              f"prefill failed: {type(e).__name__}: {e}")
                    continue
            t_pf1 = time.perf_counter_ns()
            if traced:
                # the stage spans share integer-ns endpoints, so queue_wait
                # + prefill + insert is the request's TTFT exactly
                record_span("req.queue_wait", r.t_submit_ns, t_pf0 - r.t_submit_ns,
                            rid=r.rid, trace_id=r.trace_id, arrival=r.arrival,
                            admit_tick=r.admit_tick)
                record_span("req.prefill", t_pf0, t_pf1 - t_pf0, rid=r.rid,
                            trace_id=r.trace_id, bucket=blen, batch=1)
            obs_metrics.counter("sched.prefill_batches").inc()
            r.generator = torch.Generator(device=self.dev).manual_seed(r.params.seed)
            tok = self._first_token(logits, r)
            slot, pages = self.slots.alloc(self._npg_need(r))
            npg_store = math.ceil(r.prompt.size / ps)
            blocks = {name: split_pages(body, name, npg_store, ps) for name in ("k", "v")}
            page_ids = torch.as_tensor(pages[:npg_store]).to(self.dev)
            try:
                self._with_retry("insert", lambda: self.pool.insert(page_ids, blocks))
            except Exception as e:  # noqa: BLE001 — retries exhausted
                self.slots.release(slot)  # not yet r.slot: reclaim directly
                self._end(r, RequestState.FAILED,
                          f"insert failed: {type(e).__name__}: {e}")
                continue
            r.state = RequestState.RUNNING
            r.slot = slot
            r.length = int(r.prompt.size)
            r.tokens = [tok]
            r.t_first_ns = time.perf_counter_ns()
            r.t_first = r.t_first_ns * 1e-9
            if traced:
                record_span("req.insert", t_pf1, r.t_first_ns - t_pf1, rid=r.rid,
                            trace_id=r.trace_id, slot=slot, pages=npg_store)
            obs_metrics.histogram("sched.ttft_s").observe(r.t_first - r.t_submit)
            self.active[slot] = r
            if r.params.max_new_tokens == 1:
                self._end(r, RequestState.DONE)

    # -------------------------------------------------------------- decode

    def _decode_tile(self, slots: List[int], reqs: List[Request]) -> torch.Tensor:
        """One decode step over at most DECODE_TILE slots: logits (n, V);
        the new K/V column of every slot written into its page."""
        ps = self.sc.page_size
        pt = torch.as_tensor(self.slots.page_table[slots].astype(np.int64)).to(self.dev)
        lengths_np = np.asarray([r.length for r in reqs], np.int32)
        lengths = torch.as_tensor(lengths_np).to(self.dev)
        tokens = torch.as_tensor(np.asarray([[r.tokens[-1]] for r in reqs], np.int32)
                                 ).to(self.dev)
        view = gather_view(self.pool.leaves, pt, lengths)
        logits, view = decode_step(self.params, tokens, view, self.cfg,
                                   positions=lengths[:, None])
        page_ids = torch.as_tensor(self.slots.page_table[
            slots, lengths_np // ps].astype(np.int64)).to(self.dev)
        offs = torch.as_tensor((lengths_np % ps).astype(np.int64)).to(self.dev)
        for name, pool in self.pool.leaves.items():
            scatter_col(pool, name, take_col(view["body"], name, lengths), page_ids, offs)
        return logits

    def _decode(self, slots: List[int], reqs: List[Request]) -> List[int]:
        logits = torch.cat([
            self._decode_tile(slots[i:i + DECODE_TILE], reqs[i:i + DECODE_TILE])
            for i in range(0, len(slots), DECODE_TILE)])
        samp = [i for i, r in enumerate(reqs) if not r.params.greedy]
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        if samp:
            from repro_torch.api import segment_topk

            v = logits.shape[1]
            rows = logits[torch.as_tensor(samp, device=logits.device)]
            offsets = tuple(range(0, (len(samp) + 1) * v, v))
            # one segmented call scores every sampling slot with its own k
            vals, _, out_offs = segment_topk(rows.reshape(-1), offsets,
                                             [reqs[i].params.k for i in samp])
            for j, i in enumerate(samp):
                p = reqs[i].params
                vals_s = vals[out_offs[j]:out_offs[j + 1]][None]
                choice = scored_draw(vals_s, p.temperature,
                                     p.top_p if p.topp_active else None,
                                     generator=reqs[i].generator)
                toks[i] = canonical_token(rows[j:j + 1], vals_s, choice)[0]
        return toks.tolist()

    def _run_decode(self) -> None:
        slots = sorted(self.active)
        reqs = [self.active[s] for s in slots]
        sig = tuple(r.params.sig for r in reqs)
        compiled = sig not in self._decode_seen
        t0 = time.perf_counter()
        t_d0 = time.perf_counter_ns()
        with span("sched.decode", kind="run", batch=len(slots)):
            try:
                toks = self._with_retry("decode", lambda: self._decode(slots, reqs))
            except Exception as e:  # noqa: BLE001 — retries exhausted
                for r in reqs:
                    self._end(r, RequestState.FAILED,
                              f"decode failed: {type(e).__name__}: {e}")
                return
        t_d1 = time.perf_counter_ns()
        self.tick_s.append(time.perf_counter() - t0)
        self._decode_seen.add(sig)
        if obs_enabled():
            # one tick span per request sharing the launch window
            for i, r in enumerate(reqs):
                record_span("req.decode", t_d0, t_d1 - t_d0, rid=r.rid, trace_id=r.trace_id,
                            tick=self.t, slot=slots[i], batch=len(slots), compiled=compiled)
        obs_metrics.counter("sched.decode_steps").inc()
        obs_metrics.counter("sched.tokens").inc(len(slots))
        self.tick_log.append((self.t, len(slots), tuple(
            r.params.k for r in reqs if not r.params.greedy)))
        for r, tok in zip(reqs, toks):
            r.length += 1
            r.tokens.append(int(tok))
            if len(r.tokens) >= r.params.max_new_tokens:
                self._end(r, RequestState.DONE)

    def _gauges(self) -> None:
        obs_metrics.gauge("sched.queue_depth").set(len(self.queue))
        obs_metrics.gauge("sched.slots_occupied").set(len(self.active))
        obs_metrics.gauge("sched.free_pages").set(self.slots.free_page_count)
