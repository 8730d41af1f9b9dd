"""What decides ``correct``: the served tokens against the plain reference.

After the window, a sample drawn from the seed of what the timed path
served is run through the float32 reference (``portbench/reference/``) on
the benchmark's own weights and prompts. Each judged position gives:

* ``logit_err``: the logits the token was drawn from (kept by reference
  as the program made them) against the reference's, whole: the norm of
  their difference over the norm of the reference's row about its mean.
  Its ``median``, ``p75`` and ``p90`` (nearest rank) and ``max`` over the
  sample.
* ``gap`` (greedy positions): how far the reference's logit of the served
  token lies below the reference's largest; 0 where it also puts it
  first. ``gap_max`` over the sample.
* ``topk_excess`` (sampled positions, top-k at a temperature): how far
  the reference's logit of the drawn token lies below the reference's
  k-th largest; at most 0 where the reference also ranks it in its top
  k. ``topk_excess_max`` over the sample.
* ``sampler_mismatch``, exact: the positions where the sampler is not
  the plain function of the program's own logits. A greedy token must be
  the lowest id of the row's largest logit. A sampled position's
  candidate values (what the vocab top-k kernels returned, kept by
  reference) must equal ``torch.topk`` of those logits, and its token
  must be the lowest id whose logit equals one of them.

The cell names the numbers compared and their limits (``check.limits``).

* Dense stack: each request is prefilled alone and decodes through the
  paged cache, so its tokens are a function of its own prompt. The sample
  is requests that finished in the window, greedy and sampled, the
  longest among them; the reference runs each prompt with its served
  tokens once, and every served token is judged.
* MoE stack: expert capacity couples the rows of a prefill batch, so the
  reference forms the engine's prefill batches again from the arrivals
  alone (:func:`replay_batches`: the admission queue, slots and pages, the
  pow2 buckets, the chunks, the pads), and runs whole batches. Every row
  of a sampled batch is judged at its last position, by the token it was
  served.

The control (``quant``) is the reference in float8 put in the program's
place: at each judged position the token that it puts first (greedy) or
draws from its own top k at the request's temperature, judged the same
way, and its logits.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def replay_batches(arrivals: Sequence[Tuple[int, int, int, int]], *, n_slots: int,
                   pages_per_slot: int, n_pages: int, page_size: int,
                   max_prefill_batch: int, moe: bool) -> List[Tuple[int, int, List[int]]]:
    """The prefill batches ``(tick, bucket, rids)`` that the scheduler's
    rules make of ``arrivals`` ``(rid, arrival tick, prompt length,
    max_new_tokens)`` in submit order, one engine step a tick: each tick
    admits queued requests in (arrival, rid) order while a slot and their
    pages are free (head of line blocks), prefills them grouped by pow2
    bucket (at least ``page_size``), ascending, in chunks of
    ``max_prefill_batch`` (MoE) or one by one (dense); a request makes its
    first token at its prefill and one more at every decode step, the
    first in the same tick, and frees its slot and pages at its last."""
    queue = [(arr, rid, plen, new) for rid, arr, plen, new in arrivals]
    heapq.heapify(queue)
    free_slots, free_pages = n_slots, n_pages - 1
    running: Dict[int, List[int]] = {}  # rid -> [tokens made, max_new_tokens, pages]
    batches = []
    t = 0
    while queue or running:
        admitted = []
        while queue and queue[0][0] <= t:
            arr, rid, plen, new = queue[0]
            npg = math.ceil((plen + new) / page_size)
            if free_slots < 1 or free_pages < npg:
                break
            heapq.heappop(queue)
            free_slots -= 1
            free_pages -= npg
            admitted.append((rid, plen, new, npg))
        groups: Dict[int, list] = {}
        for a in admitted:
            groups.setdefault(max(page_size, _next_pow2(a[1])), []).append(a)
        step = max_prefill_batch if moe else 1
        for blen in sorted(groups):
            reqs = groups[blen]
            for i in range(0, len(reqs), step):
                batches.append((t, blen, [a[0] for a in reqs[i:i + step]]))
        for rid, plen, new, npg in admitted:
            if new == 1:  # ends at its prefill
                free_slots += 1
                free_pages += npg
            else:
                running[rid] = [1, new, npg]
        for rid in list(running):  # the decode step over every running slot
            running[rid][0] += 1
            if running[rid][0] >= running[rid][1]:
                free_slots += 1
                free_pages += running[rid][2]
                del running[rid]
        t += 1
    return batches


def logit_err(ref_logits: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """(n, V) reference and program logits -> each row's
    ||got - ref|| / ||ref - mean(ref)||."""
    got = got.to(ref_logits.device, torch.float32)
    centred = ref_logits - ref_logits.mean(dim=-1, keepdim=True)
    return (got - ref_logits).norm(dim=-1) / centred.norm(dim=-1)


def sampler_mismatch(logits: torch.Tensor, tokens: torch.Tensor, draws: Sequence,
                     cands: Sequence) -> int:
    """The positions of one row where the sampler is not the plain
    function of the program's own logits (the module docstring):
    ``logits`` (P, V) as served, ``tokens`` (P,), ``draws[j]`` None
    (greedy) or ``(k, temperature, seed)``, ``cands[j]`` the (k,)
    candidate values kept, or None."""
    bad = 0
    for j, d in enumerate(draws):
        row, tok = logits[j], int(tokens[j])
        if not 0 <= tok < row.numel():
            bad += 1
            continue
        if d is None:
            value = row.max()
        else:
            c, want = cands[j], torch.topk(row, int(d[0])).values
            if c is None or c.shape != want.shape or not torch.equal(
                    c.to(want.device, want.dtype), want):
                bad += 1
                continue
            value = row[tok]
            if not bool((want == value).any()):
                bad += 1
                continue
        if int(torch.nonzero(row == value)[0, 0]) != tok:
            bad += 1
    return bad


def _drawn(logits: torch.Tensor, k: int, temperature: float, seed: int) -> int:
    """The control's draw: one Gumbel-max draw over its own top ``k`` at
    ``temperature``, from a generator seeded by the request."""
    vals, ids = torch.topk(logits, k)
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand(k, generator=gen, dtype=torch.float64).clamp_(1e-12, 1.0 - 1e-12)
    noise = (-torch.log(-torch.log(u))).to(vals.device, torch.float32)
    return int(ids[int(torch.argmax(vals.float() / temperature + noise))])


def _below(ref: torch.Tensor, k: int, tok: int) -> float:
    """How far the reference's logit of ``tok`` lies below its k-th
    largest (k = 1: its gap); a token outside the vocabulary is
    infinitely far."""
    if not 0 <= tok < ref.numel():
        return math.inf
    return float(torch.topk(ref, k).values[-1] - ref[tok])


class Sample:
    """What the reference runs and what it judges: ``batches`` for the
    reference (tokens, {row: positions}) and, beside each, {row: tokens
    served at those positions}, {row: the program's logits there}, {row:
    each position's draw, None (greedy) or (k, temperature, seed)} and
    {row: each position's candidate values, or None}."""

    def __init__(self):
        self.batches: List[Tuple[torch.Tensor, Dict[int, List[int]]]] = []
        self.served: List[Dict[int, torch.Tensor]] = []
        self.program: List[Dict[int, torch.Tensor]] = []
        self.draws: List[Dict[int, list]] = []
        self.cands: List[Dict[int, list]] = []
        self.requests = 0

    @property
    def positions(self) -> int:
        return sum(len(p) for _, want in self.batches for p in want.values())

    def add(self, toks, want, served, prog, draws, cands, requests):
        self.batches.append((toks, want))
        self.served.append(served)
        self.program.append(prog)
        self.draws.append(draws)
        self.cands.append(cands)
        self.requests += requests


def _draw(spec, j: int):
    return None if spec.greedy else (spec.k, spec.temperature, spec.seed * 4096 + j)


def draw_sample(loop, window: dict, settings: dict, cfg: dict, seed: int) -> Sample:
    """The sample of the cell's check, drawn from the seed (the module
    docstring); ``settings["check"]["count"]`` requests (dense) or
    batches (MoE) of those whose answers came in the window, the largest
    always among them."""
    count = int(settings["check"]["count"])
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    due = {r.rid for r in window["ended"] if r.state == "done"}
    stream = loop.stream
    s = Sample()
    if cfg.get("moe"):
        recs = loop.recs
        arrivals = [(rid, r.arrival, r.spec.prompt_len, r.spec.max_new_tokens)
                    for rid, r in sorted(recs.items())]
        eng = settings["engine"]
        batches = replay_batches(arrivals, n_slots=eng["n_slots"],
                                 pages_per_slot=eng["pages_per_slot"],
                                 n_pages=eng["n_pages"], page_size=eng["page_size"],
                                 max_prefill_batch=eng["max_prefill_batch"], moe=True)
        cand = [b for b in batches
                if all(rid in due and 0 in loop.logits.get(rid, {}) for rid in b[2])]
        if not cand:
            return s
        big = max(range(len(cand)), key=lambda i: (len(cand[i][2]) * cand[i][1], -i))
        rest = [i for i in range(len(cand)) if i != big]
        pick = [big] + sorted(rng.choice(rest, min(count - 1, len(rest)), replace=False).tolist())
        for i in pick:
            _, blen, rids = cand[i]
            toks = torch.zeros((len(rids), blen), dtype=torch.long)
            want, served, prog, draws, cands = {}, {}, {}, {}, {}
            for row, rid in enumerate(rids):
                spec = recs[rid].spec
                toks[row, :spec.prompt_len] = torch.from_numpy(stream.tokens(spec).astype(np.int64))
                want[row] = [spec.prompt_len - 1]
                prog[row] = loop.logits[rid][0][None]
                served[row] = torch.as_tensor(loop.engine.requests[rid].tokens[:1])
                draws[row] = [_draw(spec, 0)]
                cands[row] = [loop.candidates.get(rid, {}).get(0)]
            s.add(toks, want, served, prog, draws, cands, len(rids))
        return s
    done = [r for r in window["ended"] if r.rid in due
            and len(loop.logits.get(r.rid, {})) == r.n_seen]
    if not done:
        return s
    big = max(range(len(done)), key=lambda i: (done[i].spec.prompt_len + done[i].n_seen, -i))
    rest = [i for i in range(len(done)) if i != big]
    pick = [big] + sorted(rng.choice(rest, min(count - 1, len(rest)), replace=False).tolist())
    for i in pick:
        rec = done[i]
        served = loop.engine.requests[rec.rid].tokens
        prompt = stream.tokens(rec.spec).astype(np.int64)
        toks = torch.from_numpy(np.concatenate([prompt, np.asarray(served[:-1], np.int64)]))
        first = rec.spec.prompt_len - 1
        n = len(served)
        kept = loop.candidates.get(rec.rid, {})
        s.add(toks[None], {0: list(range(first, first + n))}, {0: torch.as_tensor(served)},
              {0: torch.stack([loop.logits[rec.rid][j] for j in range(n)])},
              {0: [_draw(rec.spec, j) for j in range(n)]},
              {0: [kept.get(j) for j in range(n)]}, 1)
    return s


def _summary(gap, err, excess, prefix=""):
    errs = sorted(err)
    return {f"{prefix}gap_max": max(gap, default=0.0),
            f"{prefix}logit_err_max": errs[-1],
            f"{prefix}logit_err_median": float(np.median(errs)),
            f"{prefix}logit_err_p75": errs[max(0, math.ceil(0.75 * len(errs)) - 1)],
            f"{prefix}logit_err_p90": errs[max(0, math.ceil(0.9 * len(errs)) - 1)],
            f"{prefix}topk_excess_max": max(excess, default=-math.inf)}


def judge(ref, weights: dict, cfg: dict, sample: Sample,
          control: Optional[str] = None) -> Dict[str, float]:
    """The sample's numbers against the float32 reference (the module
    docstring), and with ``control`` the control's beside them."""
    if not sample.batches:
        return {"gap_max": math.inf, "logit_err_max": math.inf, "logit_err_median": math.inf,
                "logit_err_p75": math.inf, "logit_err_p90": math.inf,
                "topk_excess_max": math.inf,
                "sampler_mismatch": math.inf, "positions": 0, "requests": 0, "logit_errs": []}
    ref_out = ref.run(weights, cfg, sample.batches)
    gap, err, excess, mismatch = [], [], [], 0
    for got, served, prog, draws, cands in zip(ref_out, sample.served, sample.program,
                                               sample.draws, sample.cands):
        for row, logits in got.items():
            toks = served[row].tolist()
            err += logit_err(logits, prog[row]).tolist()
            for j, d in enumerate(draws[row]):
                if d is None:
                    gap.append(_below(logits[j], 1, toks[j]))
                else:
                    excess.append(_below(logits[j], d[0], toks[j]))
            mismatch += sampler_mismatch(prog[row], served[row], draws[row], cands[row])
    out = _summary(gap, err, excess)
    out.update(sampler_mismatch=mismatch, positions=sample.positions,
               requests=sample.requests, logit_errs=[round(e, 5) for e in err])
    if control is not None:
        ctl_out = ref.run(weights, cfg, sample.batches, quant=control)
        gap, err, excess = [], [], []
        for got, ctl, draws in zip(ref_out, ctl_out, sample.draws):
            for row, logits in got.items():
                err += logit_err(logits, ctl[row]).tolist()
                for j, d in enumerate(draws[row]):
                    if d is None:
                        gap.append(_below(logits[j], 1, int(ctl[row][j].argmax())))
                    else:
                        excess.append(_below(logits[j], d[0], _drawn(ctl[row][j], *d)))
        out.update(_summary(gap, err, excess, prefix="control_"))
        out["control_logit_errs"] = [round(e, 5) for e in err]
    return out
