"""Route selection for the library's entry points (counterpart of
``repro.api.dispatch``).

``plan(spec)`` maps a :class:`~repro_torch.api.spec.SortSpec` to a
:class:`Decision`: which backend (:mod:`~repro_torch.api.registry`) runs
the problem and why. The rules are the reference's decision table with
its accelerator rows ("TPU") for ``"cuda"``, and ``pallas`` named
``cuda``:

  op      condition                                  backend    detail
  ------  -----------------------------------------  ---------  ---------------
  (any)   CSR segment offsets                        segmented  bucketed_cuda
  (any)   an explicit ``backend=``                   that one   explicit
  topk    TP-sharded vocab                           sharded    tree_topk
  topk    cuda, axis > 512                           cuda       vocab_topk
  topk    cuda, axis <= 512                          cuda       router_topk
  topk    otherwise                                  schedule   blockwise_topk
  sort    TP-sharded, total >= DIST_MIN_TOTAL        sharded    sample_sort
  sort    cuda, fits the budget, not stable          cuda       loms_sort_fused
  sort    otherwise (stable / over budget / host)    schedule   loms_merge_tree
  median  cuda, loms, equal odd lists               cuda       kway_median
  median  otherwise                                  schedule   loms_median
  merge   TP-sharded, total >= DIST_MIN_TOTAL        sharded    sample_merge_k
  merge   payload, cuda, fits, not stable            cuda       fused_payload
  merge   payload / stable otherwise                 schedule   payload
  merge   a network other than loms                  schedule   network
  merge   no common column count                     schedule   ragged
  merge   working set past the budget                streaming  chunked_merge
  merge   cuda, fits the budget                      cuda       loms_merge2
  merge   otherwise                                  schedule   loms_2way
  merge_k the rows of merge, then: total^2 cloud past the budget: streaming,
          cuda: cuda kway_merge, otherwise: schedule loms_kway

A median the LOMS device cannot take (unequal or even lists, an even count of them) is planned as
in the reference and answered by the ``lax`` rung after it (``ops``),
where the reference's degradation ladder (on by default) lands: the one
step of that ladder the port takes (ROADMAP Queue 1, item 8). The budget
is the reference's routing budget (``streaming.planner``). A measured route sample in the autotune cache
overrides the rule as in the reference (:func:`record_route_us`); the
sharded rows are planned but refuse to run (item 9).

Explicit ``backend=`` asks skip the rules but are checked against the
backend's capability predicate: an ask it cannot run raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from repro_torch.kernels.topk import ROUTER_TOPK_MAX
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .fused import dtype_of
from .registry import get_backend
from .spec import BACKEND_AUTO, SortSpec

#: the reference's sharded cutover (``parallel.dist_sort.DIST_MIN_TOTAL``)
DIST_MIN_TOTAL = 8192


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routing outcome: backend, kernel detail, reason.

    ``source``: ``"rule"`` (the table) or ``"measured"`` (a faster
    measured route sample overrode it); ``measured_us`` the winning
    sample. ``network``: the family the cuda kernels run (an autotune
    winner where the cache holds one), None for other backends."""

    backend: str
    detail: str = ""
    reason: str = ""
    source: str = "rule"
    measured_us: Optional[float] = None
    network: Optional[str] = None


def _merge2_fits(spec: SortSpec) -> bool:
    from repro_torch.streaming.planner import fits_vmem

    m, n = spec.lengths[0], sum(spec.lengths[1:])
    return fits_vmem(m, n, dtype=dtype_of(spec.dtype))


def _dist_eligible(spec: SortSpec) -> bool:
    return spec.sharded and spec.network == "loms" and spec.total >= DIST_MIN_TOTAL


def _plan_segmented(spec: SortSpec) -> Decision:
    """CSR segment specs all go to the segmented backend."""
    if spec.device == "cuda":
        return Decision("segmented", "bucketed_cuda",
                        f"{spec.n_segments} segments in pow2 size classes: one class "
                        "kernel launch per class, the grid-merge spill")
    return Decision("segmented", "reference",
                    f"{spec.device} host: the class kernels' plain versions")


def plan(spec: SortSpec) -> Decision:
    """Resolve the backend of one problem. Pure function of ``spec`` and
    the autotune cache.

    Every decision is recorded in the obs layer (the ``plan`` span and
    the ``plan.decisions`` counter: op / backend / detail / device labels)
    when ``REPRO_OBS`` is on; the port counts every call (the reference
    counts compilations)."""
    with obs_trace.span("plan", kind="trace", op=spec.op):
        dec = _measured_override(spec, _resolve(spec))
        if dec.backend == "cuda":
            entry = _tuned_entry(spec)
            dec = dataclasses.replace(dec, network=str((entry or {}).get("network", "loms")))
    if obs_trace.enabled():
        obs_metrics.counter("plan.decisions").inc(
            op=spec.op, backend=dec.backend, detail=dec.detail,
            device=spec.device or "?", segmented=spec.segmented,
            sharded=spec.sharded, payload=spec.has_payload,
            source=dec.source, network=dec.network or "-",
        )
    return dec


def _resolve(spec: SortSpec) -> Decision:
    if spec.segmented and spec.backend == BACKEND_AUTO:
        return _plan_segmented(spec)
    if spec.backend != BACKEND_AUTO:
        be = get_backend(spec.backend)
        if spec.backend == "sharded":
            be.run["sort"]()  # raises: ROADMAP Queue 1, item 9
        if not be.supports(spec):
            raise ValueError(
                f"backend {spec.backend!r} cannot run {spec.describe()} "
                f"(payload/stable={spec.needs_perm}, network={spec.network!r})")
        return Decision(spec.backend, detail="explicit", reason="caller override")
    on_card = spec.device == "cuda"
    cuda = get_backend("cuda")
    if spec.op == "topk":
        if spec.sharded:
            return Decision("sharded", "tree_topk",
                            "TP-sharded vocab: log-depth merge reduction over the mesh axis")
        if on_card and cuda.supports(spec):
            if spec.total > ROUTER_TOPK_MAX:
                return Decision("cuda", "vocab_topk",
                                f"axis {spec.total} > {ROUTER_TOPK_MAX}: two-phase "
                                "block kernel + truncated merge levels")
            return Decision("cuda", "router_topk",
                            f"axis {spec.total} <= {ROUTER_TOPK_MAX}: single-kernel "
                            "blockwise top-k")
        return Decision("schedule", "blockwise_topk",
                        f"{spec.device} host: the truncated-merge tree")
    if spec.op == "sort":
        if _dist_eligible(spec):
            return Decision("sharded", "sample_sort",
                            f"TP-sharded, total {spec.total} >= {DIST_MIN_TOTAL}: "
                            "sample-sort over the mesh axis")
        if on_card and cuda.supports(spec):
            return Decision("cuda", "loms_sort_fused",
                            "fits the budget: single-launch fused merge-tree sort")
        return Decision("schedule", "loms_merge_tree",
                        "stable / over the budget / not on the card: the schedule "
                        "executor")
    if spec.op == "median":
        if on_card and cuda.supports(spec):
            return Decision("cuda", "kway_median", "equal odd lists: the two-stage "
                            "device in one launch of the k-way kernel")
        return Decision("schedule", "loms_median", "schedule executor median")
    if _dist_eligible(spec):
        return Decision("sharded", "sample_merge_k",
                        f"TP-sharded, total {spec.total} >= {DIST_MIN_TOTAL}: local "
                        "k-way merge of list slices + sample-sort exchange")
    if spec.needs_perm:
        if on_card and cuda.supports(spec):
            return Decision("cuda", "fused_payload",
                            "fits the budget: the payload rides the kernel's "
                            "permutation (single fused launch)")
        return Decision("schedule", "payload",
                        "payload/stable needs the permutation-carrying executor")
    if spec.network != "loms":
        return Decision("schedule", "network",
                        f"network {spec.network!r}: the schedule executor")
    if spec.op == "merge":
        if spec.ragged2:
            return Decision("schedule", "ragged",
                            "no common column count divides both lists")
        if not _merge2_fits(spec):
            return Decision("streaming", "chunked_merge",
                            "working set past the budget: the grid merge")
        if on_card:
            return Decision("cuda", "loms_merge2", "fits the budget")
        return Decision("schedule", "loms_2way", f"{spec.device} host")
    from repro_torch.streaming.planner import kway_fits_vmem

    if not kway_fits_vmem(spec.total):
        return Decision("streaming", "chunked_merge_k",
                        "comparison cloud past the budget: the merge-path tiled k-way "
                        "merge")
    if on_card:
        return Decision("cuda", "kway_merge", "fits the budget")
    return Decision("schedule", "loms_kway", f"{spec.device} host")


# ---------------------------------------------------------------------------
# measured-cost dispatch: recorded route timings override the rules
# ---------------------------------------------------------------------------

#: single-device backends the measured ranking chooses between
_MEASURED_CANDIDATES = ("cuda", "schedule", "streaming")


def measured_dispatch_enabled() -> bool:
    """``REPRO_MEASURED_DISPATCH=0`` pins routing to the rules."""
    return os.environ.get("REPRO_MEASURED_DISPATCH", "1") != "0"


def _route_key(spec: SortSpec, backend: str) -> str:
    """Cache key of one (op, shapes, dtype, k, payload, platform, backend)
    route sample; the platform rides in the backend tag, so that a card's
    timings never rank against a host's."""
    from repro_torch.streaming.cache import plan_key, platform

    tag = f"{platform()}:{'payload' if spec.has_payload else 'plain'}:{backend}"
    return plan_key(f"route_{spec.op}", shapes=(spec.batch,) + tuple(spec.lengths),
                    dtype=spec.dtype, k=spec.k, backend=tag)


def record_route_us(spec: SortSpec, backend: str, us: float) -> None:
    """Record one measured time (µs) of running ``spec`` through
    ``backend``; the fastest sample seen is kept."""
    from repro_torch.streaming.cache import default_cache

    cache = default_cache()
    key = _route_key(spec, backend)
    prev = cache.get(key)
    best = float(us)
    if prev is not None and "us" in prev:
        best = min(best, float(prev["us"]))
    cache.put(key, {"us": best, "backend": backend, "op": spec.op})


def measured_route_us(spec: SortSpec, backend: str) -> Optional[float]:
    """The fastest recorded sample of routing ``spec`` through ``backend``."""
    from repro_torch.streaming.cache import default_cache

    entry = default_cache().get(_route_key(spec, backend))
    if entry is None or "us" not in entry:
        return None
    return float(entry["us"])


def _measured_override(spec: SortSpec, dec: Decision) -> Decision:
    """Prefer the fastest measured candidate over the rule: auto,
    single-device, dense specs with samples of at least two capable
    backends at this exact point."""
    if (not measured_dispatch_enabled() or spec.backend != BACKEND_AUTO
            or spec.segmented or spec.sharded or dec.backend in ("sharded", "lax")):
        return dec
    samples = {}
    for b in _MEASURED_CANDIDATES:
        if not get_backend(b).supports(spec):
            continue
        us = measured_route_us(spec, b)
        if us is not None:
            samples[b] = us
    if len(samples) < 2:
        return dec
    winner = min(samples, key=samples.get)
    if winner == dec.backend:
        return dataclasses.replace(dec, measured_us=samples[winner])
    runner_b, runner_us = min(((b, u) for b, u in samples.items() if b != winner),
                              key=lambda kv: kv[1])
    return dataclasses.replace(
        dec, backend=winner, detail="measured",
        reason=(f"measured {samples[winner]:.1f}µs via {winner} beats {runner_b} "
                f"{runner_us:.1f}µs (rule chose {dec.backend})"),
        source="measured", measured_us=samples[winner])


def _tuned_entry(spec: SortSpec) -> Optional[dict]:
    """The cached autotune entry of the spec's kernel tuning point, if a
    sweep ran it on this platform (its ``us`` and ``network``)."""
    from repro_torch.streaming.cache import default_cache, plan_key

    op_map = {
        "sort": ("sort", (spec.lengths[0],), None),
        "merge": ("merge2", tuple(spec.lengths), None),
        "merge_k": ("kway", tuple(spec.lengths), None),
        "topk": ("topk", (spec.total,), spec.k),
    }
    if spec.segmented or spec.op not in op_map:
        return None
    op, lengths, k = op_map[spec.op]
    return default_cache().get(plan_key(op, shapes=(spec.batch,) + lengths,
                                        dtype=spec.dtype, k=k))


def _tuned_us(spec: SortSpec) -> Optional[float]:
    entry = _tuned_entry(spec)
    if entry is None or "us" not in entry:
        return None
    return float(entry["us"])


def decision_table(device: Optional[str] = None) -> List[dict]:
    """The reference's representative routing grid, planned for
    ``device`` (``"cpu"`` and ``"cuda"`` by default). Each row carries
    ``tuned_us``, the cached autotune sample of its tuning point."""
    devices = (device,) if device else ("cpu", "cuda")
    cases = []
    for dev in devices:
        cases += [
            SortSpec(op="topk", lengths=(256,), k=8, batch=64, device=dev),
            SortSpec(op="topk", lengths=(32_000,), k=64, batch=8, device=dev),
            SortSpec(op="topk", lengths=(32_000,), k=64, batch=8, device=dev, sharded=True),
            SortSpec(op="merge", lengths=(512, 512), batch=8, device=dev),
            SortSpec(op="merge", lengths=(7, 5), batch=8, device=dev),
            SortSpec(op="merge", lengths=(100_000, 100_000), device=dev),
            SortSpec(op="merge", lengths=(512, 512), batch=8, device=dev, has_payload=True),
            SortSpec(op="merge_k", lengths=(64,) * 4, batch=8, device=dev),
            SortSpec(op="merge_k", lengths=(50_000,) * 4, device=dev),
            SortSpec(op="merge_k", lengths=(50_000,) * 4, device=dev, sharded=True),
            SortSpec(op="sort", lengths=(1024,), batch=8, device=dev),
            SortSpec(op="sort", lengths=(1 << 20,), batch=8, device=dev, sharded=True),
            SortSpec(op="median", lengths=(7, 7, 7), batch=8, device=dev),
            # segmented rows: MoE variable-capacity dispatch and
            # continuous-batching mixed-k vocab top-k
            SortSpec(op="sort", lengths=(168,), batch=4, device=dev,
                     segment_offsets=((0, 3, 40, 41, 168),)),
            SortSpec(op="topk", lengths=(96,), k=8, batch=3, device=dev,
                     segment_offsets=((0, 32, 64, 96),)),
            SortSpec(op="merge", lengths=(12, 20), batch=2, device=dev,
                     segment_offsets=((0, 5, 12), (0, 16, 20))),
        ]
    rows = []
    for spec in cases:
        dec = plan(spec)
        rows.append({"op": spec.op, "problem": spec.describe(), "sharded": spec.sharded,
                     "payload": spec.has_payload, "segments": spec.n_segments,
                     "backend": dec.backend, "detail": dec.detail, "reason": dec.reason,
                     "source": dec.source, "network": dec.network,
                     "measured_us": dec.measured_us, "tuned_us": _tuned_us(spec)})
    return rows
