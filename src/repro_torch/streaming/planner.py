"""The merge planner: which route, family, column count and tile a merge,
k-way merge or sort takes (the part of ``repro.streaming.planner`` the
library's ``merge``, ``merge_k`` and ``sort`` need).

The closed-form heuristics are the reference's, and so is the budget the
working-set predicates are held to. That budget is **the reference's
routing budget**, not a limit of the card: it decides whether a merge is
one fused launch or streams through the grid merge, and whether a sort
is one fused launch at all, and with the route the family and the column
count that fix the tie order of payload lanes. Any other cutover would
give other permutations than the reference for the shapes in between, so
it is kept verbatim. The CUDA kernels have their own limits (shared
memory, a global scratch past it) and meet every shape the budget admits.

:func:`plan_op` is the cache-aware front door: one (op, shapes, dtype, k,
platform) key into the autotune cache (:mod:`~repro_torch.streaming.cache`),
the closed-form heuristic on a miss (no measurement at run time). A
cached plan names a network family, a column count and a top-k block,
and with them the tie order, so a cache hit changes permutations as it
does in the reference. The ``autotune_*`` functions time the port's own
candidates on the tensor's device (CUDA events on the card) and persist
the winner.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import ceil_pow2
from repro_torch.networks import capable_families, divisor_cols, pick_merge_cols

from .cache import AutotuneCache, default_cache, plan_key

#: the reference's routing budget (``_VMEM_BUDGET``, 8 MiB): the working
#: set its predicates compare against, kept for parity of routes
ROUTING_BUDGET = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """Resolved knobs for one sort, merge or top-k (the reference's
    ``MergePlan``). ``block_batch`` is kept for the cache's format; a CUDA
    kernel takes a row, or a few narrow rows, a CTA, and reads none."""

    kind: str = "loms"  # 'loms' (the kernels) | 'schedule' (the executor)
    n_cols: int = 2
    network: str = "loms"
    block_batch: int = 8
    #: the reference's one-hot matrix permute of raw floats: True for a
    #: float dtype, as every heuristic of the reference plans it (the
    #: values-only wrappers of ``kernels.ops`` take it)
    use_mxu: bool = True
    tile: int = 512  # the streaming merge's tile
    block: int = 0  # the top-k block (0: the op's default)
    source: str = "heuristic"  # 'heuristic' | 'autotune' | 'cache'
    us: Optional[float] = None  # the autotune sweep's measured time

    def to_entry(self, us: Optional[float] = None) -> dict:
        d = {"kind": self.kind, "network": self.network, "n_cols": self.n_cols,
             "block_batch": self.block_batch, "use_mxu": self.use_mxu,
             "tile": self.tile, "block": self.block}
        measured = us if us is not None else self.us
        if measured is not None:
            d["us"] = float(measured)
        return d

    @classmethod
    def from_entry(cls, entry: dict, source: str = "cache") -> "MergePlan":
        us = entry.get("us")
        return cls(kind=str(entry.get("kind", "loms")),
                   network=str(entry.get("network", "loms")),
                   n_cols=int(entry["n_cols"]), block_batch=int(entry.get("block_batch", 1)),
                   use_mxu=bool(entry["use_mxu"]), tile=int(entry.get("tile", 512)),
                   block=int(entry.get("block", 0)), source=source,
                   us=float(us) if us is not None else None)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _vmem_bytes_merge2(m: int, n: int, n_cols: int, block_batch: int,
                       dtype: torch.dtype) -> int:
    """The reference's working set of the 2-way merge kernel."""
    it = max(_itemsize(dtype), 4)
    vals = (m + n) * it
    cloud = (m // n_cols) * (n // n_cols) * 4  # widest column S2MS matrix
    rows = ((m + n) // n_cols) * n_cols * n_cols * 4  # row-sort matrices
    return block_batch * (vals + cloud + rows)


def _vmem_bytes_sort(n: int, block_batch: int, dtype: torch.dtype) -> int:
    """The reference's working set of the fused sort kernel: the widest
    level's rank cloud and the value and position lanes."""
    it = max(_itemsize(dtype), 4)
    npad = ceil_pow2(n)
    cloud = (npad // 2) * (npad // 2) * 4 * 2
    lanes = npad * (it + 4) * 2
    return block_batch * (cloud + lanes)


def fits_vmem(m: int, n: int, *, n_cols: int = 2, block_batch: int = 1,
              dtype: torch.dtype = torch.float32) -> bool:
    """The reference's fused-merge vs streaming cutover."""
    return _vmem_bytes_merge2(m, n, n_cols, block_batch, dtype) <= ROUTING_BUDGET


def sort_fits_vmem(n: int, *, block_batch: int = 1,
                   dtype: torch.dtype = torch.float32) -> bool:
    """The reference's fused-sort vs schedule-executor cutover."""
    return _vmem_bytes_sort(n, block_batch, dtype) <= ROUTING_BUDGET


def kway_fits_vmem(total: int) -> bool:
    """The reference's fused k-way merge vs streaming cutover: its kernel
    materialises a total² float32 comparison cloud a row, so total² · 4
    bytes within the budget (total <= 1,448)."""
    return total * total * 4 <= ROUTING_BUDGET


def plan_merge2(m: int, n: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """One UP-m/DN-n merge: the column count nearest the comparator-cost
    optimum among the common divisors (``pick_merge_cols``); none: the
    schedule executor."""
    n_cols = pick_merge_cols(m, n)
    use_mxu = dtype.is_floating_point
    if n_cols == 1:
        return MergePlan(kind="schedule", n_cols=2, use_mxu=use_mxu)
    return MergePlan(kind="loms", n_cols=n_cols, use_mxu=use_mxu)


def plan_sort(n: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """The fused sort: the loms family's merge tree at ``ceil_pow2(n)``."""
    return MergePlan(kind="loms", n_cols=2, use_mxu=dtype.is_floating_point)


def plan_chunked(total_a: int, total_b: int, *, batch: int = 1,
                 dtype: torch.dtype = torch.float32,
                 tile: Optional[int] = None) -> MergePlan:
    """The streaming merge: the largest tile (512 down to 32) whose
    carry-and-tile merge fits the budget across the whole batch."""
    if tile is None:
        tile = 512
        while tile > 32 and _vmem_bytes_merge2(tile, tile, 2, max(batch, 1),
                                               dtype) > ROUTING_BUDGET:
            tile //= 2
    tile = max(2, tile - (tile % 2))
    return dataclasses.replace(plan_merge2(tile, tile, dtype), tile=tile)


def plan_kway(total: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """The fused k-way merge: the schedule's own wiring, nothing to pick
    (the reference's plan only sizes its batch tile)."""
    return MergePlan(kind="loms", n_cols=2, use_mxu=dtype.is_floating_point)


def plan_chunked_k(lens: Sequence[int], *, batch: int = 1,
                   dtype: torch.dtype = torch.float32,
                   tile: Optional[int] = None) -> MergePlan:
    """The k-way streaming merge: k tile segments an output tile, the
    largest tile (128 down to 16) whose (k · tile)² cloud fits the budget
    across the whole batch."""
    k = len(lens)
    if tile is None:
        tile = 128
        while tile > 16 and max(batch, 1) * (k * tile) * (k * tile) * 4 > ROUTING_BUDGET:
            tile //= 2
    return MergePlan(kind="schedule", n_cols=k, use_mxu=dtype.is_floating_point,
                     tile=int(tile))


def plan_topk(n: int, k: int, dtype: torch.dtype = torch.float32) -> MergePlan:
    """The blockwise top-k: a block about the next power of two >= k,
    clamped to [16, 128] and to n, halved while it leaves a remainder."""
    block = int(min(max(16, 1 << max(k - 1, 1).bit_length()), 128, n))
    while n % block and block > 16:
        block //= 2
    return MergePlan(kind="loms", block=block, use_mxu=dtype.is_floating_point)


def plan_segmented(widths: Sequence[int], dtype: torch.dtype = torch.float32) -> MergePlan:
    """One segmented size-class launch: ``widths`` is the class's pow2
    width (a class sort) or the pair of widths (a class merge)."""
    widths = tuple(int(w) for w in widths)
    n_cols = 2 if len(widths) == 1 else max(pick_merge_cols(widths[0], widths[1]), 1)
    return MergePlan(kind="loms", n_cols=n_cols, use_mxu=dtype.is_floating_point)


_HEURISTICS = {
    "merge2": lambda lengths, batch, dtype, k: plan_merge2(lengths[0], lengths[1], dtype),
    "sort": lambda lengths, batch, dtype, k: plan_sort(lengths[0], dtype),
    "kway": lambda lengths, batch, dtype, k: plan_kway(sum(lengths), dtype),
    "topk": lambda lengths, batch, dtype, k: plan_topk(lengths[0], k or 1, dtype),
    "segmented": lambda lengths, batch, dtype, k: plan_segmented(lengths, dtype),
    "chunked2": lambda lengths, batch, dtype, k: plan_chunked(lengths[0], lengths[1],
                                                              batch=batch, dtype=dtype),
    "chunked_k": lambda lengths, batch, dtype, k: plan_chunked_k(lengths, batch=batch,
                                                                 dtype=dtype),
}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's ``dtype.name``)."""
    return str(dtype).split(".")[-1]


def plan_op(op: str, lengths: Sequence[int], *, batch: int = 8,
            dtype: torch.dtype = torch.float32, k: Optional[int] = None,
            cache: Optional[AutotuneCache] = None) -> MergePlan:
    """The plan of one kernel problem: the autotune cache's entry for
    (op, batch x lengths, dtype, k, platform), else the closed-form
    heuristic (the reference's ``plan_op``)."""
    if op not in _HEURISTICS:
        raise ValueError(f"plan_op: unknown op {op!r}; known: {sorted(_HEURISTICS)}")
    lengths = tuple(int(x) for x in lengths)
    cache = cache if cache is not None else default_cache()
    hit = cache.get(plan_key(op, shapes=(batch,) + lengths, dtype=dtype_name(dtype), k=k))
    if hit is not None:
        return MergePlan.from_entry(hit, source="cache")
    return _HEURISTICS[op](lengths, batch, dtype, k)


# ---------------------------------------------------------------------------
# the autotune tournament: the port's candidates timed on the device
# ---------------------------------------------------------------------------

#: ``timer(plan, fn) -> µs``: how a candidate is timed (tests inject a
#: deterministic one, so that the winner never depends on the clock)
Timer = Callable[[MergePlan, Callable[[], object]], float]


def time_call(fn: Callable[[], object], *, device: torch.device, warmup: int = 1,
              iters: int = 3) -> float:
    """Median µs of ``fn``: CUDA events on the card, the host clock
    otherwise."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3)
        else:
            s = time.perf_counter()
            fn()
            times.append((time.perf_counter() - s) * 1e6)
    return float(np.median(times))


def _tournament_cols(m: int, n: int, limit: int = 3) -> Tuple[int, ...]:
    """The ``limit`` common column counts nearest the comparator-cost
    optimum sqrt(m n / (m + n))."""
    cols = divisor_cols(m, n)
    if not cols:
        return ()
    c_star = (m * n / max(m + n, 1)) ** 0.5
    return tuple(sorted(sorted(cols, key=lambda c: abs(c - c_star))[:limit]))


def _merge2_candidates(m: int, n: int, dtype: torch.dtype) -> List[MergePlan]:
    """Every capable network family (the LOMS device at its tournament
    column counts). The port's kernels take raw floats only in the
    one-hot mode (``use_mxu``) and integers only exactly, so the
    reference's second permute engine has no candidate."""
    use_mxu = dtype.is_floating_point
    out = []
    for family in capable_families("merge2", (m, n)):
        for n_cols in (_tournament_cols(m, n) if family == "loms" else (1,)):
            out.append(MergePlan(kind="loms", network=family, n_cols=n_cols,
                                 use_mxu=use_mxu, source="autotune"))
    return out


def _sort_candidates(n: int, dtype: torch.dtype) -> List[MergePlan]:
    return [MergePlan(kind="loms", network=family, use_mxu=dtype.is_floating_point,
                      source="autotune") for family in capable_families("sort", (n,))]


def _topk_candidates(n: int, dtype: torch.dtype) -> List[MergePlan]:
    return [MergePlan(kind="loms", block=block, use_mxu=dtype.is_floating_point,
                      source="autotune")
            for block in (16, 32, 64, 128) if block <= n and n % block == 0]


def _rows(rng, batch: int, n: int, dtype: torch.dtype, device, sort: bool) -> torch.Tensor:
    x = torch.from_numpy(rng.integers(0, 1 << 16, (batch, n))).to(dtype)
    if sort:
        x = torch.sort(x, dim=-1).values
    return x.to(device)


def _autotune(op: str, key: str, cands: Sequence[MergePlan],
              runner: Callable[[MergePlan], Callable[[], object]], fallback: MergePlan,
              cache: AutotuneCache, timer: Timer) -> MergePlan:
    if not cands:
        return fallback
    best, best_us = None, float("inf")
    for plan in cands:
        us = float(timer(plan, runner(plan)))
        if us < best_us:
            best, best_us = plan, us
    best = dataclasses.replace(best, us=best_us)
    cache.put(key, best.to_entry())
    return best


def _setup(cache, device, iters, timer):
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cache = cache if cache is not None else default_cache()
    if timer is None:
        def timer(plan, fn):
            return time_call(fn, device=dev, iters=iters)
    return cache, dev, timer


def autotune_merge2(m: int, n: int, *, batch: int = 8, dtype: torch.dtype = torch.float32,
                    cache: Optional[AutotuneCache] = None,
                    candidates: Optional[Sequence[MergePlan]] = None, device=None,
                    iters: int = 3, timer: Optional[Timer] = None) -> MergePlan:
    """The tournament of one UP-m/DN-n merge: every capable family (LOMS
    column counts included) through the 2-way merge kernel (row 1) on the
    device; the winner is persisted and returned. A cache hit skips the
    measurement."""
    from repro_torch.kernels.loms_merge import loms_merge2

    cache, dev, timer = _setup(cache, device, iters, timer)
    key = plan_key("merge2", shapes=(batch, m, n), dtype=dtype_name(dtype))
    hit = cache.get(key)
    if hit is not None:
        return MergePlan.from_entry(hit, source="cache")
    cands = list(candidates) if candidates is not None else _merge2_candidates(m, n, dtype)
    rng = np.random.default_rng(0)
    a, b = (_rows(rng, batch, ln, dtype, dev, True) for ln in (m, n))

    def runner(p: MergePlan):
        return lambda: loms_merge2(a, b, network=p.network, n_cols=max(p.n_cols, 1),
                                   use_mxu=p.use_mxu)

    return _autotune("merge2", key, cands, runner, plan_merge2(m, n, dtype), cache, timer)


def autotune_sort(n: int, *, batch: int = 8, dtype: torch.dtype = torch.float32,
                  cache: Optional[AutotuneCache] = None, device=None, iters: int = 3,
                  timer: Optional[Timer] = None) -> MergePlan:
    """The tournament of the fused sort kernel (row 2): capable families."""
    from repro_torch.kernels.sort import loms_sort

    cache, dev, timer = _setup(cache, device, iters, timer)
    key = plan_key("sort", shapes=(batch, n), dtype=dtype_name(dtype))
    hit = cache.get(key)
    if hit is not None:
        return MergePlan.from_entry(hit, source="cache")
    x = _rows(np.random.default_rng(0), batch, n, dtype, dev, False)

    def runner(p: MergePlan):
        return lambda: loms_sort(x, network=p.network, use_mxu=p.use_mxu)

    return _autotune("sort", key, _sort_candidates(n, dtype), runner, plan_sort(n, dtype),
                     cache, timer)


def autotune_topk(n: int, k: int, *, batch: int = 8, dtype: torch.dtype = torch.float32,
                  cache: Optional[AutotuneCache] = None, device=None, iters: int = 3,
                  timer: Optional[Timer] = None) -> MergePlan:
    """The block of the router top-k kernel (row 3), axes of at most 512;
    a wider axis keeps the heuristic plan, as in the reference."""
    from repro_torch.kernels.topk import ROUTER_TOPK_MAX, router_topk

    cache, dev, timer = _setup(cache, device, iters, timer)
    key = plan_key("topk", shapes=(batch, n), k=k, dtype=dtype_name(dtype))
    hit = cache.get(key)
    if hit is not None:
        return MergePlan.from_entry(hit, source="cache")
    fallback = plan_topk(n, k, dtype)
    if n > ROUTER_TOPK_MAX:
        return fallback
    x = _rows(np.random.default_rng(0), batch, n, dtype, dev, False)

    def runner(p: MergePlan):
        return lambda: router_topk(x, k, block=p.block or 32)

    return _autotune("topk", key, _topk_candidates(n, dtype), runner, fallback, cache, timer)


def autotune_segmented(widths: Sequence[int], *, n_segments: int = 8,
                       dtype: torch.dtype = torch.float32,
                       cache: Optional[AutotuneCache] = None, device=None, iters: int = 3,
                       timer: Optional[Timer] = None) -> MergePlan:
    """The tournament of one segmented size class: a class sort (row 6)
    for one width, a class merge (row 7) for two."""
    from repro_torch.kernels.segmented import segment_class_merge, segment_class_sort

    widths = tuple(int(w) for w in widths)
    cache, dev, timer = _setup(cache, device, iters, timer)
    key = plan_key("segmented", shapes=(n_segments,) + widths, dtype=dtype_name(dtype))
    hit = cache.get(key)
    if hit is not None:
        return MergePlan.from_entry(hit, source="cache")
    fallback = plan_segmented(widths, dtype)
    rng = np.random.default_rng(0)

    def lens(w):
        return torch.from_numpy(rng.integers(1, w + 1, (n_segments, 1)).astype(np.int32)).to(dev)

    if len(widths) == 1:
        w = widths[0]
        x = torch.from_numpy(rng.normal(size=(n_segments, w))).to(dtype).to(dev)
        lx = lens(w)
        cands = _sort_candidates(w, dtype)

        def runner(p: MergePlan):
            return lambda: segment_class_sort(x, lx, network=p.network)
    else:
        wa, wb = widths
        a, b = (_rows(rng, n_segments, w, dtype, dev, True) for w in widths)
        la, lb = lens(wa), lens(wb)
        cands = _merge2_candidates(wa, wb, dtype)

        def runner(p: MergePlan):
            return lambda: segment_class_merge(a, b, la, lb, network=p.network,
                                               n_cols=max(p.n_cols, 1))

    return _autotune("segmented", key, cands, runner, fallback, cache, timer)


def autotune_op(op: str, lengths: Sequence[int], *, batch: int = 8,
                dtype: torch.dtype = torch.float32, k: Optional[int] = None,
                cache: Optional[AutotuneCache] = None, device=None, iters: int = 3,
                timer: Optional[Timer] = None) -> MergePlan:
    """The autotune front door, keyed as :func:`plan_op` is."""
    kw = dict(dtype=dtype, cache=cache, device=device, iters=iters, timer=timer)
    if op == "merge2":
        return autotune_merge2(lengths[0], lengths[1], batch=batch, **kw)
    if op == "sort":
        return autotune_sort(lengths[0], batch=batch, **kw)
    if op == "topk":
        return autotune_topk(lengths[0], k or 1, batch=batch, **kw)
    if op == "segmented":
        return autotune_segmented(lengths, n_segments=batch, **kw)
    # no measured tuner: the heuristic (or a cached) plan
    return plan_op(op, lengths, batch=batch, dtype=dtype, k=k, cache=cache)
