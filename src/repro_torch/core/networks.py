"""Data-oblivious sort/merge network representation and its executors
(counterpart of ``repro.core.networks``).

The paper's hardware devices (LOMS, S2MS, MWMS, N-sorters) are fixed
comparator structures whose wiring does not depend on the data. Every
device is a :class:`Schedule`:

  * a *working vector* of ``size`` cells (the 2-D setup array, flattened,
    holes included but never touched),
  * ``setup_scatter``: the cell each input value is written to (the
    paper's setup array, Appendix A),
  * a tuple of :class:`Stage`\\ s; each stage is a set of disjoint
    :class:`Group`\\ s sorted in parallel,
  * ``output_gather``: the final read-out order (row-major for 2-way,
    serpentine for k-way).

A :class:`Group` lists its cells in ascending output order. With ``runs``
its input is a concatenation of ascending runs, merged by a stable
multi-run rank (the hardware S2MS, earlier runs win ties); without, it is
a stable rank sort (the single-stage N-sorter).

The dataclasses, the numpy executor and the 0-1 validators are copies of
the reference's; :func:`rank_sort`, :func:`rank_merge_runs`,
:func:`apply_schedule` and :func:`apply_schedule_with_payload` are the
same executor in torch ops (the ``schedule`` backend of every op),
bit-equal to the reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import scatter_along

__all__ = ["Group", "Stage", "Schedule", "apply_schedule",
           "apply_schedule_with_payload", "apply_schedule_np", "rank_sort",
           "rank_merge_runs", "depth", "comparator_count", "validate_01_merge",
           "validate_01_sort"]


@dataclasses.dataclass(frozen=True)
class Group:
    """A set of cells sorted together in one stage.

    idx:  cell indices of the working vector in ascending output order
          (idx[0] receives the minimum).
    runs: optional run lengths: the group's input, read in idx order, is
          len(runs) concatenated ascending runs (a stable rank merge);
          None: a stable rank sort.
    """

    idx: Tuple[int, ...]
    runs: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.runs is not None:
            assert sum(self.runs) == len(self.idx), (self.runs, self.idx)
            assert all(r > 0 for r in self.runs)

    @property
    def n(self) -> int:
        return len(self.idx)

    def comparators(self) -> int:
        """Comparator count: cross-run pairs for merges, all pairs for sorts."""
        if self.n <= 1:
            return 0
        if self.runs is None:
            return self.n * (self.n - 1) // 2
        total = 0
        for i in range(len(self.runs)):
            for j in range(i + 1, len(self.runs)):
                total += self.runs[i] * self.runs[j]
        return total


@dataclasses.dataclass(frozen=True)
class Stage:
    groups: Tuple[Group, ...]

    def __post_init__(self):
        seen = set()
        for g in self.groups:
            for i in g.idx:
                assert i not in seen, f"cell {i} appears twice in one stage"
                seen.add(i)

    def comparators(self) -> int:
        return sum(g.comparators() for g in self.groups)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete oblivious merge/sort device."""

    name: str
    size: int  # working vector length (R*C of the setup array)
    setup_scatter: Tuple[int, ...]  # input position -> working cell
    output_gather: Tuple[int, ...]  # output position -> working cell
    stages: Tuple[Stage, ...]
    meta: Tuple[Tuple[str, object], ...] = ()

    @property
    def n_inputs(self) -> int:
        return len(self.setup_scatter)

    @property
    def n_outputs(self) -> int:
        return len(self.output_gather)

    def meta_dict(self) -> dict:
        return dict(self.meta)


# ---------------------------------------------------------------------------
# depth-1 primitives in torch: rank sort (N-sorter), multi-run merge (S2MS)
# ---------------------------------------------------------------------------


#: the most lanes (bytes of bool) a comparison cloud of the executor may
#: hold at once: a stage class's clouds are computed in slabs along the
#: query axis, so that the widest (the top levels of a sort of 262,144
#: lanes) stays small on the card; each slab is counted into int32 (4x
#: its bytes at most, 1 GiB); the counts of the slabs add, so the ranks
#: are the whole cloud's for any input
CLOUD_BUDGET = 1 << 28


def _slabs(rows: int, n_query: int, n_key: int):
    """Query slices ``(i0, i1)`` whose (rows, i1 - i0, n_key) bool cloud
    stays within :data:`CLOUD_BUDGET`."""
    step = max(1, min(n_query, CLOUD_BUDGET // max(rows * n_key, 1)))
    return [(i0, min(n_query, i0 + step)) for i0 in range(0, n_query, step)]


def _rows(x: torch.Tensor) -> int:
    return x.numel() // max(x.shape[-1], 1)


def rank_sort(x: torch.Tensor, payload: Optional[torch.Tensor] = None):
    """Stable single-stage N-sorter along the last axis: the pairwise
    comparison cloud gives each element its rank (slab by slab), then a
    scatter."""
    n = x.shape[-1]
    if n == 1:
        return (x, payload) if payload is not None else x
    pos = torch.arange(n, device=x.device)
    w = x[..., None, :]
    parts = []
    for i0, i1 in _slabs(_rows(x), n, n):
        v = x[..., i0:i1, None]
        before = w < v
        tie = w == v
        tie &= pos[None, :] < pos[i0:i1, None]
        before |= tie
        parts.append(before.sum(dim=-1, dtype=torch.int32))
    rank = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    out = scatter_along(x, -1, rank)
    return out if payload is None else (out, scatter_along(payload, -1, rank))


def _count_before(vt: torch.Tensor, vs: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """For each of ``vs``'s values, how many of ``vt``'s go first
    (``vt <= vs`` when ``inclusive``, else ``vt < vs``), slab by slab."""
    parts = []
    for i0, i1 in _slabs(_rows(vs), vs.shape[-1], vt.shape[-1]):
        q = vs[..., i0:i1, None]
        c = (vt[..., None, :] <= q) if inclusive else (vt[..., None, :] < q)
        parts.append(c.sum(dim=-1, dtype=torch.int32))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _run_ranks(x: torch.Tensor, runs: Sequence[int]) -> torch.Tensor:
    """S2MS ranks of a concatenation of ascending runs: own index plus,
    for every other run, its count of values that go first (earlier runs
    win ties)."""
    offs = np.cumsum((0,) + tuple(runs))
    pieces = [x[..., offs[s]:offs[s + 1]] for s in range(len(runs))]
    ranks = []
    for s, vs in enumerate(pieces):
        r = torch.arange(runs[s], device=x.device).expand(vs.shape)
        for t, vt in enumerate(pieces):
            if t != s:
                r = r + _count_before(vt, vs, inclusive=t < s)
        ranks.append(r)
    return torch.cat(ranks, dim=-1)


def rank_merge_runs(x: torch.Tensor, runs: Sequence[int],
                    payload: Optional[torch.Tensor] = None):
    """Stable single-stage merge of pre-sorted ascending runs (S2MS)."""
    runs = tuple(int(r) for r in runs)
    assert sum(runs) == x.shape[-1]
    if len(runs) == 1 or x.shape[-1] == 1:
        return (x, payload) if payload is not None else x
    rank = _run_ranks(x, runs)
    out = scatter_along(x, -1, rank)
    return out if payload is None else (out, scatter_along(payload, -1, rank))


def _compare_exchange_pairs(x, payload=None):
    """Groups of 2: the hardware 2-sorter (min to the lower cell)."""
    a, b = x[..., 0], x[..., 1]
    swap = a > b
    out = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], dim=-1)
    if payload is None:
        return out
    pa, pb = payload[..., 0], payload[..., 1]
    return out, torch.stack([torch.where(swap, pb, pa), torch.where(swap, pa, pb)], dim=-1)


# ---------------------------------------------------------------------------
# schedule executors
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stage_classes(stage: Stage):
    """The stage's groups batched by identical (length, runs), in the
    order each class first appears (the kernels read the wiring in it)."""
    classes = {}
    for g in stage.groups:
        if g.n <= 1:
            continue
        classes.setdefault((g.n, g.runs), []).append(g.idx)
    return tuple((n, runs, np.asarray(idx_lists, dtype=np.int32))
                 for (n, runs), idx_lists in classes.items())


#: per (wiring array, device): the index tensor uploaded once; the key
#: object is kept beside it so that its id stays its own
_DEVICE_INDEX: dict = {}


def _device_index(owner, key: str, values, device: torch.device) -> torch.Tensor:
    """``values`` as a long tensor on ``device``, uploaded once per
    (owner, key, device): a schedule's wiring is fixed, and the top levels
    of a sort of 262,144 lanes would upload megabytes a stage."""
    slot = (id(owner), key, str(device))
    hit = _DEVICE_INDEX.get(slot)
    if hit is None:
        t = torch.as_tensor(np.asarray(values, dtype=np.int64).reshape(-1), device=device)
        hit = _DEVICE_INDEX[slot] = (owner, t)
    return hit[1]


def _apply_stage(stage: Stage, w: torch.Tensor, pw: Optional[torch.Tensor]):
    """One stage, in place on the executor's own working vectors."""
    for n, runs, idx in _stage_classes(stage):
        flat = _device_index(idx, "flat", idx, w.device)
        vals = w[..., flat].reshape(w.shape[:-1] + idx.shape)
        pv = None if pw is None else pw[..., flat].reshape(pw.shape[:-1] + idx.shape)
        if n == 2 and runs in (None, (1, 1)):
            res = _compare_exchange_pairs(vals, pv)
        elif runs is None:
            res = rank_sort(vals, pv)
        else:
            res = rank_merge_runs(vals, runs, pv)
        if pw is not None:
            vals, pv = res
            pw[..., flat] = pv.reshape(pv.shape[:-2] + (len(flat),))
        else:
            vals = res
        w[..., flat] = vals.reshape(vals.shape[:-2] + (len(flat),))
    return w, pw


def _scatter_setup(sched: Schedule, x: torch.Tensor) -> torch.Tensor:
    setup = _device_index(sched, "setup", sched.setup_scatter, x.device)
    w = torch.zeros(x.shape[:-1] + (sched.size,), dtype=x.dtype, device=x.device)
    w[..., setup] = x
    return w


def _gather_out(sched: Schedule, w: torch.Tensor) -> torch.Tensor:
    return w[..., _device_index(sched, "gather", sched.output_gather, w.device)]


def apply_schedule(sched: Schedule, x: torch.Tensor,
                   n_stages: Optional[int] = None) -> torch.Tensor:
    """Run the device on ``x`` (last axis: the concatenated input lists).
    ``n_stages`` truncates it (the paper's early exit: the median after 2
    of 3 stages)."""
    assert x.shape[-1] == sched.n_inputs, (tuple(x.shape), sched.n_inputs)
    w = _scatter_setup(sched, x)
    for st in (sched.stages if n_stages is None else sched.stages[:n_stages]):
        w, _ = _apply_stage(st, w, None)
    return _gather_out(sched, w)


def apply_schedule_with_payload(sched: Schedule, x: torch.Tensor, payload: torch.Tensor,
                                n_stages: Optional[int] = None):
    """:func:`apply_schedule` carrying a payload (e.g. positions) of the
    same shape: ``(values, payload)``."""
    assert x.shape == payload.shape[:x.ndim] and x.shape[-1] == sched.n_inputs
    w, pw = _scatter_setup(sched, x), _scatter_setup(sched, payload)
    for st in (sched.stages if n_stages is None else sched.stages[:n_stages]):
        w, pw = _apply_stage(st, w, pw)
    return _gather_out(sched, w), _gather_out(sched, pw)


# ---------------------------------------------------------------------------
# structural metrics and 0-1 principle validation (numpy, as the reference)
# ---------------------------------------------------------------------------


def depth(sched: Schedule) -> int:
    """Number of dependent stages (the hardware propagation-delay analog)."""
    return len(sched.stages)


def comparator_count(sched: Schedule) -> int:
    return sum(st.comparators() for st in sched.stages)


def _per_list_sorted_01_patterns(lens: Sequence[int]) -> np.ndarray:
    """Every 0-1 input whose lists are each sorted ascending: the
    prod(len + 1) patterns the 0-1 principle needs for a merge network."""
    parts = []
    for ln in lens:
        rows = [[0] * (ln - ones) + [1] * ones for ones in range(ln + 1)]
        parts.append(np.asarray(rows, dtype=np.int32))
    grids = np.meshgrid(*[np.arange(p.shape[0]) for p in parts], indexing="ij")
    idxs = [g.reshape(-1) for g in grids]
    return np.concatenate([p[i] for p, i in zip(parts, idxs)], axis=-1)


def _np_rank_merge(vals: np.ndarray, runs) -> np.ndarray:
    """Numpy replica of :func:`rank_merge_runs`, not a sort: a violated run
    assumption misbehaves here as in the device, so the validation sees
    the true hardware semantics."""
    offs = np.cumsum((0,) + tuple(runs))
    pieces = [vals[..., offs[s]:offs[s + 1]] for s in range(len(runs))]
    ranks = []
    for s, vs in enumerate(pieces):
        r = np.broadcast_to(np.arange(runs[s]), vs.shape).copy()
        for t, vt in enumerate(pieces):
            if t == s:
                continue
            if t < s:
                r = r + (vt[..., None, :] <= vs[..., :, None]).sum(axis=-1)
            else:
                r = r + (vt[..., None, :] < vs[..., :, None]).sum(axis=-1)
        ranks.append(r)
    rank = np.concatenate(ranks, axis=-1)
    out = np.zeros_like(vals)
    np.put_along_axis(out, rank, vals, axis=-1)
    return out


def apply_schedule_np(sched: Schedule, x: np.ndarray, n_stages=None) -> np.ndarray:
    """Pure-numpy executor (the builders' 0-1 validation)."""
    w = np.zeros(x.shape[:-1] + (sched.size,), dtype=x.dtype)
    w[..., np.asarray(sched.setup_scatter, dtype=np.int32)] = x
    for st in (sched.stages if n_stages is None else sched.stages[:n_stages]):
        for n, runs, idx in _stage_classes(st):
            flat = idx.reshape(-1)
            vals = w[..., flat].reshape(x.shape[:-1] + idx.shape)
            vals = np.sort(vals, axis=-1) if runs is None else _np_rank_merge(vals, runs)
            w[..., flat] = vals.reshape(x.shape[:-1] + (len(flat),))
    return w[..., np.asarray(sched.output_gather, dtype=np.int32)]


def validate_01_merge(sched: Schedule, lens: Sequence[int], n_stages=None) -> bool:
    """0-1-principle check that ``sched`` merges any per-list-sorted input."""
    out = apply_schedule_np(sched, _per_list_sorted_01_patterns(lens), n_stages)
    return bool((np.diff(out, axis=-1) >= 0).all())


def validate_01_sort(sched: Schedule) -> bool:
    """0-1-principle check for an unrestricted sorting network (2^n inputs)."""
    n = sched.n_inputs
    assert n <= 22, "exhaustive 0-1 validation limited to n<=22"
    pats = ((np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]) & 1).astype(np.int32)
    out = apply_schedule_np(sched, pats)
    return bool((np.diff(out, axis=-1) >= 0).all())
