"""The backend registry: the realizations of the library's ops
(counterpart of ``repro.api.registry``).

Every backend is a :class:`Backend`: a name, a capability predicate over
:class:`~repro_torch.api.spec.SortSpec`, and one adapter per op it runs.
The dense adapters share one calling convention:

  merge(a, b, *, spec, pos=None)        -> (out, perm | None)
  merge_k(lists, *, spec, pos=None)     -> (out, perm | None)
  sort(x, *, spec, pos=None)            -> (out, perm | None)
  topk(x, k, *, spec, block=None)       -> (vals desc, idx)
  median(lists, *, spec)                -> out

Inputs are canonical 2-D ``(batch, length)`` problems, sort axis last,
ascending keys (the ops layer moves axes, encodes floats, flips
descending inputs, stabilises ties and gathers payloads). ``pos`` is the
int32 position lane to carry through the permutation; a backend that
cannot carry it says so in ``supports``. The ``cuda`` top-k adapter is
the exception: it takes the raw float rows (its kernels encode them on
load) and returns their values.

Built-in backends: ``schedule`` (the schedule executor, plain torch: runs
everything, carries payloads), ``cuda`` (the hand-written kernels, the
reference's ``pallas``), ``streaming`` (the grid merge and the k-way
tiles), ``segmented`` (CSR segments by size class), ``lax`` (plain
``torch.sort`` / ``torch.topk``: a cross-check, and the last rung of the
degradation ladder) and ``sharded`` (the distributed sample-sort and the
device-tree top-k over a :class:`~repro_torch.parallel.Parallelism`'s TP
axis; its adapters take ``par=`` besides the convention's arguments).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.kernels.common import take_along
from repro_torch.resilience.failpoints import failpoint

from .spec import SortSpec


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    run: Mapping[str, Callable]  # op name -> adapter
    supports: Callable[[SortSpec], bool]
    description: str = ""
    #: whether the backend runs ``spec`` as one fused launch (key
    #: transform, payload lanes and ordering inside the kernel)
    supports_fused: Callable[[SortSpec], bool] = lambda spec: False


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend, overwrite: bool = False) -> None:
    """Add a backend to the registry (``overwrite=True`` to replace)."""
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}") from None


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _dense(spec: SortSpec) -> bool:
    return spec.segment_offsets is None


# ---------------------------------------------------------------------------
# schedule: the executor, plain torch; runs every op, carries payloads
# ---------------------------------------------------------------------------


def _sched_merge(a, b, *, spec, pos=None):
    from . import schedules

    failpoint("executor.run.merge")
    if pos is None:
        return schedules.merge(a, b, kind=spec.network), None
    return schedules.merge(a, b, kind=spec.network, payload=pos)


def _sched_merge_k(lists, *, spec, pos=None):
    from . import schedules

    failpoint("executor.run.merge_k")
    if pos is None:
        return schedules.merge_k(lists, kind=spec.network), None
    return schedules.merge_k(lists, kind=spec.network, payload=pos)


def _sched_sort(x, *, spec, pos=None):
    from . import schedules

    failpoint("executor.run.sort")
    kind = spec.network if spec.network != "batcher-bitonic" else "bitonic"
    if pos is None:
        return schedules.sort(x, kind=kind), None
    return schedules.sort(x, kind=kind, payload=pos)


def _sched_topk(x, k, *, spec, block=None):
    from . import schedules

    failpoint("executor.run.topk")
    return schedules.topk(x, k, block=block or 0)


def _sched_median(lists, *, spec):
    from . import schedules

    failpoint("executor.run.median")
    return schedules.median_of_lists(lists, kind="mwms" if spec.network == "mwms" else "loms")


register_backend(Backend(
    name="schedule",
    run={"merge": _sched_merge, "merge_k": _sched_merge_k, "sort": _sched_sort,
         "topk": _sched_topk, "median": _sched_median},
    supports=_dense,
    description="the schedule executor in plain torch (any shape and op, "
                "payload-capable); no kernel",
))


# ---------------------------------------------------------------------------
# cuda: the hand-written kernels (their plain versions for a CPU tensor)
# ---------------------------------------------------------------------------


def _cuda_merge(a, b, *, spec, pos=None):
    from repro_torch.kernels.loms_merge import loms_merge2
    from repro_torch.streaming.planner import plan_op

    if pos is not None:
        raise ValueError("the cuda merge adapter is values-only")
    plan = plan_op("merge2", (a.shape[-1], b.shape[-1]), batch=a.shape[0], dtype=a.dtype)
    if plan.kind != "loms":  # no common column count: the executor, as the reference
        from . import schedules

        return schedules.merge(a, b), None
    return loms_merge2(a.contiguous(), b.contiguous(), network=plan.network,
                       n_cols=plan.n_cols,
                       use_mxu=plan.use_mxu and a.dtype.is_floating_point)[0], None


def _cuda_merge_k(lists, *, spec, pos=None):
    from repro_torch.kernels.ops import merge_k

    if pos is not None:
        raise ValueError("the cuda merge_k adapter is values-only")
    return merge_k(lists), None


def _cuda_sort(x, *, spec, pos=None):
    from repro_torch.kernels.ops import sort

    if pos is not None:
        raise ValueError("the cuda sort adapter is values-only")
    return sort(x.contiguous()), None


def _cuda_topk(x, k, *, spec, block=None):
    from repro_torch.kernels.ops import topk

    return topk(x, k, block=block)


def _cuda_median(lists, *, spec):
    from repro_torch.kernels.ops import median_k

    return median_k(lists)


def _cuda_fused(spec: SortSpec) -> bool:
    from .fused import fused_eligible

    return fused_eligible(spec)


#: the value types the kernels take (floats as keys or raw, int32 raw)
_KERNEL_DTYPES = ("float32", "bfloat16", "float16", "int32")


def median_device_fits(spec: SortSpec) -> bool:
    """The LOMS median device takes an odd number (3 or more) of equal
    odd-length lists."""
    lens = spec.lengths
    return len(lens) >= 3 and len(lens) % 2 == 1 and len(set(lens)) == 1 and lens[0] % 2 == 1


def _cuda_supports(spec: SortSpec) -> bool:
    if spec.network != "loms" or not _dense(spec) or spec.dtype not in _KERNEL_DTYPES:
        return False
    if spec.op == "topk":  # indices are native; payload / stable ride them
        return True
    if spec.op == "sort" or spec.needs_perm:
        return _cuda_fused(spec)  # payload lanes ride the fused launch only
    if spec.op == "median":  # the device itself wants an odd count (ops checks)
        return len(set(spec.lengths)) == 1 and spec.lengths[0] % 2 == 1
    return True


register_backend(Backend(
    name="cuda",
    run={"merge": _cuda_merge, "merge_k": _cuda_merge_k, "sort": _cuda_sort,
         "topk": _cuda_topk, "median": _cuda_median},
    supports=_cuda_supports,
    supports_fused=_cuda_fused,
    description="the hand-written CUDA kernels (their plain versions for a CPU "
                "tensor): fused single-launch sort and merges with the key "
                "transform and payload lanes inside, index-carrying top-k",
))


# ---------------------------------------------------------------------------
# streaming: the grid merge (row 9) and the k-way tiles (row 8)
# ---------------------------------------------------------------------------


def _streaming_merge(a, b, *, spec, pos=None):
    from repro_torch.streaming import chunked_merge

    if pos is not None:
        raise ValueError("the streaming merges are values-only")
    return chunked_merge(a, b), None


def _streaming_merge_k(lists, *, spec, pos=None):
    from repro_torch.streaming import chunked_merge_k

    if pos is not None:
        raise ValueError("the streaming merges are values-only")
    return chunked_merge_k(list(lists)), None


register_backend(Backend(
    name="streaming",
    run={"merge": _streaming_merge, "merge_k": _streaming_merge_k},
    supports=lambda spec: (spec.op in ("merge", "merge_k") and not spec.needs_perm
                           and _dense(spec)),
    description="the grid merge and the k-way tiles: a fixed working set for "
                "rows of any length",
))


# ---------------------------------------------------------------------------
# sharded: the sample-sort and the device-tree top-k over the TP axis
# ---------------------------------------------------------------------------


def _needs_par(par) -> None:
    if par is None:
        raise ValueError("the sharded backend needs a Parallelism (par=)")


def _sharded_topk(x, k, *, spec, par=None, block=None):
    from repro_torch.streaming.tree import tree_topk_for

    _needs_par(par)
    return tree_topk_for(par, x, k)


def _sharded_axis(par, lengths) -> str:
    from repro_torch.parallel.sharding import dist_sort_axis

    _needs_par(par)
    axis = dist_sort_axis(par, lengths)
    if axis is None:
        raise ValueError(f"lengths {tuple(lengths)} do not split over the TP axis "
                         f"of {par.tp_size}")
    return axis


def _sharded_sort(x, *, spec, pos=None, par=None):
    from repro_torch.parallel.dist_sort import sample_sort

    axis = _sharded_axis(par, (x.shape[-1],))
    return sample_sort(x, mesh=par.mesh, axis_name=axis, pos=pos)


def _sharded_merge_k(lists, *, spec, pos=None, par=None):
    from repro_torch.parallel.dist_sort import sample_merge_k

    axis = _sharded_axis(par, tuple(t.shape[-1] for t in lists))
    return sample_merge_k(lists, mesh=par.mesh, axis_name=axis,
                          pos=None if pos is None else list(pos))


def _sharded_merge(a, b, *, spec, pos=None, par=None):
    return _sharded_merge_k([a, b], spec=spec, pos=pos, par=par)


def _sharded_supports(spec: SortSpec) -> bool:
    if not _dense(spec):
        return False
    if spec.op == "topk":
        return spec.sharded
    # the sample-sort realises the LOMS family only; spec.sharded already
    # says that every list length divides the offered TP axis
    return spec.op in ("merge", "merge_k", "sort") and spec.sharded and spec.network == "loms"


register_backend(Backend(
    name="sharded",
    run={"topk": _sharded_topk, "sort": _sharded_sort,
         "merge": _sharded_merge, "merge_k": _sharded_merge_k},
    supports=_sharded_supports,
    description="distributed sample-sort / k-way merge (local sort, regular-sampling "
                "splitters, all_to_all, a merge a rank, rebalance) and the log-depth "
                "tree top-k over the TP axis (repro_torch.parallel, streaming.tree)",
))


# ---------------------------------------------------------------------------
# segmented: CSR segments by size class
# ---------------------------------------------------------------------------
#
# These adapters speak flat CSR ``(values, segment_offsets)`` problems, the
# offsets riding on ``spec.segment_offsets``.


def _segmented_sort(values, *, spec, **kw):
    from repro_torch.segmented import segment_sort_impl

    return segment_sort_impl(values, spec.segment_offsets[0], **kw)


def _segmented_merge(a, b, *, spec, **kw):
    from repro_torch.segmented import segment_merge_impl

    offs = spec.segment_offsets
    return segment_merge_impl(a, b, offs[0], offs[1], **kw)


def _segmented_topk(values, k, *, spec, **kw):
    from repro_torch.segmented import segment_topk_impl

    return segment_topk_impl(values, spec.segment_offsets[0], k, **kw)


def _segmented_argmax(values, *, spec, **kw):
    from repro_torch.segmented import segment_argmax_impl

    return segment_argmax_impl(values, spec.segment_offsets[0], **kw)


register_backend(Backend(
    name="segmented",
    run={"sort": _segmented_sort, "merge": _segmented_merge,
         "topk": _segmented_topk, "argmax": _segmented_argmax},
    supports=lambda spec: (spec.segment_offsets is not None and not spec.stable
                           and spec.op in ("sort", "merge", "topk")),
    description="CSR segment sort / merge / top-k: one class kernel launch per "
                "pow2 size class, the grid-merge spill past the widest class",
))


# ---------------------------------------------------------------------------
# lax: plain torch sort / top-k (a cross-check; auto picks it only for the
# median the LOMS device cannot take)
# ---------------------------------------------------------------------------


def _lax_sort(x, *, spec, pos=None):
    if pos is None:
        return torch.sort(x, dim=-1).values, None
    order = torch.argsort(x, dim=-1, stable=True)
    return take_along(x, -1, order), take_along(pos, -1, order)


def _lax_merge(a, b, *, spec, pos=None):
    return _lax_sort(torch.cat([a, b], dim=-1), spec=spec,
                     pos=None if pos is None else torch.cat(list(pos), dim=-1))


def _lax_merge_k(lists, *, spec, pos=None):
    return _lax_sort(torch.cat(list(lists), dim=-1), spec=spec,
                     pos=None if pos is None else torch.cat(list(pos), dim=-1))


def _lax_topk(x, k, *, spec, block=None):
    # descending, equal values in ascending index order (``lax.top_k``'s)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _lax_median(lists, *, spec):
    x = torch.sort(torch.cat(list(lists), dim=-1), dim=-1).values
    return x[..., x.shape[-1] // 2]


register_backend(Backend(
    name="lax",
    run={"merge": _lax_merge, "merge_k": _lax_merge_k, "sort": _lax_sort,
         "topk": _lax_topk, "median": _lax_median},
    supports=_dense,
    description="plain torch.sort / stable argsort (not oblivious; a "
                "cross-check, and the median the LOMS device cannot take)",
))
