"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
``repro.parallel.pipeline``).

Each rank owns one contiguous stage. The skew-and-rotate schedule runs
``n_micro + n_stages - 1`` ticks: stage 0 takes microbatch ``t``, every
rank applies its stage, the last stage emits microbatch ``t - (n_stages -
1)``, and the activations move one stage on (``batch_isend_irecv`` to
rank ``r + 1 mod S``, the reference's ``ppermute`` ring). Bubble fraction
(S - 1) / (S - 1 + M).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import comm


def pipeline_apply_local(stage_fn: Callable, params_local, x: torch.Tensor, *, group
                         ) -> torch.Tensor:
    """This rank's stage over every microbatch of ``x`` (n_micro, mb, ...):
    the schedule's outputs, which are real on the last stage only (the
    reference's ``shard_map`` body)."""
    n_stages, rank = dist.get_world_size(group), dist.get_rank(group)
    n_micro = x.shape[0]
    state = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if rank == 0:  # stage 0 ingests microbatch t (the last one past the end)
            state = x[min(t, n_micro - 1)]
        state = stage_fn(params_local, state)
        if rank == n_stages - 1 and t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = state
        state = comm.ring_shift(state, group)
    return outputs


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` (n_micro, mb, ...) through the stages stacked on the
    leading axis of ``stage_params``'s leaves, one stage a rank of
    ``mesh[axis]``. Every rank passes the full inputs and gets the last
    stage's outputs."""
    group, rank = mesh.get_group(axis), mesh.get_local_rank(axis)
    n_stages = dist.get_world_size(group)
    params_local = pytree.tree_map(lambda a: a[rank], stage_params)
    out = pipeline_apply_local(stage_fn, params_local, x, group=group)
    dist.broadcast(out, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return out
