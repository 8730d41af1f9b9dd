"""Sharded parameters through the model stack: the SPMD context of one
model call (the counterpart of the reference's GSPMD layouts under
``par``, ``src/repro/parallel/sharding.py:9-12``).

The reference hands its step to ``jax.jit`` with parameter shardings from
:func:`~.sharding.build_param_pspecs`, anchors activations with
``Parallelism.constrain`` and lets the compiler insert the collectives.
PyTorch has no partitioner, so each layer of :mod:`repro_torch.models`
states its layout, and this module carries it out:

* **Parameters** are DTensors placed by their specs
  (:func:`~.sharding.shard_params`): FSDP over ``data`` (the ``embed``
  dims), TP / EP over ``model``. A layer takes each leaf to its compute
  placement with :meth:`SpmdContext.fetch`: ``Replicate()`` on every dp
  axis (the per-layer FSDP all-gather, done explicitly before the
  layer's products so DTensor never gathers the batch instead) and the
  layer's own TP placement on ``model``. The local tensor comes out with
  its gradient's placements stated (``to_local(grad_placements=...)``):
  ``Partial()`` on a dp axis the batch is split over, so the backward of
  the gather is the gradient's reduce-scatter.
* **Activations** are local tensors: this rank's rows of the batch
  (``constrain(x, dp, ...)`` of the full input, the stack's input anchor,
  ``transformer.py:57-58``), replicated over ``model``. A TP region
  (Megatron's column- then row-parallel pair) is entered by
  :meth:`~SpmdContext.copy_to` (identity forward, all-reduce of the
  gradient) and left by :meth:`~SpmdContext.reduce_from` (all-reduce
  forward, identity backward) or :meth:`~SpmdContext.gather_from`. A
  replicated leaf used inside a region has a partial gradient on
  ``model`` (``inside=True``).
* **Caches** are DTensors placed by :func:`~.sharding.cache_pspecs`. A
  layer reads and writes its local shards in that layout
  (:meth:`~SpmdContext.cache_local`, :meth:`~SpmdContext.cache_store`):
  attention and MLA decode over a cache split on its contraction dim by
  partial scores and one all-reduce, the SSM on its heads or its
  ``d_state`` block; no cache is gathered.
* A weight whose spec splits it over ``model`` is used in that layout:
  column or row blocks, the activations exchanged instead
  (:meth:`~SpmdContext.gather_blocks`, :meth:`~SpmdContext.rows_to_cols`,
  :meth:`~SpmdContext.tp_sum`); no weight is gathered over ``model``.

DTensor rules the stack does without: every product, the chunked flash
attention and its ``torch.autograd.Function``, the MoE dispatch and the
SSM scan run on local tensors; the collectives are the explicit ones
here (``torch.distributed._functional_collectives``, which a dispatch
mode sees, so the dry-run counts them) and DTensor's own
``redistribute`` for the parameter and cache layouts.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .sharding import Parallelism, axis_sizes


def _funcol():
    import torch.distributed._functional_collectives as funcol

    return funcol


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over ``group``; out of place."""
    f = _funcol()
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, group))


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    f = _funcol()
    return f.wait_tensor(f.all_gather_tensor(x.contiguous(), dim, group))


class _CopyTo(torch.autograd.Function):
    """Entry of a TP region: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Exit of a row-parallel product: all-reduce forward, identity
    backward (everything after it is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Exit of a region sharded along ``dim``: all-gather forward, this
    rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim, size, rank):
        ctx.dim, ctx.size, ctx.rank = dim, size, rank
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None, None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, the reduce-scatter of
    the gradient (each rank's use of the gathered tensor differs)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        f = _funcol()
        return f.wait_tensor(f.reduce_scatter_tensor(g.contiguous(), "sum", ctx.dim,
                                                     ctx.group)), None, None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a sum every rank uses in its own
    way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _RowsToCols(torch.autograd.Function):
    """(B, P * r, F) sharded by rows over a group of P -> (B, P * r, F / P)
    sharded by columns: one all_to_all; backward, the inverse one."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _rows_to_cols(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _cols_to_rows(g, ctx.group, ctx.size), None, None


def _rows_to_cols(x, group, size):
    from .comm import all_to_all

    b, r, f = x.shape
    blocks = x.reshape(b, r, size, f // size).movedim(2, 0)  # [j]: rank j's columns
    got = all_to_all(blocks.contiguous(), group, dim=0)  # [i]: rank i's rows
    return got.movedim(0, 1).reshape(b, size * r, f // size)


def _cols_to_rows(y, group, size):
    from .comm import all_to_all

    b, n, c = y.shape
    blocks = y.reshape(b, size, n // size, c).movedim(1, 0)  # [i]: rank i's rows
    got = all_to_all(blocks.contiguous(), group, dim=0)  # [j]: rank j's columns
    return got.permute(1, 2, 0, 3).reshape(b, n // size, size * c)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def _placements(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * len(axis_sizes(mesh))


def as_dtensor(t, mesh):
    """A DTensor as it is; a plain tensor as a DTensor replicated over
    ``mesh``."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, _placements(mesh), run_check=False)


def same_layout(a, b, mesh) -> bool:
    """Two placement lists equal on every mesh axis of more than one rank
    (a size-1 axis holds the whole tensor either way)."""
    sizes = list(axis_sizes(mesh).values())
    return all(x == y for x, y, n in zip(a, b, sizes) if n > 1)


class SpmdContext:
    """The layout of one model call under ``par`` over a batch of ``batch``
    rows: the batch splits over the dp axes where it divides them
    (``par.dp_for``), else every dp rank runs every row."""

    def __init__(self, par: Parallelism, batch: int):
        self.par = par
        self.mesh = par.mesh
        self.sizes = axis_sizes(par.mesh)
        self.names = tuple(self.sizes)
        self.tp = self.sizes.get(par.tp_axis, 1)
        self.tp_group = par.group(par.tp_axis) if self.tp > 1 else None
        self.tp_rank = par.coordinate(par.tp_axis) if self.tp > 1 else 0
        self.dp = par.dp_size > 1 and par.dp_for(batch) is not None

    # -- layouts ------------------------------------------------------------

    def split(self, n: int) -> bool:
        """Whether a dim of ``n`` shards over the TP axis."""
        return self.tp > 1 and n % self.tp == 0

    def _target(self, current, model):
        """Placements: ``model`` on the TP axis, Replicate on the others;
        a size-1 axis keeps ``current``'s (no redistribute for nothing)."""
        from torch.distributed.tensor import Replicate

        out = []
        for i, name in enumerate(self.names):
            if self.sizes[name] == 1:
                out.append(current[i])
            elif name == self.par.tp_axis:
                out.append(model)
            else:
                out.append(Replicate())
        return out

    def fetch(self, leaf, dim: Optional[int] = None, inside: bool = False) -> torch.Tensor:
        """The local tensor of one parameter leaf in its compute layout:
        gathered over the dp axes, ``Shard(dim)`` on the TP axis (``dim``
        None: replicated). ``inside``: a replicated leaf used inside a TP
        region, whose gradient is partial over the TP axis."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        t = as_dtensor(leaf, self.mesh)
        split = dim is not None and self.tp > 1
        place = self._target(t.placements, Shard(dim) if split else Replicate())
        grads = []
        for i, name in enumerate(self.names):
            if name == self.par.tp_axis:
                grads.append(place[i] if split or self.tp == 1 else
                             (Partial() if inside else Replicate()))
            elif self.sizes[name] == 1:
                grads.append(place[i])
            else:
                grads.append(Partial() if self.dp and name in self.par.dp_axes
                             else Replicate())
        if not same_layout(t.placements, place, self.mesh):
            t = t.redistribute(placements=place)
        return t.to_local(grad_placements=grads)

    def local(self, p: dict, shard: Optional[Dict[str, int]] = None,
              inside: bool = False) -> dict:
        """:meth:`fetch` of every leaf of a layer's dict. ``shard`` maps a
        sub-dict to the TP dim of its weight ``w`` (its bias ``b`` shards
        one dim lower, the bias having no input dim)."""
        shard = shard or {}
        out = {}
        for k, v in p.items():
            d = shard.get(k)
            if isinstance(v, dict):
                out[k] = {n: self.fetch(t, None if d is None else (d - 1 if n == "b" else d),
                                        inside) for n, t in v.items()}
            else:
                out[k] = self.fetch(v, d, inside)
        return out

    # -- activations ----------------------------------------------------------

    def rows(self, x):
        """This rank's rows of a full batch entry (``constrain(x, dp,
        None, ...)``): all of them where the batch does not split."""
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            import numpy as np

            x = torch.from_numpy(np.asarray(x))
        dims = (self.par.dp_axes if self.dp else None,) + (None,) * (x.ndim - 1)
        return self.par.constrain(x, *dims).to_local()

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.tp_group) if self.tp > 1 else x

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.tp_group) if self.tp > 1 else x

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.tp == 1:
            return x
        return _GatherFrom.apply(x, self.tp_group, dim, self.tp, self.tp_rank)

    def gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim`` concatenated (TP
        axis); the gradient reduce-scattered back, so each rank may use
        the whole in its own way."""
        if self.tp == 1:
            return x
        return _GatherScatter.apply(x, self.tp_group, dim % x.ndim)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the TP axis, all-reduced again in the
        backward (each rank's use of the sum differs)."""
        return _SumBoth.apply(x, self.tp_group) if self.tp > 1 else x

    def rows_to_cols(self, x: torch.Tensor) -> torch.Tensor:
        """(B, TP * r, F), this rank's block of r rows of every rank's ->
        (B, TP * r, F / TP), every row's block of columns of this rank's
        (one all_to_all over the TP axis; differentiable)."""
        if self.tp == 1:
            return x
        return _RowsToCols.apply(x, self.tp_group, self.tp)

    def block(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's block of a full ``t`` along ``dim`` over the TP
        axis (``dim`` None: ``t``)."""
        if dim is None or self.tp == 1:
            return t
        return t.chunk(self.tp, dim)[self.tp_rank]

    def tp_dim(self, leaf) -> Optional[int]:
        """The dim a stored leaf (a DTensor) shards over the TP axis, or
        None."""
        from torch.distributed.tensor import DTensor, Shard

        if self.tp == 1 or not isinstance(leaf, DTensor):
            return None
        pl = leaf.placements[self.names.index(self.par.tp_axis)]
        return pl.dim if isinstance(pl, Shard) else None

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the TP axis (no gradient)."""
        return all_reduce(x, self.tp_group, "max") if self.tp > 1 else x

    def reduce_dp(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the dp axes of a value every rank computed from
        its rows; identity backward."""
        if not self.dp:
            return x
        for a in self.par.dp_axes:
            if self.sizes[a] > 1:
                x = reduce_from(x, self.par.group(a))
        return x

    def to_global(self, local: torch.Tensor, vocab_dim: Optional[int] = None):
        """The logical array of a result: a DTensor, rows over the dp axes
        where the batch split, ``vocab_dim`` over the TP axis where the
        vocabulary did."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        place = []
        for name in self.names:
            if name == self.par.tp_axis and vocab_dim is not None and self.tp > 1:
                place.append(Shard(vocab_dim))
            elif self.dp and name in self.par.dp_axes:
                place.append(Shard(0))
            else:
                place.append(Replicate())
        return DTensor.from_local(local, self.mesh, place, run_check=False)

    # -- caches ---------------------------------------------------------------

    def cache_local(self, cache: Optional[dict]) -> Tuple[Optional[dict], dict]:
        """A layer's cache as this rank's blocks: views of the local shards,
        in the layout :func:`~.sharding.cache_pspecs` gave them (a layer
        reads its cache there, :meth:`tp_dim` says how it is split; no
        cache is gathered). Returns (local dict, the stored leaves for
        :meth:`cache_store`)."""
        if cache is None:
            return None, {}
        stored = {n: as_dtensor(t, self.mesh) for n, t in cache.items()}
        return {n: t.to_local() for n, t in stored.items()}, stored

    def expect_split(self, cache: Optional[dict], dims: Dict[str, Optional[int]]) -> None:
        """Raises unless each named cache leaf is split over the TP axis
        on the dim given (None: whole), as ``init_cache(..., par=par)``
        places it."""
        for name, want in dims.items():
            if cache is not None and self.tp_dim(cache[name]) != want:
                raise ValueError(f"cache leaf {name!r} is split on {self.tp_dim(cache[name])} "
                                 f"over the TP axis, not {want}: make the cache with "
                                 f"init_cache(..., par=par)")

    def cache_store(self, cache: Optional[dict], new: Optional[dict], stored: dict):
        """The cache after a layer: its local tensors back as DTensors in
        the stored layout."""
        from torch.distributed.tensor import DTensor

        if cache is None:
            return new
        return {n: DTensor.from_local(t, self.mesh, stored[n].placements, run_check=False)
                for n, t in new.items()}


def sharded_sq_norm(t) -> torch.Tensor:
    """This rank's part of ``sum(t ** 2)`` in float32 for a leaf that may
    be a DTensor: its local sum over the ranks that hold the same block
    (so the sum over every rank counts each element once)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return torch.sum(torch.square(t.float()))
    s = torch.sum(torch.square(t.to_local().float()))
    sizes = list(axis_sizes(t.device_mesh).values())
    rep = math.prod(n for pl, n in zip(t.placements, sizes) if isinstance(pl, Replicate))
    return s / rep if rep > 1 else s


def mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``mesh``."""
    for name, n in axis_sizes(mesh).items():
        if n > 1:
            x = all_reduce(x, mesh.get_group(name))
    return x
