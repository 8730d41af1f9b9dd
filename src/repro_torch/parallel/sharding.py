"""Logical-axis sharding rules: FSDP over 'data', TP/EP over 'model'
(counterpart of ``repro.parallel.sharding``).

Every parameter carries a tuple of logical axis names.
:func:`build_param_pspecs` maps logical axes onto mesh axes with
divisibility and no-duplicate checks, falling back to replication, as the
reference does. A spec is a :class:`PSpec`: a tuple with one entry a
tensor dim, each a mesh-axis name, a tuple of them, or None (the
counterpart of ``PartitionSpec``); :func:`to_named` turns one into the
DTensor placements of a ``DeviceMesh`` (``Shard(d)`` / ``Replicate()``
a mesh dim).

The rules are pure functions over shapes and logical-axis trees; the
ones that read a mesh take a ``DeviceMesh`` or any object with
``axis_names`` and a ``shape`` mapping, the two attributes the reference
reads. The model's logical-axis tree is
:func:`repro_torch.models.param_specs`; :func:`shard_params` places a
parameter tree by it as DTensors, :func:`shard_tree` any tree by its
specs (:func:`cache_pspecs` for the decode caches), and
:func:`full_params` gives the full logical arrays back.
:meth:`Parallelism.constrain` is the reference's
``with_sharding_constraint``: a DTensor ``redistribute``. How the model
computes on these layouts is :mod:`.spmd`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


class PSpec(tuple):
    """A partition spec: one entry a tensor dim (a mesh-axis name, a tuple
    of them, or None). A tuple, so ``PSpec("model", None) == ("model",
    None)``; a tuple of one name is that name, as ``PartitionSpec`` keeps
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def init_mesh(device_type: str, shape: Sequence[int],
              names: Sequence[str] = ("data", "model")):
    """A ``DeviceMesh`` over the default process group. ``"cuda"`` pins
    this rank to ``cuda:<local rank>`` (``LOCAL_RANK``, else the global
    rank modulo the cards) and raises without a card; ``"cpu"`` is the
    tests' gloo mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda":
        resolve_device("cuda")
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first (nccl for cuda, gloo for cpu)")
    if device_type == "cuda":
        local = dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", local)))
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


@dataclasses.dataclass(frozen=True)
class Parallelism:
    mesh: object  # a DeviceMesh (a stand-in for the pure spec functions)
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    ep_enabled: bool = True
    fsdp_axis: Optional[str] = "data"
    remat: str = "dots"

    @property
    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return int(math.prod(sizes[a] for a in self.dp_axes))

    @property
    def tp_size(self) -> int:
        return axis_sizes(self.mesh)[self.tp_axis]

    def dp_for(self, size: int):
        """dp axes if the batch size divides across them, else None."""
        return self.dp_axes if size % self.dp_size == 0 and size >= self.dp_size else None

    def tp_for(self, size: int):
        return self.tp_axis if size % self.tp_size == 0 and size >= self.tp_size else None

    def group(self, axis: str):
        """The process group of one mesh axis."""
        return self.mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along one mesh axis."""
        return self.mesh.get_local_rank(axis)

    def constrain(self, x, *dims):
        """The reference's ``with_sharding_constraint`` anchor: ``x`` (a
        DTensor, or a plain tensor taken as replicated over the mesh)
        redistributed to the placements of ``PSpec(*dims)``; ``dims`` are
        mesh-axis names, tuples of them, or None, one a tensor dim. An
        axis the mesh lacks raises."""
        from .spmd import as_dtensor

        names = set(axis_sizes(self.mesh))
        for e in dims:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None and a not in names:
                    raise ValueError(f"constrain: the mesh {sorted(names)} lacks axis {a!r}")
        if len(dims) > x.ndim:
            raise ValueError(f"constrain: {len(dims)} dims for a tensor of {x.ndim}")
        t = as_dtensor(x, self.mesh)
        return t.redistribute(placements=to_named(PSpec(*dims), self.mesh))

    # -- the data-parallel split of full arrays (``P(dp, ...)`` on dim 0) --

    def dp_index(self) -> int:
        """This rank's block of a dim sharded over ``dp_axes`` (the first
        axis major, as a ``PartitionSpec`` entry of several axes)."""
        sizes, idx = axis_sizes(self.mesh), 0
        for a in self.dp_axes:
            idx = idx * sizes[a] + self.coordinate(a)
        return idx

    def dp_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of dim 0 of a full array sharded over dp."""
        n = self.dp_size
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over dp size {n}")
        blk = x.shape[0] // n
        return x[self.dp_index() * blk:(self.dp_index() + 1) * blk]

    def dp_gather(self, y: torch.Tensor) -> torch.Tensor:
        """The full array back from every rank's :meth:`dp_slice` block."""
        from .comm import all_gather_cat

        sizes = axis_sizes(self.mesh)
        for a in reversed(self.dp_axes):  # the innermost axis first
            if sizes[a] > 1:
                y = all_gather_cat(y, self.group(a), 0)
        return y


def dist_sort_axis(par: Optional[Parallelism], lengths) -> Optional[str]:
    """Mesh axis of the distributed sample-sort (:mod:`.dist_sort`), or
    None when the lists cannot shard evenly over the TP axis: every list
    must split into equal slices a rank."""
    if par is None or getattr(par, "tp_size", 1) <= 1:
        return None
    if any(ln < par.tp_size or ln % par.tp_size for ln in lengths):
        return None
    return par.tp_axis


def vocab_topk_axis(par: Optional[Parallelism], vocab_size: int) -> Optional[str]:
    """Mesh axis of the device-tree top-k (:mod:`repro_torch.streaming.tree`),
    or None when the vocab cannot shard over TP."""
    if par is None or par.tp_size <= 1:
        return None
    if vocab_size % par.tp_size != 0:
        return None
    return par.tp_axis


def make_parallelism(mesh, *, ep: bool = True, remat: str = "dots") -> Parallelism:
    axes = tuple(axis_sizes(mesh))
    dp = tuple(a for a in axes if a in ("pod", "data"))
    return Parallelism(mesh=mesh, dp_axes=dp, tp_axis="model", ep_enabled=ep,
                       fsdp_axis="data", remat=remat)


# logical axis -> candidate mesh axis (first feasible wins; () = replicate)
LOGICAL_RULES = {
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "embed": ("data",),  # FSDP shard
    "kv_lora": ("data",),
    "frontend": (),
    "head_dim": (),
    None: (),
}


def _pspec_for(shape: Tuple[int, ...], logical: Sequence, mesh) -> PSpec:
    """Map one array. If ndim == len(logical) + 1 the array is
    layer-stacked: the leading axis stays unsharded."""
    sizes = axis_sizes(mesh)
    names = list(logical)
    offset = len(shape) - len(names)
    if offset not in (0, 1):
        raise ValueError(f"shape {tuple(shape)} does not fit logical axes {tuple(logical)}")
    out = [None] * len(shape)
    used = set()
    for i, name in enumerate(names):
        dim = shape[offset + i]
        for cand in LOGICAL_RULES.get(name, ()):  # the first feasible rule
            if cand in used or cand not in sizes:
                continue
            if dim % sizes[cand] == 0 and dim >= sizes[cand]:
                out[offset + i] = cand
                used.add(cand)
                break
    return PSpec(*out)


def build_param_pspecs(param_shapes, specs, mesh):
    """``param_shapes``: a tree (dicts, lists, tuples) whose leaves have a
    ``shape``; ``specs``: the matching tree of logical-axis tuples.
    Returns the tree of :class:`PSpec`."""

    def walk(shapes, spec):
        if isinstance(shapes, dict):
            return {k: walk(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in shapes.items()}
        if isinstance(shapes, (list, tuple)):
            return type(shapes)(
                walk(v, spec[i] if isinstance(spec, (list, tuple)) else spec)
                for i, v in enumerate(shapes))
        logical = spec if isinstance(spec, tuple) else ()
        return _pspec_for(tuple(shapes.shape), logical, mesh)

    return walk(param_shapes, specs)


def to_named(tree, mesh):
    """Each :class:`PSpec` of ``tree`` as the DTensor placements of
    ``mesh``: one a mesh dim, ``Shard(d)`` where tensor dim ``d`` names
    that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils import _pytree as pytree

    names = tuple(axis_sizes(mesh))

    def placements(spec: PSpec):
        out = []
        for name in names:
            dims = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    return pytree.tree_map(placements, tree, is_leaf=lambda x: isinstance(x, PSpec))


def batch_pspecs(cfg, par: Parallelism):
    dp = par.dp_axes
    out = {"tokens": PSpec(dp, None), "targets": PSpec(dp, None)}
    if cfg.family == "vlm":
        out["patches"] = PSpec(dp, None, None)
    if cfg.family == "audio":
        out = {"frames": PSpec(dp, None, None), "targets": PSpec(dp, None)}
    return out


def cache_pspecs(cfg, par: Parallelism, cache_shapes):
    """Shard caches by name: the batch over dp; the attention contraction
    dim (kv heads / head_dim / latent / ssm heads) over TP; never the
    sequence dim, which decode writes. ``cache_shapes``: the port's cache
    layout (:func:`repro_torch.models.init_cache`: ``head`` / ``body`` /
    ``shared`` lists of per-layer dicts, no layer axis), leaves with a
    ``shape`` (a ``device="meta"`` cache costs nothing); the names'
    rules are the reference's (``sharding.py:159``)."""
    dp, tp = par.dp_axes, par.tp_axis
    tpn, dpn = par.tp_size, par.dp_size

    def div(n):
        return n % tpn == 0 and n >= tpn

    def leaf_spec(name, shp):
        # shp excludes any layer-stacking prefix; shp[0] = batch
        base = [dp if shp[0] % dpn == 0 else None]
        rest = list(shp[1:])
        out = [None] * len(rest)
        if name == "k":  # (H, D, S)
            out[0 if div(rest[0]) else 1] = tp if (div(rest[0]) or div(rest[1])) else None
        elif name == "v":  # (H, S, Dv)
            out[0 if div(rest[0]) else 2] = tp if (div(rest[0]) or div(rest[2])) else None
        elif name in ("ckv", "kpe"):  # (L, S) / (R, S)
            out[0] = tp if div(rest[0]) else None
        elif name == "conv":  # (K-1, conv_dim)
            out[1] = tp if div(rest[1]) else None
        elif name == "ssm":  # (H, P, N)
            out[0 if div(rest[0]) else 2] = tp if (div(rest[0]) or div(rest[2])) else None
        return base + out

    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk_leaf(k, v, stacked) if not isinstance(v, (dict, list))
                    else walk(v, stacked) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        raise TypeError(type(tree))

    def walk_leaf(name, x, stacked):
        shp = list(x.shape)
        if stacked:
            shp = shp[1:]
        if len(shp) == 0:
            return PSpec(None) if stacked else PSpec()
        spec = leaf_spec(name, shp)
        if stacked:
            spec = [None] + spec
        return PSpec(*spec)

    return {key: walk(sub, stacked=False) for key, sub in cache_shapes.items()}


# ---------------------------------------------------------------------------
# placing trees as DTensors
# ---------------------------------------------------------------------------


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a full array under ``placements`` (DTensor's
    own split: ``torch.chunk`` along each sharded dim, mesh dims in
    order)."""
    from torch.distributed.tensor import Shard

    t = full
    for i, (name, pl) in enumerate(zip(axis_sizes(mesh), placements)):
        if isinstance(pl, Shard) and mesh.shape[i] > 1:
            t = t.chunk(mesh.shape[i], dim=pl.dim)[mesh.get_local_rank(name)]
    return t


def place(t: torch.Tensor, mesh, placements):
    """A full tensor (the same on every rank) as a DTensor: each rank
    keeps its own block, copied out, with no communication."""
    from torch.distributed.tensor import DTensor

    loc = local_chunk(t, mesh, placements)
    if loc is t:
        loc = t.detach()
    else:
        loc = loc.detach().clone()
    return DTensor.from_local(loc, mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride() if t.is_contiguous() else None)


def shard_tree(tree, pspecs, mesh):
    """Place every tensor of ``tree`` by the matching :class:`PSpec` of
    ``pspecs``, one leaf at a time: the full leaf is dropped from the
    tree as its block is placed, so a full-width tree never has a second
    copy."""
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = shard_tree(tree[k], pspecs[k], mesh)
        return tree
    if isinstance(tree, list):
        for i in range(len(tree)):
            tree[i] = shard_tree(tree[i], pspecs[i], mesh)
        return tree
    if isinstance(tree, tuple):
        return tuple(shard_tree(v, s, mesh) for v, s in zip(tree, pspecs))
    return place(tree, mesh, to_named(pspecs, mesh))


def shard_params(params, par: Parallelism, specs):
    """``params`` (full tensors, the same on every rank) placed as
    DTensors by their logical-axis tree ``specs``
    (:func:`repro_torch.models.param_specs`) under the rules of
    :func:`build_param_pspecs`. The tree is updated in place, one leaf at
    a time, and returned."""
    return shard_tree(params, build_param_pspecs(params, specs, par.mesh), par.mesh)


def full_params(tree):
    """The full logical arrays of a tree of DTensors, on every rank; a
    plain tensor stays as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_params(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
