"""Device-tree sharded top-k: a log-depth LOMS merge reduction over a mesh
axis (counterpart of ``repro.streaming.tree``).

Decode at serving scale needs the top-k of a vocab sharded over the
tensor-parallel axis. Each rank takes the blockwise LOMS top-k of its
vocab slice (global indices from the slice's offset), then the per-rank
(value, index) lists reduce across the axis by truncated UP-k/DN-k
merges:

* a power-of-two axis: a butterfly, partners at XOR distance 1, 2, 4, ...
  (``batch_isend_irecv``), k values a link a step;
* any other size: one all-gather of the k-candidate lists, then the same
  log-depth merge tree on every rank.

The butterfly's two partners both merge the lower rank's list first.
The reference merges each rank's own list first; its values agree on
every rank, but under ties ranks 1.. keep other tied indices than rank 0,
and its replicated output is rank 0's buffer. Lower-first gives every
rank exactly that array (ROADMAP Queue 3, faults of the reference that
the port does not keep).

Everything here is plain torch on the port's comparison-cloud primitives
(``kernels.common``: the N-sorter and the stable 2-run merge), the
network of ``local_topk_desc``, on whatever device the rows lie.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.common import merge2_sorted, sentinel_min, sort_nsorter
from repro_torch.parallel import comm


def _resolve_mxu(use_mxu: Optional[bool], dtype: torch.dtype) -> bool:
    """``use_mxu=None`` -> by dtype: integer keys take the exact permute."""
    if use_mxu is None:
        return dtype.is_floating_point
    return bool(use_mxu)


def _merge_desc(av, ai, bv, bi, keep: int, use_mxu: bool):
    """Merge two descending (value, index) lists, keep the top ``keep``."""
    mv, mi = merge2_sorted(av.flip(-1), bv.flip(-1), payload=(ai.flip(-1), bi.flip(-1)),
                           use_mxu=use_mxu)
    return mv.flip(-1)[..., :keep], mi.flip(-1)[..., :keep]


def _pad_last2(t: torch.Tensor, fill) -> torch.Tensor:
    """One more list (row of the second-to-last axis) filled with ``fill``."""
    return torch.cat([t, t.new_full(t.shape[:-2] + (1, t.shape[-1]), fill)], dim=-2)


def _tree_reduce_desc(vs: torch.Tensor, is_: torch.Tensor, k: int, use_mxu: bool):
    """Reduce a (..., S, k) stack of descending lists to (..., k)."""
    neg = sentinel_min(vs.dtype)
    while vs.shape[-2] > 1:
        if vs.shape[-2] % 2:
            vs = _pad_last2(vs, neg)
            is_ = _pad_last2(is_, -1)  # never alias slot 0
        vs, is_ = _merge_desc(vs[..., 0::2, :], is_[..., 0::2, :],
                              vs[..., 1::2, :], is_[..., 1::2, :], k, use_mxu)
    return vs[..., 0, :], is_[..., 0, :]


def local_topk_desc(x: torch.Tensor, k: int, *, block: int = 128, offset: int = 0,
                    use_mxu: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise descending top-k of (B, E) with global indices ``+offset``:
    the N-sorter a block, then a log-depth tree of truncated LOMS merges
    (the algorithm of the router kernel, as plain torch)."""
    use_mxu = _resolve_mxu(use_mxu, x.dtype)
    bsz, e = x.shape
    neg = sentinel_min(x.dtype)
    nblk = -(-e // block)
    ep = nblk * block
    if ep != e:
        x = torch.cat([x, x.new_full((bsz, ep - e), neg)], dim=1)
    lane = torch.arange(ep, dtype=torch.int32, device=x.device)
    idx = torch.where(lane < e, lane + int(offset), -1).expand(bsz, ep)
    vs, is_ = sort_nsorter(x.reshape(bsz, nblk, block), idx.reshape(bsz, nblk, block),
                           use_mxu=use_mxu)
    kk = min(k, block)
    vs, is_ = vs.flip(-1)[..., :kk], is_.flip(-1)[..., :kk]
    vs, is_ = _tree_reduce_desc(vs, is_, k, use_mxu)
    if vs.shape[-1] < k:  # fewer candidates than k on this rank
        vs = torch.cat([vs, vs.new_full((bsz, k - vs.shape[-1]), neg)], dim=-1)
        is_ = torch.cat([is_, is_.new_full((bsz, k - is_.shape[-1]), -1)], dim=-1)
    return vs, is_


def _butterfly_topk(vals, idxs, k: int, group, use_mxu: bool):
    """XOR-partner butterfly: after log2(size) exchange + merge steps every
    rank holds the same global top-k, the lower rank's list merged first."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    step = 1
    while step < size:
        peer = me ^ step
        ov, oi = comm.exchange([vals, idxs], peer, group)
        if me < peer:
            vals, idxs = _merge_desc(vals, idxs, ov, oi, k, use_mxu)
        else:
            vals, idxs = _merge_desc(ov, oi, vals, idxs, k, use_mxu)
        step *= 2
    return vals, idxs


def tree_topk_local(xs: torch.Tensor, k: int, *, group, block: int = 128,
                    use_mxu: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's vocab slice (B, E/S) in, the global descending top-k
    (B, k) out, the same on every rank of ``group`` (the reference's
    ``shard_map`` body)."""
    use_mxu = _resolve_mxu(use_mxu, xs.dtype)
    size, me = dist.get_world_size(group), dist.get_rank(group)
    shard = xs.shape[-1]
    vs, is_ = local_topk_desc(xs, k, block=min(block, shard), offset=me * shard,
                              use_mxu=use_mxu)
    if size & (size - 1) == 0:
        return _butterfly_topk(vs, is_, k, group, use_mxu)
    allv = comm.all_gather_stack(vs, group, dim=1)  # (B, S, k)
    alli = comm.all_gather_stack(is_, group, dim=1)
    return _tree_reduce_desc(allv, alli, k, use_mxu)


def tree_topk(x: torch.Tensor, k: int, *, mesh=None, axis: Optional[str] = None,
              block: int = 128, use_mxu: Optional[bool] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k (values, int32 indices) over the last axis of (B, E).

    With ``mesh`` / ``axis`` given and the axis larger than 1, every rank
    passes the full rows, scores its slice and gets the global top-k;
    otherwise this is the single-device log-tree (the same network, local
    edges)."""
    if x.ndim != 2:
        raise ValueError(f"tree_topk takes (B, E), got {tuple(x.shape)}")
    use_mxu = _resolve_mxu(use_mxu, x.dtype)
    group = None if mesh is None or axis is None else mesh.get_group(axis)
    if group is None or dist.get_world_size(group) == 1:
        return local_topk_desc(x, k, block=block, use_mxu=use_mxu)
    size, me = dist.get_world_size(group), dist.get_rank(group)
    e = x.shape[-1]
    if e % size:
        raise ValueError(f"vocab {e} does not split over {size} ranks")
    shard = e // size
    return tree_topk_local(x[:, me * shard:(me + 1) * shard].contiguous(), k, group=group,
                           block=block, use_mxu=use_mxu)


def tree_topk_for(par, x: torch.Tensor, k: int, **kw):
    """Top-k routed by a :class:`repro_torch.parallel.Parallelism`: the
    device tree over the TP axis when the vocab divides it, else local."""
    from repro_torch.parallel.sharding import vocab_topk_axis

    axis = vocab_topk_axis(par, x.shape[-1]) if par is not None else None
    if axis is None:
        return tree_topk(x, k, **kw)
    return tree_topk(x, k, mesh=par.mesh, axis=axis, **kw)
