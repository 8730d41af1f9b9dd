"""The collectives the distributed paths use, over one process group.

Each is the counterpart of one ``jax.lax`` collective of the reference's
``shard_map`` bodies: :func:`all_gather_cat` of ``all_gather(...,
tiled=True)``, :func:`all_gather_stack` of ``all_gather(...,
tiled=False)``, :func:`all_to_all` of ``all_to_all(split_axis=d,
concat_axis=d)``, :func:`exchange` of a ``ppermute`` between two
partners and :func:`ring_shift` of the ``(i, i + 1 mod S)`` ``ppermute``.
Peers are ranks within ``group``. The wire carries bytes: a dtype that
NCCL or gloo does not take (int16, uint16, uint32) travels as its bytes.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

#: dtypes neither NCCL nor gloo moves as such: sent as their bytes
_BYTE_WIRE = (torch.int16, torch.uint16, torch.uint32)


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype in _BYTE_WIRE and t.ndim else t


def _from_wire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


def all_gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order."""
    w = _to_wire(t)
    outs = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, w, group=group)
    return [_from_wire(o, t.dtype) for o in outs]


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    return torch.cat(all_gather_list(t, group), dim=dim)


def all_gather_stack(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new axis ``dim`` in rank order."""
    return torch.stack(all_gather_list(t, group), dim=dim)


def all_to_all(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Slice ``j`` of ``x`` along ``dim`` (of size P, the group's size)
    goes to rank ``j``; the slices received stack along ``dim`` in source
    rank order."""
    xt = _to_wire(x.movedim(dim, 0))
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    return _from_wire(out, x.dtype).movedim(0, dim)


def _p2p(sends: Sequence[torch.Tensor], to: int, frm: int, group) -> List[torch.Tensor]:
    """Send each of ``sends`` to rank ``to`` and receive as many tensors of
    the same shapes from rank ``frm``, in one batch."""
    wires = [_to_wire(t) for t in sends]
    recvs = [torch.empty_like(w) for w in wires]
    ops = []
    for w, r in zip(wires, recvs):
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, to), group))
        ops.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(group, frm), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_from_wire(r, t.dtype) for r, t in zip(recvs, sends)]


def exchange(sends: Sequence[torch.Tensor], peer: int, group) -> List[torch.Tensor]:
    """Swap tensors with ``peer``: what it sent, in the same shapes."""
    if peer == dist.get_rank(group):
        return list(sends)
    return _p2p(sends, peer, peer, group)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` to rank ``r + 1``, the tensor of rank ``r - 1`` back (mod S)."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return t
    return _p2p([t], (me + 1) % size, (me - 1) % size, group)[0]
