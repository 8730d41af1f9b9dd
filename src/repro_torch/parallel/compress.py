"""Error-feedback int8 gradient compression for the cross-replica
reduction (counterpart of ``repro.parallel.compress``).

Per-block int8 quantization with an error-feedback residual, so that
the compression noise re-enters the next step. Usage (manual DP):
``g_hat, err = compressed_psum(g, group, err)`` on every rank.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

BLOCK = 256


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (any shape) -> (int8 codes (n_blocks, BLOCK), float32 scales a
    block)."""
    flat = g.reshape(-1).float()
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, _pad_len(n) - n))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0]


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compressed_psum(g: torch.Tensor, axis_name, err: torch.Tensor):
    """Error-feedback compressed all-reduce over the process group
    ``axis_name`` (the reference's axis): three all-reduces, the int32
    codes, the scales and the rank count. Returns (the reduced gradient,
    the new error residual)."""
    g_in = g + err
    q, s = compress(g_in)
    # sum the int32 codes and the scales: unbiased when the scales are
    # close; the error feedback absorbs the rest of the quantization noise
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, group=axis_name)
    s_sum = s.clone()
    dist.all_reduce(s_sum, group=axis_name)
    n_dev = torch.ones((1,), dtype=torch.float32, device=g.device)
    dist.all_reduce(n_dev, group=axis_name)
    n_dev = n_dev[0]
    g_hat = decompress(q_sum.float() / n_dev, s_sum / n_dev, g.shape)
    # the local view of what this rank transmitted
    new_err = g_in - decompress(q.float(), s, g.shape)
    return g_hat * n_dev, new_err


def compress_tree(grads, errs, axis_name):
    """:func:`compressed_psum` over a gradient tree."""
    flat_g, spec = pytree.tree_flatten(grads)
    flat_e = pytree.tree_leaves(errs)
    pairs = [compressed_psum(g, axis_name, e) for g, e in zip(flat_g, flat_e)]
    return (pytree.tree_unflatten([p[0] for p in pairs], spec),
            pytree.tree_unflatten([p[1] for p in pairs], spec))
