"""Model building blocks as plain functions over a parameter dict.

Counterpart of ``repro.models.layers``. Parameters keep the JAX package's
layouts (a dense weight is ``(in_dim, *out_dims)``), so a tree carried over
from the reference by :func:`repro_torch.models.convert.params_from_jax`
computes the same function. Every large product is ``torch.matmul``.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, in_dim: int,
               out_dims: Union[int, Sequence[int]], dtype: torch.dtype,
               device: torch.device, bias: bool = False, scale=None) -> dict:
    """W: (in_dim, *out_dims) ~ normal x 1/sqrt(in_dim), drawn in float32
    and stored in ``dtype`` (as ``repro.models.layers.dense_init`` draws it)."""
    out_dims = tuple(out_dims) if isinstance(out_dims, (tuple, list)) else (out_dims,)
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, *out_dims), generator=generator, device=device,
                    dtype=torch.float32)
    p = {"w": w.mul_(std).to(dtype)}
    if bias:
        p["b"] = torch.zeros(out_dims, dtype=dtype, device=device)
    return p


def dense_spec(spec: Sequence, bias: bool = False) -> dict:
    """The logical axes of :func:`dense_init`'s leaves (``layers.py:24``):
    ``spec`` names the weight's dims, the bias takes the output dims'."""
    out = {"w": tuple(spec)}
    if bias:
        out["b"] = tuple(spec[1:])
    return out


#: the logical axes of a norm over the model width (``rmsnorm_init``)
NORM_SPEC = {"scale": ("embed",)}
#: the logical axes of a norm over a head (``head_rmsnorm_init``)
HEAD_NORM_SPEC = {"scale": ("head_dim",)}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of x and the first of w; adds a bias."""
    w = p["w"]
    y = torch.matmul(x, w.reshape(w.shape[0], -1).to(x.dtype))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 (``layers.py:51``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embed(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["emb"].to(dtype)[tokens.long()]


def rope_freqs(head_dim: int, fraction: float, theta: float
               ) -> Tuple[int, np.ndarray]:
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return rot, inv


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, fraction: float, theta: float, device: torch.device):
    """The inverse frequencies on ``device``, copied there once: a copy
    from host memory per call would make the host wait for the card."""
    rot, inv = rope_freqs(head_dim, fraction, theta)
    return rot, torch.from_numpy(np.ascontiguousarray(inv)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Pairs of
    interleaved lanes rotate, as in ``layers.py:90``."""
    d = x.shape[-1]
    rot, inv_t = _inv_freq(d, fraction, theta, x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None].float() * inv_t  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def mlp_init(generator, d_model: int, d_ff: int, act: str, dtype, device) -> dict:
    p = {"wi": dense_init(generator, d_model, d_ff, dtype, device)}
    if act == "swiglu":
        p["wg"] = dense_init(generator, d_model, d_ff, dtype, device)
    p["wo"] = dense_init(generator, d_ff, d_model, dtype, device)
    return p


def mlp_specs(act: str) -> dict:
    p = {"wi": dense_spec(("embed", "mlp"))}
    if act == "swiglu":
        p["wg"] = dense_spec(("embed", "mlp"))
    p["wo"] = dense_spec(("mlp", "embed"))
    return p


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU puts the SiLU on ``wi``: ``silu(x @ wi) * (x @ wg)``
    (``layers.py:124``)."""
    h = dense(p["wi"], x)
    if act == "swiglu":
        h = F.silu(h) * dense(p["wg"], x)
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return dense(p["wo"], h)
