"""GQA attention with qk-norm and RoPE, and its KV cache.

Counterpart of ``repro.models.attention`` (dense GQA; MLA waits). All of it
is plain torch ops; the JAX package has no Pallas kernel here.

* Prefill runs the forward half of the reference's chunked online softmax
  (``_flash_fwd_impl``, ``attention.py:49``), so a long prompt never
  materialises an S x S score matrix. Scores and sums are float32.
* Decode attends one query against the cache with float32 logits
  (``decode_attention``, ``attention.py:185``).
* The cache layout is the reference's: k ``(B, Hkv, D, S)``, v
  ``(B, Hkv, S, D)``, ``pos`` a scalar or one write position per row.
  The port writes the cache in place (the reference returns an updated
  copy); the returned dict holds the same tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import apply_rope, dense, dense_init, rmsnorm

_NEG = -1e30  # the reference's mask value


def _fit_chunk(size: int, want: int) -> int:
    """Largest divisor of ``size`` that is <= ``want``."""
    c = min(want, size)
    while size % c:
        c -= 1
    return c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention, forward only. q (B, Sq, Hkv, G, D), k (B, Sk,
    Hkv, D), v (B, Sk, Hkv, Dv) -> (B, Sq, Hkv, G, Dv).

    A causal key chunk that lies wholly after a query chunk is skipped:
    its probabilities are exactly zero and its correction factor exactly
    one, so the result is the reference's."""
    b, sq, hkv, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else float(1.0 / np.sqrt(d))
    cq, ck = _fit_chunk(sq, chunk), _fit_chunk(sk, chunk)
    f32 = torch.float32
    outs = []
    for iq in range(sq // cq):
        qi = q[:, iq * cq:(iq + 1) * cq].to(f32)
        qpos = q_offset + iq * cq + torch.arange(cq, device=q.device)
        m = torch.full((b, cq, hkv, g), _NEG, dtype=f32, device=q.device)
        l = torch.zeros((b, cq, hkv, g), dtype=f32, device=q.device)
        acc = torch.zeros((b, cq, hkv, g, dv), dtype=f32, device=q.device)
        for ik in range(sk // ck):
            if causal and ik * ck > q_offset + (iq + 1) * cq - 1:
                break
            ki = k[:, ik * ck:(ik + 1) * ck].to(f32)
            vi = v[:, ik * ck:(ik + 1) * ck]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
            if causal:
                kpos = ik * ck + torch.arange(ck, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vi.dtype).to(f32), vi.to(f32))
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hkv, G, D) single query; k_cache (B, Hkv, D, S); v_cache (B,
    Hkv, S, Dv); ``valid_len`` () or (B,) valid cache slots. The logits
    are the product in the working type, widened to float32."""
    d = q.shape[-1]
    s = k_cache.shape[-1]
    scale = scale if scale is not None else float(1.0 / np.sqrt(d))
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    logits = torch.matmul(q, k_cache).float() * scale  # (B, Hkv, G, S)
    valid = valid_len.reshape(-1, 1).expand(q.shape[0], 1)
    mask = torch.arange(s, device=q.device)[None, :] < valid  # (B, S)
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(v_cache.dtype), v_cache).to(q.dtype)


def attn_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, (h, hd), dtype, device, bias=cfg.qkv_bias),
        "wk": dense_init(generator, d, (hkv, hd), dtype, device, bias=cfg.qkv_bias),
        "wv": dense_init(generator, d, (hkv, hd), dtype, device, bias=cfg.qkv_bias),
        "wo": dense_init(generator, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
        p["kn"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
    return p


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[dict] = None, mode: str = "train"):
    """x (B, S, D) -> (out (B, S, D), cache). ``mode``: train | prefill |
    decode, as in ``attn_apply`` (``attention.py:266``)."""
    b, sq, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    q = dense(p["wq"], x)  # (b, s, h, hd)
    k = dense(p["wk"], x)
    v = dense(p["wv"], x)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)

    new_cache = cache
    if mode == "decode":
        assert sq == 1 and cache is not None
        idx = cache["pos"]  # int32 write slot: scalar, or (B,) per row
        kc, vc = cache["k"], cache["v"]
        nc = kc.shape[0]  # rows past the cache's are pads (decode_step)
        k_t = k[:nc, 0].to(kc.dtype)  # (nc, hkv, d)
        v_t = v[:nc, 0].to(vc.dtype)
        if idx.ndim == 0:
            kc[:, :, :, idx.long()] = k_t
            vc[:, :, idx.long(), :] = v_t
        else:
            rows = torch.arange(nc, device=x.device)
            kc[rows, :, :, idx.long()] = k_t
            vc[rows, :, idx.long(), :] = v_t
        new_cache = {"k": kc, "v": vc, "pos": idx + 1}
        qh = q[:nc, 0].reshape(nc, hkv, g, hd)
        out = decode_attention(qh, kc, vc, valid_len=idx + 1).reshape(nc, 1, h * hd)
        if nc < b:  # the pad rows' attention output is zero
            out = torch.cat([out, out.new_zeros((b - nc, 1, h * hd))])
    else:
        if mode == "prefill" and cache is not None:
            kc, vc = cache["k"], cache["v"]
            kc[:, :, :, :sq] = k.permute(0, 2, 3, 1).to(kc.dtype)
            vc[:, :, :sq, :] = v.permute(0, 2, 1, 3).to(vc.dtype)
            new_cache = {"k": kc, "v": vc,
                         "pos": torch.full((), sq, dtype=torch.int32, device=x.device)}
        qg = q.reshape(b, sq, hkv, g, hd)
        out = flash_attention(qg, k, v, causal=cfg.causal, chunk=cfg.attn_chunk)
        out = out.reshape(b, sq, h * hd)
    return dense(p["wo"], out), new_cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, hd, max_len), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
