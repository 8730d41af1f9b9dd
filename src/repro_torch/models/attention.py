"""GQA attention with qk-norm and RoPE, MLA, and their caches.

Counterpart of ``repro.models.attention``. All of it is plain torch ops;
the JAX package has no Pallas kernel here.

* Train and prefill run the reference's chunked online softmax
  (``_flash_fwd_impl``, ``attention.py:49``), so a long prompt never
  materialises an S x S score matrix, and its flash backward
  (``_flash_bwd``, ``attention.py:102``) recomputes each chunk's
  probabilities from the saved log-sum-exp. Scores and sums are float32.
* Decode attends one query against the cache with float32 logits
  (``decode_attention``, ``attention.py:185``).
* The cache layout is the reference's: k ``(B, Hkv, D, S)``, v
  ``(B, Hkv, S, D)``, ``pos`` a scalar or one write position per row.
  The port writes the cache in place (the reference returns an updated
  copy); the returned dict holds the same tensors.
* MLA (DeepSeek-V2's multi-head latent attention, ``attention.py:363``)
  caches the compressed latent ``ckv`` (B, kv_lora, S) and the RoPE key
  ``kpe`` (B, rope, S): 576 elements a token a layer at DeepSeek-V2-Lite's
  width, where GQA at 16 kv-heads of 128 would cache 4,096. Train and
  prefill expand the latent to per-head keys and values and run
  :func:`flash_attention` (16 heads, d 192, dv 128); decode attends in
  the absorbed form, the query folded through ``wuk`` into the latent.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import apply_rope, dense, dense_init, rmsnorm

_NEG = -1e30  # the reference's mask value


def _fit_chunk(size: int, want: int) -> int:
    """Largest divisor of ``size`` that is <= ``want``."""
    c = min(want, size)
    while size % c:
        c -= 1
    return c


def _flash_fwd(q, k, v, causal: bool, q_offset: int, chunk: int, scale: float):
    """The reference's ``_flash_fwd_impl`` (``attention.py:49``): the
    output and each query row's log-sum-exp (B, Sq, Hkv, G), float32.

    A causal key chunk that lies wholly after a query chunk is skipped:
    its probabilities are exactly zero and its correction factor exactly
    one, so the result is the reference's."""
    b, sq, hkv, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    cq, ck = _fit_chunk(sq, chunk), _fit_chunk(sk, chunk)
    f32 = torch.float32
    outs, lses = [], []
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
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, q_offset: int, chunk: int,
               scale: float):
    """The reference's ``_flash_bwd`` (``attention.py:102``): each chunk's
    probabilities recomputed from q, k and the log-sum-exp, so the
    backward holds O(S) state, not the S x S matrices. Float32
    throughout; the causal chunks the forward skipped add exact zeros
    there, so they are skipped here too."""
    b, sq, hkv, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    cq, ck = _fit_chunk(sq, chunk), _fit_chunk(sk, chunk)
    f32 = torch.float32
    dout = dout.to(f32)
    delta = (dout * out.to(f32)).sum(-1)  # (b, sq, hkv, g)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, sk, hkv, d), dtype=f32, device=q.device)
    dvs = torch.zeros((b, sk, hkv, dv), dtype=f32, device=q.device)
    for iq in range(sq // cq):
        rq = slice(iq * cq, (iq + 1) * cq)
        qi, doi, lsei, di = q[:, rq].to(f32), dout[:, rq], lse[:, rq], delta[:, rq]
        qpos = q_offset + iq * cq + torch.arange(cq, device=q.device)
        for ik in range(sk // ck):
            if causal and ik * ck > q_offset + (iq + 1) * cq - 1:
                break
            rk = slice(ik * ck, (ik + 1) * ck)
            ki, vi = k[:, rk].to(f32), v[:, rk].to(f32)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
            if causal:
                kpos = ik * ck + torch.arange(ck, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
            p = torch.exp(s - lsei[..., None])  # (b, cq, hkv, g, ck)
            dvs[:, rk] += torch.einsum("bqhgk,bqhgv->bkhv", p, doi)
            dp = torch.einsum("bqhgv,bkhv->bqhgk", doi, vi)
            ds = p * (dp - di[..., None]) * scale
            dq[:, rq] += torch.einsum("bqhgk,bkhd->bqhgd", ds, ki)
            dk[:, rk] += torch.einsum("bqhgk,bqhgd->bkhd", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dvs.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Chunked attention with the flash gradient (the reference's
    ``_flash`` custom VJP): forward keeps q, k, v, the output and the
    per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, chunk: int, scale: float):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, chunk, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _flash_bwd(q, k, v, out, lse, dout, *ctx.args) + (None,) * 4


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention. q (B, Sq, Hkv, G, D), k (B, Sk, Hkv, D), v (B,
    Sk, Hkv, Dv) -> (B, Sq, Hkv, G, Dv); differentiable with the flash
    backward (:func:`_flash_bwd`)."""
    scale = scale if scale is not None else float(1.0 / np.sqrt(q.shape[-1]))
    return _Flash.apply(q, k, v, bool(causal), int(q_offset), int(chunk), float(scale))


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


def pad_decode_rows(b: int, valid_len: torch.Tensor, *caches: torch.Tensor):
    """Decode attention's batch-invariance rule, for GQA and MLA: every
    product takes all ``b`` rows of the step (``decode_step`` pads them to
    a multiple of ``DECODE_TILE``, so the count is fixed), the caches'
    ``nc <= b`` rows padded with zero rows of valid length 0, which attend
    nothing and give zeros. A batched product over the nc real rows alone
    gave rows 0-2 other bits at 3 rows than at 4 on the H100 (qwen1.5-32b,
    one query a kv-head). The pad copies each cache once a step, one op a
    tensor (PERF.md gives its measured cost). Returns ``(valid (b,),
    *caches)``."""
    nc = caches[0].shape[0]
    valid = valid_len.reshape(-1).expand(nc)
    if nc == b:
        return (valid,) + caches
    return tuple(F.pad(t, (0, 0) * (t.ndim - 1) + (0, b - nc)) for t in (valid,) + caches)


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
        valid, kc, vc = pad_decode_rows(b, idx + 1, kc, vc)
        qh = q[:, 0].reshape(b, hkv, g, hd)
        out = decode_attention(qh, kc, vc, valid_len=valid).reshape(b, 1, h * hd)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    """``mla_init`` (``attention.py:363``): ``wq`` (d, h, nope + rope),
    ``wdkv`` (d, kv_lora + rope), ``kv_norm`` (float32 ones, as the
    reference keeps it), ``wuk`` (kv_lora, h, nope), ``wuv`` (kv_lora, h, v),
    ``wo`` (h v, d)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(generator, d, (h, qd), dtype, device),
        "wdkv": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype, device),
        "kv_norm": {"scale": torch.ones(m.kv_lora_rank, dtype=torch.float32, device=device)},
        "wuk": dense_init(generator, m.kv_lora_rank, (h, m.qk_nope_head_dim), dtype, device),
        "wuv": dense_init(generator, m.kv_lora_rank, (h, m.v_head_dim), dtype, device),
        "wo": dense_init(generator, h * m.v_head_dim, d, dtype, device),
    }


def _mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope, q_pe, ckv, k_pe) of x (B, S, D) (``attention.py:382``):
    RoPE over the whole of ``q_pe`` and ``k_pe``; ``ckv`` RMS-normed in
    float32."""
    m = cfg.mla
    q = dense(p["wq"], x)  # (b, s, h, nope + rope)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, 1.0, cfg.rope_theta)
    dkv = dense(p["wdkv"], x)  # (b, s, kv_lora + rope)
    ckv, k_pe = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    ckv = rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, 1.0, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_pe, ckv, k_pe


def _mla_decode(p: dict, q_nope: torch.Tensor, q_pe: torch.Tensor, ckv_c: torch.Tensor,
                kpe_c: torch.Tensor, valid_len: torch.Tensor, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """The absorbed form (``attention.py:413-440``) for one query a row:
    q_nope (B, h, nope), q_pe (B, h, rope), the caches (nc, kv_lora, S)
    and (nc, rope, S) of the first nc <= B rows -> ctx (B, h, v), zero for
    the rows past nc (``decode_step``'s pads). The query's latent and
    both score products are in the working type, then widened; a float32
    softmax, its weights in the cache's type; the latent context back in
    the working type before ``wuv``. Every product takes all B rows
    (:func:`pad_decode_rows`)."""
    q_lat = torch.einsum("bhq,lhq->bhl", q_nope, p["wuk"]["w"].to(dtype))
    valid, ckv_r, kpe_r = pad_decode_rows(q_nope.shape[0], valid_len, ckv_c.to(dtype),
                                          kpe_c.to(dtype))
    s_lat = torch.matmul(q_lat, ckv_r).float()  # (b, h, S)
    s_pe = torch.matmul(q_pe, kpe_r).float()
    logits = (s_lat + s_pe) * scale
    mask = torch.arange(ckv_c.shape[-1], device=q_nope.device)[None, :] < valid[:, None]
    logits = logits.masked_fill(~mask[:, None, :], _NEG)
    w = torch.softmax(logits, dim=-1).to(ckv_r.dtype)
    ctx_lat = torch.matmul(w, ckv_r.transpose(1, 2)).to(dtype)  # pad rows: zero
    return torch.einsum("bhl,lhv->bhv", ctx_lat, p["wuv"]["w"].to(dtype))


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, mode: str = "train"):
    """x (B, S, D) -> (out (B, S, D), cache) (``mla_apply``,
    ``attention.py:394``). Decode rows past the cache's are
    ``decode_step``'s pads: they attend nothing and give zeros."""
    m = cfg.mla
    b, sq, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    q_nope, q_pe, ckv, k_pe = _mla_qkv(p, x, cfg, positions)
    scale = float(1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))

    new_cache = cache
    if mode == "decode":
        assert sq == 1 and cache is not None
        idx = cache["pos"]
        ckv_c, kpe_c = cache["ckv"], cache["kpe"]
        nc = ckv_c.shape[0]
        ckv_t = ckv[:nc, 0].to(ckv_c.dtype)  # (nc, kv_lora)
        kpe_t = k_pe[:nc, 0].to(kpe_c.dtype)
        if idx.ndim == 0:
            ckv_c[:, :, idx.long()] = ckv_t
            kpe_c[:, :, idx.long()] = kpe_t
        else:
            rows = torch.arange(nc, device=x.device)
            ckv_c[rows, :, idx.long()] = ckv_t
            kpe_c[rows, :, idx.long()] = kpe_t
        new_cache = {"ckv": ckv_c, "kpe": kpe_c, "pos": idx + 1}
        ctx = _mla_decode(p, q_nope[:, 0], q_pe[:, 0], ckv_c, kpe_c, idx + 1, scale, x.dtype)
        out = ctx.reshape(b, 1, h * m.v_head_dim)
    else:
        if mode == "prefill" and cache is not None:
            ckv_c, kpe_c = cache["ckv"], cache["kpe"]
            ckv_c[:, :, :sq] = ckv.transpose(1, 2).to(ckv_c.dtype)
            kpe_c[:, :, :sq] = k_pe.transpose(1, 2).to(kpe_c.dtype)
            new_cache = {"ckv": ckv_c, "kpe": kpe_c,
                         "pos": torch.full((), sq, dtype=torch.int32, device=x.device)}
        k_nope = dense(p["wuk"], ckv)  # (b, s, h, nope): the latent expanded
        v = dense(p["wuv"], ckv)
        k_pe_b = k_pe[:, :, None, :].expand(b, sq, h, m.qk_rope_head_dim)
        k = torch.cat([k_nope, k_pe_b], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)[:, :, :, None, :]  # MHA: hkv = h, g = 1
        out = flash_attention(q, k, v, causal=cfg.causal, chunk=cfg.attn_chunk, scale=scale)
        out = out.reshape(b, sq, h * m.v_head_dim)
    return dense(p["wo"], out), new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """The latent cache: ``ckv`` (B, kv_lora, S), ``kpe`` (B, rope, S)."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, m.kv_lora_rank, max_len), dtype=dtype, device=device),
        "kpe": torch.zeros((batch, m.qk_rope_head_dim, max_len), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
