"""The Mamba2 (state space duality) mixer: the chunked dual form and the
recurrent decode (counterpart of ``repro.models.ssm``).

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t + D x_t

(one group: B and C are shared by every head). Train and prefill run the
chunked algorithm: within a chunk an attention-like product masked by the
decays, across chunks a carried state. Decode keeps the last ``d_conv -
1`` pre-convolution rows and the float32 state (B, H, P, N), and costs
the same for every token. All of it is plain torch ops: the JAX package
has no Pallas kernel here.

The arithmetic is the reference's, operation for operation, with JAX's
type promotion: ``a_coef`` in the parameters' type, ``dt`` float32, the
chunk products float32 and each chunk's ``y`` cast back to the input's
type, prefill's skip term in the working type and decode's in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import dense, dense_init, dense_spec, rmsnorm


def ssm_dims(cfg: ModelConfig):
    """(d_in, heads, conv channels) of the mixer."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.d_state


def ssm_init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device) -> dict:
    """``ssm_init`` (``ssm.py:33``): ``in_proj`` (D, 2 d_in + 2 N + H) for z,
    x, B, C and dt; ``conv_w`` (K, conv) ~ normal x 0.2; ``conv_b`` zeros;
    ``A_log`` log(linspace(1, 16, H)); ``D`` ones; ``dt_bias`` zeros; the
    gated norm's scale; ``out_proj`` (d_in, D). Each drawn or computed in
    float32 and stored in ``dtype``."""
    s = cfg.ssm
    d_in, nh, conv_dim = ssm_dims(cfg)
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    conv_w = torch.randn((s.d_conv, conv_dim), generator=generator, device=device, dtype=f32)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device))
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_in + 2 * s.d_state + nh,
                              dtype, device),
        "conv_w": {"w": conv_w.mul_(0.2).to(dtype)},
        "conv_b": {"b": full((conv_dim,), 0.0)},
        "A_log": {"a": a_log.to(dtype)},
        "D": {"d": full((nh,), 1.0)},
        "dt_bias": {"b": full((nh,), 0.0)},
        "norm": {"scale": full((d_in,), 1.0)},
        "out_proj": dense_init(generator, d_in, cfg.d_model, dtype, device),
    }


def ssm_specs(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`ssm_init`'s leaves (``ssm.py:32``)."""
    return {"in_proj": dense_spec(("embed", "mlp")),
            "conv_w": {"w": (None, "mlp")},
            "conv_b": {"b": ("mlp",)},
            "A_log": {"a": ("heads",)},
            "D": {"d": ("heads",)},
            "dt_bias": {"b": ("heads",)},
            "norm": {"scale": ("mlp",)},
            "out_proj": dense_spec(("mlp", "embed"))}


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along S (``ssm.py:56``): u (B, S, C),
    w (K, C). The K taps are added one after another in float32 over a
    left zero pad; SiLU; back to u's type."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    acc = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        acc = acc + pad[:, i:i + s, :].float() * w[i].float()
    return F.silu(acc + b.float()).to(u.dtype)


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, xBC, dt) of the input projection's output."""
    s = cfg.ssm
    d_in = ssm_dims(cfg)[0]
    xbc_end = 2 * d_in + 2 * s.d_state
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:xbc_end], zxbcdt[..., xbc_end:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int):
    """The SSD forward (``ssm.py:76``). x (B, L, H, P); dt (B, L, H); a_coef
    (H,) negative; bmat / cmat (B, L, N). Returns y (B, L, H, P) in x's
    type and the final state (B, H, P, N) float32. The chunk is
    ``min(chunk, L)``, and L must be a multiple of it."""
    b, l, h, p_ = x.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"a sequence of {l} tokens is not a multiple of the SSM chunk {q}")
    f32 = torch.float32
    i_idx = torch.arange(q, device=x.device)
    tri = i_idx[:, None] >= i_idx[None, :]
    hstate = torch.zeros((b, h, p_, n), dtype=f32, device=x.device)
    ys = []
    for c in range(l // q):
        rows = slice(c * q, (c + 1) * q)
        x_c = x[:, rows].float()  # (b, q, h, p)
        dt_c = dt[:, rows].float()  # (b, q, h)
        b_c, c_c = bmat[:, rows].float(), cmat[:, rows].float()  # (b, q, n)
        cum = torch.cumsum(dt_c * a_coef[None, None, :], dim=1)
        # mask the exponent before exp: the upper triangle's positive
        # cum_i - cum_j overflows to inf, and inf * 0 is NaN
        expo = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.exp(expo.masked_fill(~tri[None, :, :, None], -math.inf))
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)
        w = scores[..., None] * decay * dt_c[:, None, :, :]  # (b, i, j, h)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, x_c)
        y_inter = torch.einsum("bin,bhpn->bihp", c_c, hstate) * torch.exp(cum)[..., None]
        end_decay = torch.exp(cum[:, -1:, :] - cum)  # (b, q, h)
        sc = torch.einsum("bjn,bjh,bjhp->bhpn", b_c, end_decay * dt_c, x_c)
        hstate = hstate * torch.exp(cum[:, -1, :])[:, :, None, None] + sc
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), hstate


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[dict] = None, mode: str = "train", ctx=None):
    """x (B, S, D) -> (out (B, S, D), cache) (``ssm_apply``, ``ssm.py:127``).
    ``mode``: train | prefill | decode. Prefill fills ``cache`` in place
    (the last ``d_conv - 1`` pre-convolution rows and the final state) and
    refuses a prompt shorter than ``d_conv - 1``. Decode advances the cache
    in place by one token; its rows past the cache's are ``decode_step``'s
    pads: the projections take them, the recurrence does not, and their
    output is zero. Under ``ctx`` (a call under ``par``):
    :func:`_ssm_spmd`."""
    if ctx is not None:
        if ctx.tp == 1:
            c, plan = ctx.cache_local(cache)
            y, c = ssm_apply(ctx.local(p), x, cfg, cache=c, mode=mode)
            return y, ctx.cache_store(cache, c, plan)
        return _ssm_spmd(p, x, cfg, ctx, cache, mode)
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    b, l, _ = x.shape
    zxbcdt = dense(p["in_proj"], x)
    z, xbc, dt = _split_zxbcdt(zxbcdt, cfg)
    a_coef = -torch.exp(p["A_log"]["a"])  # (H,), the parameters' type
    dt = _softplus(dt.float() + p["dt_bias"]["b"][None, None, :])

    if mode == "decode":
        if l != 1 or cache is None:
            raise ValueError(f"SSM decode takes one token and a cache, not {l} tokens")
        conv_state, hstate = cache["conv"], cache["ssm"]
        nc = conv_state.shape[0]
        window = torch.cat([conv_state, xbc[:nc]], dim=1)  # (nc, K, conv)
        conv_out = (window.float() * p["conv_w"]["w"].float()[None]).sum(dim=1)
        xbc_t = F.silu(conv_out + p["conv_b"]["b"][None, :]).to(x.dtype)
        xt = xbc_t[:, :d_in].reshape(nc, nh, s.head_dim)
        bt = xbc_t[:, d_in:d_in + s.d_state]
        ct = xbc_t[:, d_in + s.d_state:]
        dt1 = dt[:nc, 0, :]  # (nc, H)
        dec = torch.exp(dt1 * a_coef[None, :])
        upd = torch.einsum("bh,bn,bhp->bhpn", dt1, bt.float(), xt.float())
        hstate.mul_(dec[:, :, None, None]).add_(upd)
        conv_state.copy_(window[:, 1:])
        y = torch.einsum("bn,bhpn->bhp", ct.float(), hstate)
        y = y + p["D"]["d"][None, :, None] * xt.float()
        y = y.reshape(nc, 1, d_in).to(x.dtype)
        if nc < b:  # the pad rows' output is zero
            y = torch.cat([y, y.new_zeros((b - nc, 1, d_in))])
    else:
        if mode == "prefill" and cache is not None and l < s.d_conv - 1:
            raise ValueError(f"a prompt of {l} tokens is shorter than the SSM's d_conv - 1 = "
                             f"{s.d_conv - 1}: decode's convolution window needs that many")
        xbc_c = _causal_conv(xbc, p["conv_w"]["w"], p["conv_b"]["b"])
        xs = xbc_c[..., :d_in].reshape(b, l, nh, s.head_dim)
        bmat = xbc_c[..., d_in:d_in + s.d_state]
        cmat = xbc_c[..., d_in + s.d_state:]
        y, hfin = ssd_chunked(xs, dt, a_coef, bmat, cmat, s.chunk)
        y = y + p["D"]["d"][None, None, :, None].to(y.dtype) * xs
        y = y.reshape(b, l, d_in)
        if mode == "prefill" and cache is not None:
            cache["conv"].copy_(xbc_raw_tail(zxbcdt, cfg, s.d_conv))
            cache["ssm"].copy_(hfin)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return dense(p["out_proj"], y), cache


def _ssm_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx, cache, mode: str):
    """The mixer on a TP axis of more than one rank, each leaf in the
    layout its spec gives it (no weight is gathered over the TP axis):

    * ``in_proj``'s column block (``mlp``), the projection all-gathered
      (its fused z, x, B, C, dt columns are not blocks of heads);
    * the depthwise convolution on this rank's channel block (``conv_w``,
      ``conv_b`` and the ``conv`` cache by channels), all-gathered;
    * the scan on this rank's heads (``A_log``, ``D``, ``dt_bias`` and the
      state cache by heads: the reference's head anchor, ``ssm.py:172``),
      B and C whole; where the heads do not divide, every head, and the
      state cache split over ``d_state`` is read by a partial ``C . h``
      and one all-reduce;
    * the gate, the norm (its mean square summed over the TP axis) and
      ``out_proj``'s row block on this rank's block of ``d_in``, one
      all-reduce of the output.

    A leaf the spec does not split is whole on every rank. ``d_in`` that
    does not divide the TP axis has no layout here and raises."""
    s = cfg.ssm
    d_in, nh, conv_dim = ssm_dims(cfg)
    n_st, hd = s.d_state, s.head_dim
    b, l, _ = x.shape
    split_in = ctx.split(2 * d_in + 2 * n_st + nh)
    split_conv, split_heads = ctx.split(conv_dim), ctx.split(nh)
    if not ctx.split(d_in):
        raise ValueError(f"{cfg.name}: the SSM's d_in {d_in} does not split over a TP axis "
                         f"of {ctx.tp}")
    shard = {"in_proj": 1 if split_in else None, "conv_w": 1 if split_conv else None,
             "conv_b": 1 if split_conv else None, "out_proj": 0, "norm": 0}
    if split_heads:
        shard.update({"A_log": 0, "D": 0, "dt_bias": 1})
    lp = ctx.local(p, shard, inside=True)
    x = ctx.copy_to(x)
    zxbcdt = dense(lp["in_proj"], x)
    if split_in:
        zxbcdt = ctx.gather_blocks(zxbcdt, -1)
    z, xbc, dt = _split_zxbcdt(zxbcdt, cfg)
    r, t = ctx.tp_rank, ctx.tp
    heads = slice(r * nh // t, (r + 1) * nh // t) if split_heads else slice(None)
    chans = slice(r * conv_dim // t, (r + 1) * conv_dim // t) if split_conv else slice(None)
    a_coef = -torch.exp(lp["A_log"]["a"])
    dt = _softplus(dt[..., heads].float() + lp["dt_bias"]["b"][None, None, :])
    d_skip = lp["D"]["d"]
    ctx.expect_split(cache, {"conv": 2 if split_conv else None})
    c, plan = ctx.cache_local(cache)
    if mode == "decode":
        if l != 1 or c is None:
            raise ValueError(f"SSM decode takes one token and a cache, not {l} tokens")
        y = _ssm_decode_spmd(lp, xbc, dt, a_coef, d_skip, c, ctx.tp_dim(cache["ssm"]),
                             cfg, ctx, heads, split_conv, b, x.dtype)
    else:
        if mode == "prefill" and c is not None and l < s.d_conv - 1:
            raise ValueError(f"a prompt of {l} tokens is shorter than the SSM's d_conv - 1 = "
                             f"{s.d_conv - 1}: decode's convolution window needs that many")
        xbc_c = _causal_conv(xbc[..., chans], lp["conv_w"]["w"], lp["conv_b"]["b"])
        if split_conv:
            xbc_c = ctx.gather_blocks(xbc_c, -1)
        xs = xbc_c[..., :d_in].reshape(b, l, nh, hd)[:, :, heads]
        y, hfin = ssd_chunked(xs, dt, a_coef, xbc_c[..., d_in:d_in + n_st],
                              xbc_c[..., d_in + n_st:], s.chunk)
        y = (y + d_skip[None, None, :, None].to(y.dtype) * xs).reshape(b, l, -1)
        if mode == "prefill" and c is not None:
            c["conv"].copy_(xbc_raw_tail(zxbcdt, cfg, s.d_conv)[..., chans])
            c["ssm"].copy_(hfin if split_heads else ctx.block(hfin, ctx.tp_dim(cache["ssm"])))
    if not split_heads:  # every head: this rank's block of d_in
        y = ctx.block(y, 2)
    y = y * F.silu(ctx.block(z, 2))
    yf = y.float()
    var = ctx.tp_sum(torch.sum(yf * yf, dim=-1, keepdim=True)) / d_in
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * lp["norm"]["scale"].float()).to(y.dtype)
    return ctx.reduce_from(dense(lp["out_proj"], y)), ctx.cache_store(cache, c, plan)


@torch.no_grad()
def _ssm_decode_spmd(p, xbc, dt, a_coef, d_skip, c, state_dim, cfg, ctx, heads, split_conv,
                     b, dtype):
    """:func:`_ssm_spmd`'s decode step on this rank's blocks of the
    caches -> y (B, 1, d_in or this rank's heads' block)."""
    from repro_torch.parallel.spmd import all_gather, all_reduce

    s = cfg.ssm
    d_in, nh, conv_dim = ssm_dims(cfg)
    conv_state, hstate = c["conv"], c["ssm"]
    nc = conv_state.shape[0]
    t, r = ctx.tp, ctx.tp_rank
    chans = slice(r * conv_dim // t, (r + 1) * conv_dim // t) if split_conv else slice(None)
    window = torch.cat([conv_state, xbc[:nc, :, chans]], dim=1)  # (nc, K, channels)
    conv_out = (window.float() * p["conv_w"]["w"].float()[None]).sum(dim=1)
    xbc_t = F.silu(conv_out + p["conv_b"]["b"][None, :]).to(dtype)
    if split_conv:
        xbc_t = all_gather(xbc_t, ctx.tp_group, 1)
    xt = xbc_t[:, :d_in].reshape(nc, nh, s.head_dim)[:, heads]
    bt = xbc_t[:, d_in:d_in + s.d_state]
    ct = xbc_t[:, d_in + s.d_state:]
    if state_dim == 3:  # the state split over d_state: this rank's block of it
        bt, ct = ctx.block(bt, 1), ctx.block(ct, 1)
    dt1 = dt[:nc, 0, :]
    dec = torch.exp(dt1 * a_coef[None, :])
    upd = torch.einsum("bh,bn,bhp->bhpn", dt1, bt.float(), xt.float())
    hstate.mul_(dec[:, :, None, None]).add_(upd)
    conv_state.copy_(window[:, 1:])
    y = torch.einsum("bn,bhpn->bhp", ct.float(), hstate)
    if state_dim == 3:
        y = all_reduce(y, ctx.tp_group)
    y = y + d_skip[None, :, None] * xt.float()
    y = y.reshape(nc, 1, -1).to(dtype)
    if nc < b:  # the pad rows' output is zero
        y = torch.cat([y, y.new_zeros((b - nc, 1, y.shape[-1]))])
    return y


def xbc_raw_tail(zxbcdt: torch.Tensor, cfg: ModelConfig, k: int) -> torch.Tensor:
    """The last k - 1 pre-convolution xBC rows (the prefill -> decode
    handoff, ``ssm.py:186``)."""
    return _split_zxbcdt(zxbcdt, cfg)[1][:, -(k - 1):, :]


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype, device) -> dict:
    """``conv`` (B, d_conv - 1, conv channels) in the cache's type; ``ssm``
    the float32 state (B, H, P, N)."""
    s = cfg.ssm
    _, nh, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }
