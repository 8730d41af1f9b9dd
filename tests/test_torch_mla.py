"""CPU parity of the port's MLA attention and of DeepSeek-V2-Lite's stack.

The smoke config of deepseek-v2-lite-16b in float32 (2 layers: a leading
dense block, the head, and a MoE block with a shared expert; 4 heads,
kv_lora 32, qk_nope 16, qk_rope 8, v 16), the reference's weights carried
over with ``params_from_jax``.

* ``mla_apply`` in train, prefill and decode mode against the reference's
  on one layer's weights: outputs and the latent cache to atol = rtol =
  1e-4, decode with one write position a row; a pad row past the cache's
  rows (what ``decode_step`` adds) attends nothing and gives zeros.
* The stack: forward, prefill and decode logits, ragged prefill, greedy
  ``generate`` tokens equal, a decode step at B = 9 (padded to 16 rows):
  logits to 1e-4. The router can flip an expert on a near-tie between a
  token's k-th and (k+1)-th logit, so each of those tests records the
  smallest such gap and names it when the logits differ (as
  ``tests/test_torch_moe.py`` does).
* The absorbed decode against the non-absorbed form: the first decode
  step's logits against the last-position logits of a prefill of the
  prompt and that token, in the port alone, to 1e-4.
* ``check_family`` takes the config; the launcher serves it at smoke width
  on the CPU; ``ScheduledEngine`` refuses it with the reference's message
  (its leading dense layer is a second cache group).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as j_att
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import model_init as j_model_init
from repro.models import prefill as j_prefill
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import (decode_step, forward, init_cache, model_init,
                                params_from_jax, prefill)
from repro_torch.models import attention as t_att
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import _map
from repro_torch.models.transformer import check_family
from repro_torch.serving import ServeConfig, generate
from repro_torch.streaming import cache as tcache

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 10


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_caches(tmp_path_factory):
    """Keep both planners off any cached tournament winner."""
    from repro.streaming.cache import AutotuneCache, set_default_cache

    d = tmp_path_factory.mktemp("autotune")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(d / "ref.json")
    prev = set_default_cache(AutotuneCache(str(d / "ref.json")))
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(str(d / "port.json")))
    yield
    set_default_cache(prev)
    tcache.set_default_cache(prev_t)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params, tokens)."""
    jcfg, tcfg = _f32(j_smoke(ARCH)), _f32(get_smoke_config(ARCH))
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


@pytest.fixture
def router_gaps(monkeypatch):
    """The smallest gap between a token's k-th and (k+1)-th router logit
    over every router call of the port, recorded while the test runs."""
    gaps = []
    real = t_moe.router_topk

    def recorded(logits, k, block):
        top = torch.sort(logits.float(), dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return real(logits, k, block)

    monkeypatch.setattr(t_moe, "router_topk", recorded)
    return gaps


def _close(got, want, gaps=()):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=f"smallest router gap {min(gaps, default=None)}")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights in each package and an input (B, S, D)."""
    jcfg, tcfg = _f32(j_smoke(ARCH)), _f32(get_smoke_config(ARCH))
    jp, _ = j_att.mla_init(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    tp = _map(jp, lambda a: torch.from_numpy(np.array(a, np.float32)))
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, tp, x


def test_mla_layer_weights_have_the_references_shapes(layer):
    jcfg, jp, tcfg, tp, _ = layer
    mine = t_att.mla_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert jax.tree.map(np.shape, jp) == _map(mine, lambda t: tuple(t.shape))
    assert mine["kv_norm"]["scale"].dtype == torch.float32
    m = tcfg.mla
    assert tuple(mine["wq"]["w"].shape) == (tcfg.d_model, tcfg.n_heads,
                                             m.qk_nope_head_dim + m.qk_rope_head_dim)


def test_mla_train_matches_reference(layer):
    jcfg, jp, tcfg, tp, x = layer
    want, _ = j_att.mla_apply(jp, jnp.asarray(x), jcfg, mode="train")
    got, _ = t_att.mla_apply(tp, torch.from_numpy(x), tcfg, mode="train")
    _close(got, want)


def test_mla_prefill_and_decode_match_reference(layer):
    """Prefill of S - 2 tokens, then a decode step with one write position
    a row (rows at different depths), and a pad row past the cache's."""
    jcfg, jp, tcfg, tp, x = layer
    n = S - 2
    jc = j_att.mla_cache_init(jcfg, B, S, jnp.float32)
    tc = t_att.mla_cache_init(tcfg, B, S, torch.float32, "cpu")
    want, jc = j_att.mla_apply(jp, jnp.asarray(x[:, :n]), jcfg, cache=jc, mode="prefill")
    got, tc = t_att.mla_apply(tp, torch.from_numpy(x[:, :n]), tcfg, cache=tc, mode="prefill")
    _close(got, want)
    for name in ("ckv", "kpe"):
        _close(tc[name], jc[name])
    assert int(tc["pos"]) == int(jc["pos"]) == n
    pos = np.array([n - 3, n], np.int32)  # row 0 rewinds: its later slots are masked
    jc = dict(jc, pos=jnp.asarray(pos))
    tc = dict(tc, pos=torch.from_numpy(pos))
    xt = x[:, n:n + 1]
    want, jc = j_att.mla_apply(jp, jnp.asarray(xt), jcfg, cache=jc, mode="decode",
                               positions=jnp.asarray(pos[:, None]))
    padded = torch.from_numpy(np.concatenate([xt, x[:1, :1]]))  # a pad row
    got, tc = t_att.mla_apply(tp, padded, tcfg, cache=tc, mode="decode",
                              positions=torch.from_numpy(np.array([[n - 3], [n], [0]], np.int32)))
    _close(got[:B], want)
    assert torch.equal(got[B:], torch.zeros_like(got[B:]))
    for name in ("ckv", "kpe"):
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == (pos + 1).tolist()


def test_mla_decode_rows_do_not_depend_on_the_real_row_count(layer):
    """A decode step of 8 padded rows from one prefilled cache, with its 4
    rows and with its first 3: rows 0-2 bit-equal, the pad rows zero. The
    cache products take all 8 rows either way (the card's check of the
    bits is phase 3i of ``chip_smoke.py``)."""
    _, _, tcfg, tp, _ = layer
    n = S - 2
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, S, tcfg.d_model)).astype(np.float32))
    cache = t_att.mla_cache_init(tcfg, 4, S, torch.float32, "cpu")
    _, cache = t_att.mla_apply(tp, xs[:4, :n], tcfg, cache=cache, mode="prefill")
    pos = torch.full((8, 1), n, dtype=torch.int32)
    outs = {}
    for nc in (3, 4):
        rows = {k: (v[:nc].clone() if v.ndim else v.clone()) for k, v in cache.items()}
        outs[nc], _ = t_att.mla_apply(tp, xs[:, n:n + 1], tcfg, cache=rows, mode="decode",
                                      positions=pos)
        assert torch.equal(outs[nc][nc:], torch.zeros_like(outs[nc][nc:]))
    assert torch.equal(outs[3][:3], outs[4][:3])


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def test_config_matches_reference_and_is_served():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(j_smoke(ARCH))
    check_family(get_config(ARCH))
    cache = init_cache(get_smoke_config(ARCH), 1, 4, "cpu")
    assert set(cache["head"][0]) == set(cache["body"][0]) == {"ckv", "kpe", "pos"}


def test_forward_logits_match(model, router_gaps):
    jcfg, jp, tcfg, tp, tokens = model
    assert len(tp["stack"]["head"]) == 1 and len(tp["stack"]["body"]) == 1
    want = j_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.inference_mode():
        got = forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    _close(got, want, router_gaps)


def test_prefill_and_decode_logits_match(model, router_gaps):
    """Prefill, then two teacher-forced decode steps."""
    jcfg, jp, tcfg, tp, tokens = model
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, j_init_cache(jcfg, B, S + 2), jcfg)
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(tokens)},
                         init_cache(tcfg, B, S + 2, "cpu"), tcfg)
        _close(tl, jl, router_gaps)
        rng = np.random.default_rng(1)
        for i in range(2):
            nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
            pos = np.full((B, 1), S + i, np.int32)
            jl, jc = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
            tl, tc = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                                 positions=torch.from_numpy(pos))
            _close(tl, jl, router_gaps)


def test_ragged_prefill_logits_match(model, router_gaps):
    """Every layer cache, the head's latent one too, continues from each
    row's length."""
    jcfg, jp, tcfg, tp, tokens = model
    lens = np.array([4, S], np.int32)
    toks = tokens.copy()
    toks[0, 4:] = 0
    jl, _ = j_prefill(jp, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, B, S), jcfg,
                      lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, init_cache(tcfg, B, S, "cpu"),
                         tcfg, lengths=torch.from_numpy(lens))
    _close(tl, jl, router_gaps)
    for lc in tc["head"] + tc["body"]:
        assert lc["pos"].tolist() == lens.tolist()


def test_greedy_generate_tokens_equal(model):
    jcfg, jp, tcfg, tp, tokens = model
    lens = np.array([6, S], np.int32)
    toks = tokens.copy()
    toks[0, 6:] = 0
    want = j_generate(jp, {"tokens": jnp.asarray(toks), "lengths": lens}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, {"tokens": toks, "lengths": lens}, tcfg,
                   ServeConfig(max_new_tokens=4, temperature=0.0), device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)


def test_decode_at_b9_matches(model, router_gaps):
    """B = 9 pads to 16 rows: 7 pad rows past the latent caches' 9."""
    jcfg, jp, tcfg, tp, _ = model
    b, s = 9, 4
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    nxt = np.random.default_rng(10).integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.full((b, 1), s, np.int32)
    _, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, b, s + 1), jcfg)
    want, _ = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
    with torch.inference_mode():
        _, tc = prefill(tp, {"tokens": torch.from_numpy(toks)},
                        init_cache(tcfg, b, s + 1, "cpu"), tcfg)
        got, _ = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                             positions=torch.from_numpy(pos))
    _close(got, want, router_gaps)


def test_absorbed_decode_matches_the_expanded_form(model):
    """The first decode step (absorbed, against the latent cache) against
    a prefill of the prompt and that token (the latent expanded to
    per-head keys and values): the same logits up to float32 rounding.
    The expert capacity grows with the tokens of a call, so a choice
    dropped in one call may be kept in the other; a capacity factor of
    n_experts / top_k drops none, in either."""
    _, _, tcfg, tp, tokens = model
    moe = tcfg.moe
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    nxt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    with torch.inference_mode():
        _, tc = prefill(tp, {"tokens": torch.from_numpy(tokens)},
                        init_cache(tcfg, B, S + 1, "cpu"), tcfg)
        got, _ = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                             positions=torch.full((B, 1), S, dtype=torch.int32))
        full = np.concatenate([tokens, nxt], axis=1)
        want, _ = prefill(tp, {"tokens": torch.from_numpy(full)},
                          init_cache(tcfg, B, S + 1, "cpu"), tcfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# the launcher and the scheduler
# ---------------------------------------------------------------------------


def test_launcher_serves_deepseek_on_cpu_when_asked(capsys):
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3", "--ragged", "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] tokens shape (2, 3)" in capsys.readouterr().out


def test_scheduler_refuses_deepseek():
    from repro_torch.serving.scheduler import ScheduledEngine

    cfg = get_smoke_config(ARCH)
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match=r"paged slots need a homogeneous attention stack, "
                                         r"got cache groups \['body', 'head'\]"):
        ScheduledEngine(params, cfg, device="cpu")
