"""CPU parity of the port's Mamba2 mixer and of the SSM and hybrid stacks.

The smoke configs of mamba2-780m (2 SSM layers, d_model 64, d_state 16,
head_dim 16, chunk 16) and zamba2-2.7b (4 SSM layers, the shared attention
+ MLP block after every 2) in float32, the reference's weights carried
over with ``params_from_jax``; atol = rtol = 1e-4.

* One layer: ``ssd_chunked`` at L = 64 (four chunks of 16, so the state
  is carried three times), ``ssm_apply`` in train, prefill and decode mode
  against the reference: the output and both cache leaves; a pad row past
  the cache's rows (what ``decode_step`` adds) gives zeros, and the real
  rows do not depend on how many there are.
* The stacks: forward at L = 32, prefill and two decode steps, greedy
  ``generate`` tokens equal, a decode step at B = 9 (padded to 16 rows).
* The port alone: a prefill of P tokens and one decode step against a
  prefill of P + 1 (the recurrent form against the dual form).
* The refusals: ragged prompts, ``ScheduledEngine`` and ``--ragged`` on
  both families; a prompt of 20 tokens at chunk 16 (not a multiple); a
  prompt of 2 tokens (shorter than ``d_conv - 1``). ``check_family`` and
  ``init_cache`` admit both configs, and the launcher serves them at
  smoke width on the CPU.
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
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import model_init as j_model_init
from repro.models import prefill as j_prefill
from repro.models import ssm as j_ssm
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import (decode_step, forward, init_cache, model_init,
                                params_from_jax, prefill)
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import _map
from repro_torch.models.transformer import check_family
from repro_torch.serving import ServeConfig, generate
from repro_torch.streaming import cache as tcache

ARCHS = ("mamba2-780m", "zamba2-2.7b")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 32


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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """One mixer's weights in each package and an input (B, 64, D)."""
    jcfg, tcfg = _f32(j_smoke(ARCHS[0])), _f32(get_smoke_config(ARCHS[0]))
    jp, _ = j_ssm.ssm_init(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    tp = _map(jp, lambda a: torch.from_numpy(np.array(a, np.float32)))
    x = np.random.default_rng(4).standard_normal((B, 64, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, tp, x


def test_ssm_layer_weights_have_the_references_shapes(layer):
    jcfg, jp, tcfg, _, _ = layer
    mine = t_ssm.ssm_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert jax.tree.map(np.shape, jp) == _map(mine, lambda t: tuple(t.shape))
    assert t_ssm.ssm_dims(tcfg) == j_ssm.ssm_dims(jcfg)
    np.testing.assert_allclose(mine["A_log"]["a"].numpy(), np.asarray(jp["A_log"]["a"]),
                               rtol=1e-6)


def test_ssd_chunked_matches_reference(layer):
    """Four chunks of 16: the carried state enters three of them."""
    jcfg, _, _, _, _ = layer
    s = jcfg.ssm
    _, nh, _ = j_ssm.ssm_dims(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 64, nh, s.head_dim)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, 64, nh)))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, nh))).astype(np.float32)
    bm, cm = (rng.standard_normal((B, 64, s.d_state)).astype(np.float32) for _ in range(2))
    want_y, want_h = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), s.chunk)
    got_y, got_h = t_ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), s.chunk)
    _close(got_y, want_y)
    _close(got_h, want_h)
    assert bool(torch.isfinite(got_y).all())


def test_ssm_train_matches_reference(layer):
    jcfg, jp, tcfg, tp, x = layer
    want, _ = j_ssm.ssm_apply(jp, jnp.asarray(x), jcfg, mode="train")
    got, _ = t_ssm.ssm_apply(tp, torch.from_numpy(x), tcfg, mode="train")
    _close(got, want)


def test_ssm_prefill_and_decode_match_reference(layer):
    """Prefill of 32 tokens, then two decode steps, the port's with a pad
    row past the cache's rows: outputs and both cache leaves."""
    jcfg, jp, tcfg, tp, x = layer
    n = 32
    jc = j_ssm.ssm_cache_init(jcfg, B, jnp.float32)
    tc = t_ssm.ssm_cache_init(tcfg, B, torch.float32, "cpu")
    want, jc = j_ssm.ssm_apply(jp, jnp.asarray(x[:, :n]), jcfg, cache=jc, mode="prefill")
    got, tc = t_ssm.ssm_apply(tp, torch.from_numpy(x[:, :n]), tcfg, cache=tc, mode="prefill")
    _close(got, want)
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name])
    for t in (n, n + 1):
        xt = x[:, t:t + 1]
        want, jc = j_ssm.ssm_apply(jp, jnp.asarray(xt), jcfg, cache=jc, mode="decode")
        padded = torch.from_numpy(np.concatenate([xt, x[:1, :1]]))
        got, tc = t_ssm.ssm_apply(tp, padded, tcfg, cache=tc, mode="decode")
        _close(got[:B], want)
        assert torch.equal(got[B:], torch.zeros_like(got[B:]))
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name])


def test_ssm_decode_rows_do_not_depend_on_the_real_row_count(layer):
    """A decode step of 8 padded rows from one prefilled cache, with its 4
    rows and with its first 3: rows 0-2 bit-equal, the pad rows zero (the
    card's check of the bits is phases 3j and 3k of ``chip_smoke.py``)."""
    _, _, tcfg, tp, _ = layer
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, 17, tcfg.d_model)).astype(np.float32))
    cache = t_ssm.ssm_cache_init(tcfg, 4, torch.float32, "cpu")
    _, cache = t_ssm.ssm_apply(tp, xs[:4, :16], tcfg, cache=cache, mode="prefill")
    outs = {}
    for nc in (3, 4):
        rows = {k: v[:nc].clone() for k, v in cache.items()}
        outs[nc], _ = t_ssm.ssm_apply(tp, xs[:, 16:], tcfg, cache=rows, mode="decode")
        assert torch.equal(outs[nc][nc:], torch.zeros_like(outs[nc][nc:]))
    assert torch.equal(outs[3][:3], outs[4][:3])


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, reference params, port cfg, port params, tokens)."""
    jcfg, tcfg = _f32(j_smoke(request.param)), _f32(get_smoke_config(request.param))
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_families_are_admitted(arch):
    """Once refused as not ported; now the stack and its caches."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(j_smoke(arch))
    cfg = get_smoke_config(arch)
    check_family(cfg)
    check_family(get_config(arch))
    cache = init_cache(cfg, 1, 4, "cpu")
    assert len(cache["body"]) == cfg.n_layers
    assert set(cache["body"][0]) == {"conv", "ssm"}
    assert cache["body"][0]["ssm"].dtype == torch.float32
    if cfg.family == "hybrid":
        assert len(cache["shared"]) == cfg.n_layers // cfg.attn_every
        assert set(cache["shared"][0]) == {"k", "v", "pos"}
    else:
        assert set(cache) == {"body"}


def test_forward_logits_match(model):
    jcfg, jp, tcfg, tp, tokens = model
    if tcfg.family == "hybrid":
        assert len(tp["stack"]["body"]) == 4 and set(tp["stack"]["shared"]) == {
            "ln1", "attn", "ln2", "ffn"}
    want = j_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.inference_mode():
        got = forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    _close(got, want)


def test_prefill_and_decode_logits_match(model):
    """Prefill, then two teacher-forced decode steps."""
    jcfg, jp, tcfg, tp, tokens = model
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, j_init_cache(jcfg, B, S + 2), jcfg)
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(tokens)},
                         init_cache(tcfg, B, S + 2, "cpu"), tcfg)
        _close(tl, jl)
        rng = np.random.default_rng(1)
        for i in range(2):
            nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
            pos = np.full((B, 1), S + i, np.int32)
            jl, jc = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
            tl, tc = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                                 positions=torch.from_numpy(pos))
            _close(tl, jl)


def test_greedy_generate_tokens_equal(model):
    jcfg, jp, tcfg, tp, tokens = model
    want = j_generate(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, {"tokens": tokens}, tcfg,
                   ServeConfig(max_new_tokens=4, temperature=0.0), device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)


def test_decode_at_b9_matches(model):
    """B = 9 pads to 16 rows: 7 pad rows past the SSM caches' 9."""
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
    _close(got, want)


def test_decode_matches_a_longer_prefill(model):
    """The recurrent form against the dual form: the first decode step's
    logits against the last-position logits of a prefill of the prompt
    and that token (15 + 1 = 16: one chunk)."""
    _, _, tcfg, tp, tokens = model
    p = 15
    nxt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    with torch.inference_mode():
        _, tc = prefill(tp, {"tokens": torch.from_numpy(tokens[:, :p])},
                        init_cache(tcfg, B, p + 1, "cpu"), tcfg)
        got, _ = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                             positions=torch.full((B, 1), p, dtype=torch.int32))
        full = np.concatenate([tokens[:, :p], nxt], axis=1)
        want, _ = prefill(tp, {"tokens": torch.from_numpy(full)},
                          init_cache(tcfg, B, p + 1, "cpu"), tcfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# refusals, the launcher and the scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_params():
    """Random port weights of each smoke config, float32, on the CPU."""
    out = {}
    for arch in ARCHS:
        cfg = _f32(get_smoke_config(arch))
        out[arch] = cfg, model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prompts_raise(arch, smoke_params):
    cfg, params = smoke_params[arch]
    toks = np.zeros((2, 8), np.int32)
    lens = np.array([5, 8], np.int32)
    with pytest.raises(ValueError, match="ragged prompts need attention caches"):
        generate(params, {"tokens": toks, "lengths": lens}, cfg,
                 ServeConfig(max_new_tokens=2, temperature=0.0), device="cpu")
    with pytest.raises(ValueError, match="ragged prompts need attention caches"):
        prefill(params, {"tokens": torch.from_numpy(toks)}, init_cache(cfg, 2, 8, "cpu"), cfg,
                lengths=torch.from_numpy(lens))
    with pytest.raises(ValueError, match="ragged prompts need attention caches"):
        launcher.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "2", "--ragged", "--device", "cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_refuses(arch, smoke_params):
    from repro_torch.serving.scheduler import ScheduledEngine

    cfg, params = smoke_params[arch]
    with pytest.raises(ValueError, match="scheduler serves attention stacks"):
        ScheduledEngine(params, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plen,what", [(20, "not a multiple of the SSM chunk 16"),
                                       (2, r"shorter than the SSM's d_conv - 1 = 3")])
def test_prompts_the_reference_cannot_serve_raise(arch, plen, what, smoke_params):
    """20 tokens at chunk 16 (the reference asserts in ``ssd_chunked``); 2
    tokens, shorter than the convolution window (the reference's first
    decode step fails on a shape)."""
    cfg, params = smoke_params[arch]
    toks = torch.zeros((1, plen), dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        prefill(params, {"tokens": toks}, init_cache(cfg, 1, plen + 1, "cpu"), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu_when_asked(arch, capsys):
    out = launcher.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3", "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] tokens shape (2, 3)" in capsys.readouterr().out
