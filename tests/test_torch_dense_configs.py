"""CPU parity of the three dense configs that only their fields tied to
the reference: qwen1.5-32b (``qkv_bias``), chatglm3-6b (``rope_fraction``
0.5) and deepseek-coder-33b, each at smoke width in float32 with the
reference's weights carried over by ``params_from_jax``.

For each: the config fields, ``forward`` logits, a prefill plus three
teacher-forced decode steps (atol = rtol = 1e-4, as
``tests/test_torch_serve.py``: the two packages sum in different
orders), and greedy ``generate`` tokens on ragged prompts, equal.
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
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import decode_step, forward, init_cache, params_from_jax, prefill
from repro_torch.serving import ServeConfig, generate

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 10
ARCHS = ("qwen1.5-32b", "chatglm3-6b", "deepseek-coder-33b")


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_cache(tmp_path_factory):
    """Keep the reference's planner off any cached tournament winner."""
    from repro.streaming.cache import AutotuneCache, set_default_cache

    path = str(tmp_path_factory.mktemp("autotune") / "autotune.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    prev = set_default_cache(AutotuneCache(path))
    yield
    set_default_cache(prev)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(reference cfg, reference params, port cfg, port params, tokens)."""
    name = request.param
    jcfg = dataclasses.replace(j_smoke(name), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(ARCHS.index(name)).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


@pytest.mark.parametrize("name", ARCHS)
def test_dense_config_matches_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == dataclasses.asdict(j_smoke(name))
    assert get_config(name).family == "dense"


def test_params_billions():
    """The sizes the card's phase 3o serves (bf16: two bytes each)."""
    got = {n: round(get_config(n).params_billions(), 3) for n in ARCHS}
    assert got == {"qwen1.5-32b": 35.195, "chatglm3-6b": 6.243, "deepseek-coder-33b": 33.342}


def test_forward_logits_match(models):
    jcfg, jp, tcfg, tp, tokens = models
    want = j_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.inference_mode():
        got = forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match(models):
    """Prefill, then three teacher-forced decode steps."""
    jcfg, jp, tcfg, tp, tokens = models
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, j_init_cache(jcfg, B, S + 3), jcfg)
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(tokens)},
                         init_cache(tcfg, B, S + 3, "cpu"), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        rng = np.random.default_rng(1)
        for i in range(3):
            nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
            pos = np.full((B, 1), S + i, np.int32)
            jl, jc = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
            tl, tc = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                                 positions=torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_greedy_generate_tokens_equal(models):
    """Ragged right-padded prompts, greedy decode: the same tokens."""
    jcfg, jp, tcfg, tp, tokens = models
    lens = np.array([6, S], np.int32)
    toks = tokens.copy()
    toks[0, 6:] = 0
    want = j_generate(jp, {"tokens": jnp.asarray(toks), "lengths": lens}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, {"tokens": toks, "lengths": lens}, tcfg,
                   ServeConfig(max_new_tokens=4, temperature=0.0), device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)
