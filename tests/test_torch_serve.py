"""CPU parity of the port's serving slice against the JAX package.

The smoke config of Qwen3-8B in float32, once as it is (vocab 256: the
router top-k branch) and once with vocab 1000 (the vocab branch). The
reference's weights are carried over with ``params_from_jax``. Logits
agree to atol = rtol = 1e-4 (float32; the two sum in different orders);
greedy tokens, and sampled tokens with the reference's own Gumbel noise
injected, are equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import model_init as j_model_init
from repro.models import prefill as j_prefill
from repro.serving import sample as j_sample
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import decode_step, forward, init_cache, params_from_jax, prefill
from repro_torch.serving import ServeConfig, generate, sample

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 10


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


@pytest.fixture(scope="module", params=[256, 1000], ids=["router", "vocab"])
def models(request):
    """(reference cfg, reference params, port cfg, port params, tokens)."""
    vocab = request.param
    jcfg = dataclasses.replace(j_smoke("qwen3-8b"), dtype="float32", vocab_size=vocab)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32",
                               vocab_size=vocab)
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(vocab).integers(0, vocab, (B, S)).astype(np.int32)
    return jcfg, jp, tcfg, tp, tokens


def test_config_matches_reference():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCHS

    dense = sorted(n for n, c in ARCHS.items() if c.family == "dense")
    assert dense == ["chatglm3-6b", "deepseek-coder-33b", "qwen1.5-32b", "qwen3-8b"]
    for name in dense:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(get_smoke_config(name)) == dataclasses.asdict(j_smoke(name))
    assert abs(get_config("qwen3-8b").params_billions() - 8.19) < 0.01


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


def test_ragged_prefill_logits_match(models):
    jcfg, jp, tcfg, tp, tokens = models
    lens = np.array([4, S], np.int32)
    toks = tokens.copy()
    toks[0, 4:] = 0
    jl, _ = j_prefill(jp, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, B, S),
                      jcfg, lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)},
                         init_cache(tcfg, B, S, "cpu"), tcfg, lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["body"][0]["pos"].tolist() == lens.tolist()


def test_greedy_generate_tokens_equal(models):
    """Ragged right-padded prompts, greedy decode: the same tokens."""
    jcfg, jp, tcfg, tp, tokens = models
    lens = np.array([6, S], np.int32)
    toks = tokens.copy()
    toks[0, 6:] = 0
    batch = {"tokens": toks, "lengths": lens}
    want = j_generate(jp, {"tokens": jnp.asarray(toks), "lengths": lens}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, batch, tcfg, ServeConfig(max_new_tokens=4, temperature=0.0),
                   device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)


def _tied_logits(rows, vocab, seed):
    x = (np.random.default_rng(seed).integers(-20, 21, (rows, vocab)) * 0.25)
    return x.astype(np.float32)


@pytest.fixture
def lax_scoring(monkeypatch):
    """Pin the reference sampler's candidate scoring to its ``lax`` backend:
    on the CPU its auto route compiles a sorting network per shape (seconds
    each). Candidate values do not depend on the backend, and the sampler
    maps ties to the lowest vocab id, so its tokens do not either."""
    from repro import topk as j_topk

    monkeypatch.setattr(j_sample, "unified_topk",
                        lambda x, k, par=None: j_topk(x, k, backend="lax"))


@pytest.mark.parametrize("vocab,k,top_p", [(256, 16, 1.0), (1000, 64, 0.9),
                                           (256, 8, 0.5)])
def test_sample_topk_with_reference_noise(lax_scoring, vocab, k, top_p):
    """The reference's categorical draw is argmax(logits + gumbel(key));
    handing the port the same noise gives the same tokens."""
    logits = _tied_logits(6, vocab, seed=vocab + k)
    key = jax.random.PRNGKey(k)
    want = j_sample.sample_topk(key, jnp.asarray(logits), k=k, temperature=0.8, top_p=top_p)
    noise = np.array(jax.random.gumbel(key, (6, k), jnp.float32))
    got = sample.sample_topk(torch.from_numpy(logits), k=k, temperature=0.8, top_p=top_p,
                             gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scored_draw_and_canonical_token_match():
    logits = _tied_logits(5, 300, seed=3)
    vals = -np.sort(-logits, axis=-1)[:, :32]
    key = jax.random.PRNGKey(7)
    j_choice = j_sample.scored_draw(key, jnp.asarray(vals), 0.7, 0.8)
    noise = np.array(jax.random.gumbel(key, vals.shape, jnp.float32))
    choice = sample.scored_draw(torch.from_numpy(vals), 0.7, 0.8,
                                gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(j_choice))
    np.testing.assert_array_equal(
        sample.canonical_token(torch.from_numpy(logits), torch.from_numpy(vals), choice).numpy(),
        np.asarray(j_sample.canonical_token(jnp.asarray(logits), jnp.asarray(vals), j_choice)))


def test_sample_topp_and_greedy_match(lax_scoring):
    """Untied logits (sample_topp returns the kernel's index directly)."""
    logits = np.random.default_rng(5).standard_normal((4, 1000)).astype(np.float32) * 3
    key = jax.random.PRNGKey(2)
    want = j_sample.sample_topp(key, jnp.asarray(logits), p=0.9, k_max=256)
    noise = np.array(jax.random.gumbel(key, (4, 256), jnp.float32))
    got = sample.sample_topp(torch.from_numpy(logits), p=0.9, k_max=256,
                             gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sample.sample_greedy(torch.from_numpy(logits)).numpy(),
                                  np.asarray(j_sample.sample_greedy(jnp.asarray(logits))))


def test_sampled_generate_is_seeded_and_in_support():
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    from repro_torch.models import model_init

    params = model_init(torch.Generator().manual_seed(3), cfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    sc = ServeConfig(max_new_tokens=4, top_k=8, temperature=0.8, seed=11, time_steps=True)
    a = generate(params, {"tokens": toks}, cfg, sc, device="cpu")
    b = generate(params, {"tokens": toks}, cfg, sc, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 4) and a["decode_step_p50_us"] > 0
    with torch.inference_mode():
        logits, _ = prefill(params, {"tokens": torch.from_numpy(toks)},
                            init_cache(cfg, 2, 12, "cpu"), cfg)
    top8 = torch.topk(logits, 8).indices.numpy()  # test oracle, not the port
    for r in range(2):
        assert a["tokens"][r, 0] in top8[r]


def test_launcher_runs_on_cpu_when_asked(capsys):
    out = launcher.main(["--arch", "qwen3-8b", "--smoke", "--batch", "2",
                         "--prompt-len", "8", "--new-tokens", "3", "--ragged",
                         "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] tokens shape (2, 3)" in capsys.readouterr().out
