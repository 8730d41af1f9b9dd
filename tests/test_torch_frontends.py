"""CPU parity of the port's vlm and audio frontends against the JAX package.

The smoke configs of internvl2-26b (vlm: 8 patches of 32 in front of the
text, a dense GQA stack, vocab 256) and hubert-xlarge (audio: frames of
32 through ``frontend``, a non-causal encoder with a gelu MLP, vocab 503)
in float32; the reference's weights carried over with ``params_from_jax``.
Logits, caches and losses agree to atol = rtol = 1e-4 (the two packages
sum in different orders); greedy tokens are equal.

* internvl2-26b: prefill logits and KV caches with the same patches, two
  decode steps at the positions past the patch prefix, ``forward`` (text
  positions only), ``loss_fn``, greedy ``generate``; the launcher at
  smoke width; ragged prompts and ``ScheduledEngine`` refused.
* hubert-xlarge: the gelu MLP and the non-causal attention layer alone,
  ``forward`` and ``loss_fn`` with and without a mask; ``init_cache``,
  ``generate``, ``ScheduledEngine`` and the launcher refused.
* both: the configs equal the reference's field for field, and
  ``params_from_jax`` carries ``frontend`` / ``patch_proj`` over.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import loss_fn as j_loss_fn
from repro.models import model_init as j_model_init
from repro.models import prefill as j_prefill
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import (decode_step, forward, init_cache, loss_fn, model_init,
                                params_from_jax, prefill)
from repro_torch.models.transformer import check_family
from repro_torch.serving import ServeConfig, generate

TOL = dict(atol=1e-4, rtol=1e-4)
VLM, AUDIO = "internvl2-26b", "hubert-xlarge"
B, S = 2, 10  # the vlm's text prompt
SA = 64  # hubert's frames: two attention chunks of 32, neither skipped


def _pair(arch):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def vlm():
    jcfg, jp, tcfg, tp = _pair(VLM)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, tcfg.frontend_len, tcfg.frontend_dim)).astype(np.float32)
    return jcfg, jp, tcfg, tp, tokens, patches


@pytest.fixture(scope="module")
def audio():
    jcfg, jp, tcfg, tp = _pair(AUDIO)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, SA, tcfg.frontend_dim)).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab_size, (B, SA)).astype(np.int32)
    mask = (rng.random((B, SA)) < 0.7).astype(np.float32)
    return jcfg, jp, tcfg, tp, frames, targets, mask


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(j_smoke(arch))
    check_family(get_config(arch))
    check_family(get_smoke_config(arch))


def test_check_family_refuses_a_mismatched_frontend():
    with pytest.raises(ValueError, match="frontend"):
        check_family(dataclasses.replace(get_smoke_config(VLM), frontend="frame"))
    with pytest.raises(ValueError, match="frontend"):
        check_family(dataclasses.replace(get_smoke_config("qwen3-8b"), frontend="patch"))


@pytest.mark.parametrize("arch,leaf", [(VLM, "patch_proj"), (AUDIO, "frontend")])
def test_params_from_jax_carries_the_frontend(arch, leaf, vlm, audio):
    jp, tcfg, tp = (vlm if arch == VLM else audio)[1:4]
    np.testing.assert_array_equal(tp[leaf]["w"].numpy(), np.asarray(jp[leaf]["w"]))
    assert tp[leaf]["w"].shape == (tcfg.frontend_dim, tcfg.d_model)
    assert ("embed" in tp) == (arch == VLM)
    init = model_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert set(init) == set(tp)
    assert init[leaf]["w"].shape == tp[leaf]["w"].shape


# ---------------------------------------------------------------------------
# internvl2-26b (vlm)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm_prefill(vlm):
    jcfg, jp, tcfg, tp, tokens, patches = vlm
    n = tcfg.frontend_len + S + 2
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)},
                       j_init_cache(jcfg, B, n), jcfg)
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(tokens),
                              "patches": torch.from_numpy(patches)},
                         init_cache(tcfg, B, n, "cpu"), tcfg)
    return jl, jc, tl, tc


def test_vlm_prefill_logits_and_cache_match(vlm, vlm_prefill):
    tcfg = vlm[2]
    jl, jc, tl, tc = vlm_prefill
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    filled = tcfg.frontend_len + S
    for i, lc in enumerate(tc["body"]):
        assert int(lc["pos"]) == filled == int(np.asarray(jc["body"]["pos"])[i])
        for name in ("k", "v"):
            np.testing.assert_allclose(lc[name].numpy(), np.asarray(jc["body"][name][i]),
                                       **TOL)


def test_vlm_decode_steps_past_the_prefix_match(vlm, vlm_prefill):
    """Two teacher-forced steps at positions frontend_len + S and + 1: an
    off-by-frontend_len position would still give plausible tokens, so
    the logits are compared."""
    jcfg, jp, tcfg, tp = vlm[:4]
    _, jc, _, tc = vlm_prefill
    tc = {"body": [{k: v.clone() for k, v in lc.items()} for lc in tc["body"]]}
    rng = np.random.default_rng(2)
    for i in range(2):
        nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B, 1), tcfg.frontend_len + S + i, np.int32)
        jl, jc = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                                 positions=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_vlm_forward_and_loss_match(vlm):
    jcfg, jp, tcfg, tp, tokens, patches = vlm
    targets = np.roll(tokens, -1, axis=1)
    jb = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches),
          "targets": jnp.asarray(targets)}
    tb = {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(patches),
          "targets": torch.from_numpy(targets)}
    with torch.inference_mode():
        got = forward(tp, tb, tcfg)
        loss = loss_fn(tp, tb, tcfg)
    assert got.shape == (B, S, tcfg.vocab_size)  # the patch positions dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(j_forward(jp, jb, jcfg)), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss_fn(jp, jb, jcfg)), **TOL)


def test_vlm_greedy_generate_tokens_equal(vlm):
    jcfg, jp, tcfg, tp, tokens, patches = vlm
    want = j_generate(jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)},
                      jcfg, JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, {"tokens": tokens, "patches": patches}, tcfg,
                   ServeConfig(max_new_tokens=4, temperature=0.0), device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)


def test_vlm_launcher_serves_and_refusals(vlm, capsys):
    jcfg, jp, tcfg, tp, tokens, patches = vlm
    out = launcher.main(["--arch", VLM, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3", "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] tokens shape (2, 3)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ragged prefill covers token-only prompts"):
        launcher.main(["--arch", VLM, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "2", "--ragged", "--device", "cpu"])
    with pytest.raises(ValueError, match="ragged prefill covers token-only prompts"):
        generate(tp, {"tokens": tokens, "patches": patches, "lengths": [3, S]}, tcfg,
                 ServeConfig(max_new_tokens=2, temperature=0.0), device="cpu")
    with pytest.raises(AssertionError, match="--engine"):
        launcher.main(["--arch", VLM, "--smoke", "--engine", "--device", "cpu"])
    from repro_torch.serving.scheduler import ScheduledEngine

    with pytest.raises(ValueError, match="not the vlm family"):
        ScheduledEngine(tp, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# hubert-xlarge (audio encoder)
# ---------------------------------------------------------------------------


def test_audio_layers_match_reference(audio):
    """The gelu MLP (tanh approximation, jax.nn.gelu's default) and the
    non-causal attention over two chunks, alone, on the first layer."""
    from repro.models.attention import attn_apply as j_attn
    from repro.models.layers import mlp_apply as j_mlp
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.layers import mlp

    jcfg, jp, tcfg, tp = audio[:4]
    assert tcfg.mlp_act == "gelu" and not tcfg.causal
    x = np.random.default_rng(3).standard_normal((B, SA, tcfg.d_model)).astype(np.float32)
    jl0 = jax.tree.map(lambda a: a[0], jp["stack"]["body"])
    tl0 = tp["stack"]["body"][0]
    with torch.inference_mode():
        got = mlp(tl0["ffn"], torch.from_numpy(x), "gelu")
        att, _ = attn_apply(tl0["attn"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_mlp(jl0["ffn"], jnp.asarray(x), "gelu")),
                               **TOL)
    want, _ = j_attn(jl0["attn"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(att.numpy(), np.asarray(want), **TOL)
    # non-causal: the first position sees the last
    x2 = x.copy()
    x2[:, -1] += 1.0
    with torch.inference_mode():
        att2, _ = attn_apply(tl0["attn"], torch.from_numpy(x2), tcfg)
    assert not torch.equal(att2[:, 0], att[:, 0])


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
def test_audio_forward_and_loss_match(audio, masked):
    jcfg, jp, tcfg, tp, frames, targets, mask = audio
    jb = {"frames": jnp.asarray(frames), "targets": jnp.asarray(targets)}
    tb = {"frames": torch.from_numpy(frames), "targets": torch.from_numpy(targets)}
    if masked:
        jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    with torch.inference_mode():
        got = forward(tp, tb, tcfg)
        loss = loss_fn(tp, tb, tcfg)
    assert got.shape == (B, SA, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_forward(jp, jb, jcfg)), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss_fn(jp, jb, jcfg)), **TOL)


def test_audio_has_no_decode(audio):
    jcfg, jp, tcfg, tp, frames, targets, mask = audio
    with pytest.raises(ValueError, match="encoder-only"):
        init_cache(tcfg, B, 8, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        generate(tp, {"tokens": np.zeros((B, 4), np.int32)}, tcfg, ServeConfig(),
                 device="cpu")
    with pytest.raises(AssertionError, match="encoder-only: no decode"):
        launcher.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])
    from repro_torch.serving.scheduler import ScheduledEngine

    with pytest.raises(ValueError, match="not the audio family"):
        ScheduledEngine(tp, tcfg, device="cpu")
