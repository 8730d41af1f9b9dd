"""CPU parity of the port's MoE family against the JAX package.

The smoke config of qwen3-moe-30b-a3b (2 layers, d_model 64, 8 experts,
top-2, router block 4) in float32, as it is and with a shared expert and
a leading dense layer; the reference's weights carried over with
``params_from_jax``.

* ``router_topk`` on identical logits (many exact ties): expert ids
  bit-equal, gates to 1e-6.
* ``moe_ffn_local`` with the scatter and the sorted dispatch and ragged
  ``expert_capacities`` (the reference's ``tests/test_segmented.py``
  cases), on inputs whose router logits are exact in both packages
  (multiples of 1/4 times multiples of 1/4), so that the ids cannot flip:
  outputs to atol = rtol = 1e-4; in the port alone, the sorted dispatch's
  positions and outputs bit-equal to the scatter's.
* The whole stack: forward, prefill and decode logits, ragged prefill,
  greedy ``generate``, and a decode step at B = 9, where the port pads
  the rows to 16 and the capacity must still count 9: logits to 1e-4,
  tokens equal. The two packages sum the router product in different
  orders, so a near-tie between a token's k-th and (k+1)-th logit could
  flip an expert; each of those tests records the smallest such gap and
  names it when the logits differ.
* The refusals: what expert parallelism still refuses (ragged
  capacities, an EP axis that does not divide the experts), a MoE stack
  with a leading dense layer through the scheduler; the launcher at smoke width on the CPU. MLA
  (deepseek-v2-lite) is held by ``tests/test_torch_mla.py``, the SSM and
  hybrid families by ``tests/test_torch_ssm.py``, the vlm and audio
  frontends by ``tests/test_torch_frontends.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import model_init as j_model_init
from repro.models import moe as j_moe
from repro.models import prefill as j_prefill
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import generate as j_generate

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.launch import serve as launcher
from repro_torch.models import (decode_step, forward, init_cache, model_init,
                                params_from_jax, prefill)
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import _map
from repro_torch.serving import ServeConfig, generate
from repro_torch.streaming import cache as tcache

ARCH = "qwen3-moe-30b-a3b"
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


def _variant(cfg, name):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if name == "shared_dense":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared_experts=1, first_dense_layers=1))
    return cfg


@pytest.fixture(scope="module", params=["base", "shared_dense"])
def models(request):
    """(reference cfg, reference params, port cfg, port params, tokens)."""
    jcfg = _variant(j_smoke(ARCH), request.param)
    tcfg = _variant(get_smoke_config(ARCH), request.param)
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return request.param, jcfg, jp, tcfg, tp, tokens


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


def _close(got, want, gaps):
    np.testing.assert_allclose(got, np.asarray(want), **TOL,
                               err_msg=f"smallest router gap {min(gaps, default=None)}")


# ---------------------------------------------------------------------------
# the layer: router, dispatch, expert products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,e,k,block", [(16, 8, 2, 4), (24, 128, 8, 32)])
def test_router_topk_matches_reference(t, e, k, block):
    rng = np.random.default_rng(e)
    for logits in ((rng.integers(-6, 7, (t, e)) * 0.5).astype(np.float32),
                   rng.standard_normal((t, e)).astype(np.float32)):
        jg, ji = j_moe.router_topk(jnp.asarray(logits), k, block)
        tg, ti = t_moe.router_topk(torch.from_numpy(logits), k, block)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)


def _layer_cfgs(**moe):
    """One MoE layer's config in each package (d_model 16, 4 experts, top-2)."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab_size=64, dtype="float32")
    base = dict(n_experts=4, top_k=2, d_expert=8, router_block=4)
    return (JModelConfig(moe=JMoEConfig(**base, **moe), **kw),
            ModelConfig(moe=MoEConfig(**base, **moe), **kw))


def _exact_router_layer(jcfg, t, seed):
    """Reference MoE weights with a router of multiples of 1/4 and tokens of
    multiples of 1/4: the router logits are exact in float32 in both
    packages. Returns (reference params, port params, x (T, D))."""
    rng = np.random.default_rng(seed)
    jp, _ = j_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    jp["router"]["w"] = (rng.integers(-4, 5, jp["router"]["w"].shape) * 0.25
                         ).astype(np.float32)
    x = (rng.integers(-6, 7, (t, jcfg.d_model)) * 0.25).astype(np.float32)
    return jp, _map(jp, lambda a: torch.from_numpy(np.array(a, np.float32))), x


#: (dispatch, capacity factor, expert capacities, tokens): the default
#: capacity (choices dropped), the reference's uniform / ragged cases
LAYER_CASES = [
    ("scatter", 1.25, None, 12),
    ("sorted", 1.25, None, 12),
    ("sorted", 8.0, None, 12),
    ("sorted", 8.0, (48,) * 4, 12),
    ("scatter", 8.0, (40,) * 4, 10),
    ("scatter", 8.0, (4, 8, 4, 16), 10),
    ("sorted", 8.0, (4, 0, 2, 16), 10),
]


@pytest.mark.parametrize("dispatch,cf,caps,t", LAYER_CASES)
def test_moe_ffn_local_matches_reference(dispatch, cf, caps, t):
    jcfg, tcfg = _layer_cfgs(dispatch=dispatch, capacity_factor=cf, expert_capacities=caps)
    jp, tp, x = _exact_router_layer(jcfg, t, seed=t + len(LAYER_CASES))
    want = j_moe.moe_ffn_local(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    got = t_moe.moe_ffn_local(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,e", [(64, 128), (300, 8), (7, 4)])
def test_sorted_positions_equal_cumsum(n, e):
    flat_e = torch.from_numpy(np.random.default_rng(n).integers(0, e, n).astype(np.int32))
    got = t_moe._positions_sorted(flat_e, e)
    want = t_moe._positions_cumsum(flat_e, e)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


def test_sorted_dispatch_bit_equal_to_scatter():
    _, scatter = _layer_cfgs(capacity_factor=1.0)
    _, srt = _layer_cfgs(capacity_factor=1.0, dispatch="sorted")
    jcfg, _ = _layer_cfgs()
    _, tp, x = _exact_router_layer(jcfg, 20, seed=3)
    x = torch.from_numpy(x)
    a, b = t_moe.moe_ffn_local(tp, x, scatter), t_moe.moe_ffn_local(tp, x, srt)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_expert_parallel_arguments_raise():
    """What expert parallelism still refuses, before any collective runs:
    ragged ``expert_capacities`` (the reference asserts it), an EP axis
    that does not divide the experts, a padded decode batch. The EP paths
    themselves run in ``tests/test_torch_parallel.py``."""
    from repro_torch.parallel import make_parallelism

    jcfg, tcfg = _layer_cfgs()
    _, caps = _layer_cfgs(capacity_factor=8.0, expert_capacities=(8,) * 4)
    _, tp, x = _exact_router_layer(jcfg, 4, seed=1)
    x = torch.from_numpy(x)
    with pytest.raises(ValueError, match="expert_capacities is a non-EP feature"):
        t_moe.moe_ffn_local(tp, x, caps, axis_name="model", ep_size=2)
    with pytest.raises(ValueError, match="4 experts do not split over an EP axis of 3"):
        t_moe.moe_ffn_local(tp, x, tcfg, axis_name="model", ep_size=3, ep_psum=True)

    class Mesh:  # the attributes the spec functions read
        axis_names = ("data", "model")

        def __init__(self, tp):
            self.shape = {"data": 1, "model": tp}

    with pytest.raises(ValueError, match="do not split over an EP axis of 3"):
        t_moe.moe_apply(tp, x[None], tcfg, par=make_parallelism(Mesh(3)))
    with pytest.raises(ValueError, match="expert_capacities is a non-EP feature"):
        t_moe.moe_apply(tp, x[None], caps, par=make_parallelism(Mesh(2)))
    with pytest.raises(ValueError, match="rows="):
        t_moe.moe_apply(tp, x[None], tcfg, rows=1, par=make_parallelism(Mesh(2)))


# ---------------------------------------------------------------------------
# the stack: forward, prefill, decode, generate
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    from repro.configs import get_config as j_get_config

    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(j_smoke(ARCH))


def test_forward_logits_match(models, router_gaps):
    name, jcfg, jp, tcfg, tp, tokens = models
    want = j_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.inference_mode():
        got = forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert ("head" in tp["stack"]) == (name == "shared_dense")
    _close(got.numpy(), want, router_gaps)


def test_prefill_and_decode_logits_match(models, router_gaps):
    """Prefill, then two teacher-forced decode steps."""
    _, jcfg, jp, tcfg, tp, tokens = models
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, j_init_cache(jcfg, B, S + 2), jcfg)
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(tokens)},
                         init_cache(tcfg, B, S + 2, "cpu"), tcfg)
        _close(tl.numpy(), jl, router_gaps)
        rng = np.random.default_rng(1)
        for i in range(2):
            nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
            pos = np.full((B, 1), S + i, np.int32)
            jl, jc = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
            tl, tc = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                                 positions=torch.from_numpy(pos))
            _close(tl.numpy(), jl, router_gaps)


def test_ragged_prefill_logits_match(models, router_gaps):
    """The right pads route and take capacity, as in the reference; every
    layer cache, the head's too, continues from each row's length."""
    name, jcfg, jp, tcfg, tp, tokens = models
    lens = np.array([4, S], np.int32)
    toks = tokens.copy()
    toks[0, 4:] = 0
    jl, _ = j_prefill(jp, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, B, S),
                      jcfg, lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)},
                         init_cache(tcfg, B, S, "cpu"), tcfg, lengths=torch.from_numpy(lens))
    _close(tl.numpy(), jl, router_gaps)
    for lc in tc.get("head", []) + tc["body"]:
        assert lc["pos"].tolist() == lens.tolist()
    assert len(tc.get("head", [])) == (1 if name == "shared_dense" else 0)


def test_greedy_generate_tokens_equal(models):
    _, jcfg, jp, tcfg, tp, tokens = models
    lens = np.array([6, S], np.int32)
    toks = tokens.copy()
    toks[0, 6:] = 0
    want = j_generate(jp, {"tokens": jnp.asarray(toks), "lengths": lens}, jcfg,
                      JServeConfig(max_new_tokens=4, temperature=0.0))["tokens"]
    got = generate(tp, {"tokens": toks, "lengths": lens}, tcfg,
                   ServeConfig(max_new_tokens=4, temperature=0.0), device="cpu")["tokens"]
    np.testing.assert_array_equal(got, want)


def test_decode_at_b9_counts_the_real_rows(models, router_gaps, monkeypatch):
    """B = 9 pads to 16 rows; the capacity is the reference's for 9 tokens
    (4 at 8 experts, top-2), and the step drops choices past it (rows 0-4
    are one request five times, so their experts get five choices each),
    so a capacity counted over the padded rows (8) would change the
    logits."""
    _, jcfg, jp, tcfg, tp, _ = models
    b, s = 9, 4
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    nxt = np.random.default_rng(10).integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    toks[1:5], nxt[1:5] = toks[0], nxt[0]
    pos = np.full((b, 1), s, np.int32)
    _, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, b, s + 1), jcfg)
    want, _ = j_decode_step(jp, jnp.asarray(nxt), jc, jcfg, positions=jnp.asarray(pos))
    most = []
    real = t_moe._positions_cumsum

    def recorded(flat_e, n_experts):
        out = real(flat_e, n_experts)
        most.append(int(out[:b * tcfg.moe.top_k].max()))
        return out

    with torch.inference_mode():
        _, tc = prefill(tp, {"tokens": torch.from_numpy(toks)},
                        init_cache(tcfg, b, s + 1, "cpu"), tcfg)
        monkeypatch.setattr(t_moe, "_positions_cumsum", recorded)
        got, _ = decode_step(tp, torch.from_numpy(nxt), tc, tcfg,
                             positions=torch.from_numpy(pos))
    assert max(most) >= 4, f"no choice past the capacity of 4: {most}"
    _close(got.numpy(), want, router_gaps)


# ---------------------------------------------------------------------------
# refusals and the launcher
# ---------------------------------------------------------------------------


def test_scheduler_refuses_moe():
    """The scheduler serves MoE (``tests/test_torch_sched_moe.py``) but, as
    the reference, refuses a stack whose cache has a second group: here
    the leading dense layer's ``head``."""
    from repro_torch.serving.scheduler import ScheduledEngine

    cfg = get_smoke_config(ARCH)
    ScheduledEngine(model_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg,
                    device="cpu")
    cfg = _variant(cfg, "shared_dense")
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match=r"paged slots need a homogeneous attention stack, "
                                         r"got cache groups \['body', 'head'\]"):
        ScheduledEngine(params, cfg, device="cpu")


def test_launcher_serves_moe_on_cpu_when_asked(capsys):
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3", "--ragged", "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] tokens shape (2, 3)" in capsys.readouterr().out
