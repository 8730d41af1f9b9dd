"""CPU parity of the port's training path against the JAX package.

* The gradient of every differentiable library op (``topk``, ``sort``
  with and without ``payload=``, ``merge``, ``merge_k``,
  ``median_of_lists``) on the schedule executor, the lax route, the
  kernel route through its plain versions (the reference's ``pallas``)
  and the auto route, against ``jax.grad`` of the same op on the same
  backend: distinct values, so every route's gradient is one exact
  scatter (``rtol=0``, ``atol=0``). ``topk``'s gradient was broken on
  every route (a shrinking gather's cotangent took the output's shape;
  the fused rung had no VJP); ``test_topk_gradient_faults`` holds each
  failing case.
* ``opt_update`` and ``schedule`` over three steps against
  ``repro.optim`` (float32, rtol 1e-6: the reference and the port round
  the same operations; the global norm sums its leaves in another order).
* ``flash_attention``'s gradients against the reference's and against a
  naive softmax (causal with a ``q_offset``, chunks of 8; rtol 2e-3 as
  ``tests/test_models.py``).
* ``loss_fn``'s value and every parameter's gradient against
  ``jax.value_and_grad(repro.models.loss_fn)`` on the smoke configs of
  qwen3-8b, qwen3-moe-30b-a3b (the router's gradient included: the top-k
  on the schedule executor), mamba2-780m and hubert-xlarge with a mask,
  in float32 with the reference's weights (``params_from_jax``):
  rtol = atol = 1e-4 (the packages sum in other orders).
* ``remat`` ``full`` and ``dots`` give ``none``'s loss and gradients,
  bit for bit (the recompute runs the same operations).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as j_smoke
from repro.models import loss_fn as j_loss_fn
from repro.models import model_init as j_model_init
from repro.models.attention import flash_attention as j_flash
from repro.optim import OptConfig as JOptConfig
from repro.optim import opt_init as j_opt_init
from repro.optim import opt_update as j_opt_update
from repro.optim import schedule as j_schedule

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import loss_fn, model_init, params_from_jax
from repro_torch.models.attention import flash_attention
from repro_torch.models.moe import router_topk
from repro_torch.optim import OptConfig, opt_init, opt_update, schedule
from repro_torch.optim.adamw import leaves

B_RNG = np.random.default_rng(0)
X = B_RNG.standard_normal((4, 64)).astype(np.float32)
PL = B_RNG.standard_normal((4, 64)).astype(np.float32)
WX = B_RNG.standard_normal((4, 64)).astype(np.float32)
WK = B_RNG.standard_normal((4, 8)).astype(np.float32)
A = np.sort(B_RNG.standard_normal((4, 32)).astype(np.float32), -1)
C = np.sort(B_RNG.standard_normal((4, 32)).astype(np.float32), -1)
LS = [np.sort(B_RNG.standard_normal((4, 16)).astype(np.float32), -1) for _ in range(3)]
WM = B_RNG.standard_normal((4, 48)).astype(np.float32)
MED = [np.sort(B_RNG.standard_normal((4, 7)).astype(np.float32), -1) for _ in range(3)]
WMED = B_RNG.standard_normal((4,)).astype(np.float32)

#: the port's backend -> the reference's
BACKENDS = {"schedule": "schedule", "lax": "lax", "cuda": "pallas", "auto": "auto"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-width tensors on one intra-op thread: the suite runs a worker
    a core, and a pool of threads a worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(a):
    return torch.from_numpy(a)


def _ops(b, jb):
    """(name, reference loss of the inputs, port loss, inputs) per op."""
    return {
        "topk": (lambda v: jnp.sum(repro.topk(v, 8, backend=jb)[0] * WK),
                 lambda v: (repro_torch.topk(v, 8, backend=b)[0] * _w(WK)).sum(), [X]),
        "topk_unsafe": (
            lambda v: jnp.sum(repro.topk(v, 8, backend=jb, nan_policy="unsafe")[0] * WK),
            lambda v: (repro_torch.topk(v, 8, backend=b, nan_policy="unsafe")[0]
                       * _w(WK)).sum(), [X]),
        "topk_stable": (
            lambda v: jnp.sum(repro.topk(v, 8, backend=jb, stable=True)[0] * WK),
            lambda v: (repro_torch.topk(v, 8, backend=b, stable=True)[0] * _w(WK)).sum(),
            [X]),
        "topk_payload": (
            lambda v, p: jnp.sum(repro.topk(v, 8, backend=jb, payload=p)[2] * WK),
            lambda v, p: (repro_torch.topk(v, 8, backend=b, payload=p)[2] * _w(WK)).sum(),
            [X, PL]),
        "sort": (lambda v: jnp.sum(repro.sort(v, backend=jb) * WX),
                 lambda v: (repro_torch.sort(v, backend=b) * _w(WX)).sum(), [X]),
        "sort_payload": (
            lambda v, p: jnp.sum(repro.sort(v, backend=jb, payload=p)[1] * WX),
            lambda v, p: (repro_torch.sort(v, backend=b, payload=p)[1] * _w(WX)).sum(),
            [X, PL]),
        "merge": (lambda p, q: jnp.sum(repro.merge(p, q, backend=jb) * WX),
                  lambda p, q: (repro_torch.merge(p, q, backend=b) * _w(WX)).sum(), [A, C]),
        "merge_k": (lambda *v: jnp.sum(repro.merge_k(v, backend=jb) * WM),
                    lambda *v: (repro_torch.merge_k(v, backend=b) * _w(WM)).sum(), LS),
        "median_of_lists": (
            lambda *v: jnp.sum(repro.median_of_lists(v, backend=jb) * WMED),
            lambda *v: (repro_torch.median_of_lists(v, backend=b) * _w(WMED)).sum(), MED),
    }


#: every op on every named route; the auto route for topk (on the CPU the
#: other ops' auto route is one of the named ones, on both sides)
SWEEP = [(op, b) for b in BACKENDS for op in _ops(b, BACKENDS[b])
         if not (b == "cuda" and op == "topk_stable")  # the reference's pallas refuses it
         and (b != "auto" or op.startswith("topk"))]


@pytest.mark.parametrize("op,backend", SWEEP)
def test_gradient_sweep_matches_jax(op, backend):
    jfn, tfn, arrs = _ops(backend, BACKENDS[backend])[op]
    # jit: one XLA compile, where eager dispatch compiles every op of a network
    want = jax.jit(jax.grad(jfn, argnums=tuple(range(len(arrs)))))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]
    tfn(*ts).backward()
    for t, g in zip(ts, want):  # an input the loss does not reach has no grad: zeros
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(g))


@pytest.mark.parametrize("backend", ["schedule", "lax", "cuda", "auto"])
def test_topk_gradient_faults(backend):
    """The faults the sweep found: ``backward()`` raised an out-of-bounds
    index on the schedule and lax routes (the cotangent of a shrinking
    gather had the output's shape), and the default and cuda routes
    returned values with no ``grad_fn``. Each route's gradient of the
    sum of the top 8 of (4, 64) is 32 ones, as ``jax.grad`` gives."""
    x = torch.from_numpy(X.copy()).requires_grad_()
    vals, _ = repro_torch.topk(x, 8, backend=backend)
    assert vals.grad_fn is not None
    vals.sum().backward()
    want = np.zeros_like(X)
    np.put_along_axis(want, np.argsort(-X, axis=-1)[:, :8], 1.0, axis=-1)
    np.testing.assert_array_equal(x.grad.numpy(), want)


def test_router_gradient_flows():
    """The MoE router's top-k (the schedule executor) passes its gates'
    gradient to the logits; it raised before the repair."""
    logits = torch.from_numpy(B_RNG.standard_normal((16, 8)).astype(np.float32))
    logits.requires_grad_()
    gates, _ = router_topk(logits, 4, 8)
    (gates * torch.arange(4.0)).sum().backward()
    assert torch.isfinite(logits.grad).all() and logits.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_opt_update_and_schedule_match_reference():
    rng = np.random.default_rng(1)
    # one shape: the eager reference compiles each op once
    shapes = {"w": (8, 5), "nested": {"b": (8, 5), "lst": [(8, 5), (8, 5)]}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                            shapes, is_leaf=lambda s: isinstance(s, tuple))

    p0 = draw(1.0)
    jo = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    to = OptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = jax.tree.map(jnp.asarray, p0)
    js = j_opt_init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = opt_init(tp)
    for step in range(3):  # eager: jit would fuse the moments' products (FMA)
        g = draw(3.0 if step == 1 else 0.1)  # step 1 clips (norm > 1)
        jp, js, jm = j_opt_update(jax.tree.map(jnp.asarray, g), js, jp, jo)
        tp, ts, tm = opt_update(jax.tree.map(torch.from_numpy, g), ts, tp, to)
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        for key in ("mu", "nu"):
            for a, b in zip(leaves(ts[key]), jax.tree.leaves(js[key])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for s in range(8):
        np.testing.assert_allclose(float(schedule(s, to)), float(j_schedule(s, jo)), rtol=1e-6)
        assert ts["mu"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _naive(q, k, v, causal, q_offset, scale):
    s = torch.einsum("bqhgd,bkhd->bqhgk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1])
        mask = qpos[:, None] >= torch.arange(k.shape[1])[None, :]
        s = s.masked_fill(~mask[None, :, None, None, :], -1e30)
    return torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal,q_offset,sq", [(True, 0, 32), (True, 8, 24), (False, 0, 16)])
def test_flash_attention_gradients(causal, q_offset, sq):
    rng = np.random.default_rng(2)
    b, sk, hkv, g, d = 2, 32, 2, 2, 16
    q = rng.standard_normal((b, sq, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, hkv, g, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(
        j_flash(*a, causal=causal, q_offset=q_offset, chunk=8) * w), argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, q_offset=q_offset, chunk=8)
    (out * _w(w)).sum().backward()
    ns = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    ref = _naive(*ns, causal, q_offset, scale)
    (ref * _w(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=2e-3, atol=2e-3)
    for t, jg, n in zip(ts, want, ns):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(t.grad.numpy(), n.grad.numpy(), rtol=2e-3, atol=2e-3)


def test_flash_attention_forward_bits_unchanged_by_grad():
    """Under autograd the forward is the same function: bit-equal output."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    plain = flash_attention(q, k, v, causal=True, chunk=4)
    graded = flash_attention(q.requires_grad_(), k, v, causal=True, chunk=4)
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())


# ---------------------------------------------------------------------------
# loss_fn gradients of whole stacks
# ---------------------------------------------------------------------------

ARCHS = ["qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-780m", "hubert-xlarge"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b, s = 2, 32
    targets = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
                "targets": targets, "mask": (rng.random((b, s)) < 0.7).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": targets}


@pytest.fixture(scope="module", params=ARCHS)
def stack(request):
    arch = request.param
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp, _ = j_model_init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(tcfg, 4)
    jloss, jgrads = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=2)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu", torch.float32)
    return arch, tcfg, tp, batch, float(jloss), want, _grads(tp, batch, tcfg)


def _grads(tp, batch, cfg, remat="none"):
    ps = leaves(tp)
    for t in ps:
        t.requires_grad_(True)
        t.grad = None
    loss = loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, remat=remat)
    loss.backward()
    out = [t.grad.clone() for t in ps]
    loss = loss.detach()
    for t in ps:
        t.requires_grad_(False)
        t.grad = None
    return float(loss), out


def test_loss_fn_gradients_match_reference(stack):
    arch, tcfg, tp, batch, jloss, want, (loss, got) = stack
    np.testing.assert_allclose(loss, jloss, **TOL)
    wl = leaves(want)
    assert len(got) == len(wl)
    for g, w in zip(got, wl):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    if tcfg.moe is not None:  # the router learns through the schedule executor's top-k
        router = tp["stack"]["body"][0]["ffn"]["router"]["w"]
        idx = [i for i, t in enumerate(leaves(tp)) if t is router][0]
        assert got[idx].abs().sum() > 0


def test_remat_gradients_equal_none(stack):
    arch, tcfg, tp, batch, _, _, (loss0, g0) = stack
    for remat in ("full", "dots"):
        loss, g = _grads(tp, batch, tcfg, remat)
        assert loss == loss0, remat
        for a, b in zip(g, g0):
            assert torch.equal(a, b), remat


def test_master_weights_and_par():
    """``model_init`` draws the same values in any dtype (float32 masters
    for training, ``cfg.dtype`` for serving); a ``par`` that is not a
    ``Parallelism`` raises."""
    cfg = get_smoke_config("qwen3-8b")
    serve = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    master = model_init(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32)
    assert all(t.dtype == torch.float32 for t in leaves(master))
    for a, b in zip(leaves(serve), leaves(master)):
        assert a.dtype == getattr(torch, cfg.dtype)
        assert torch.equal(a, b.to(a.dtype))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "targets": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(TypeError, match="Parallelism"):
        loss_fn(master, batch, cfg, par=object())
    with pytest.raises(ValueError, match="remat"):
        loss_fn(master, batch, cfg, remat="some")
