"""Sharded parameters through the model (``par=`` through ``forward`` /
``loss_fn`` / ``prefill`` / ``decode_step`` / ``generate`` / ``train``),
against the same calls without ``par`` and against the reference.

* ``param_specs`` of all ten configs: on (16, 16) and (2, 16, 16)
  stand-in meshes ``build_param_pspecs`` of the port's tree (shapes from
  ``model_init(device="meta")``, one dict a layer) equals the reference's
  of ``jax.eval_shape(model_init)``, leaf for leaf, each stacked leaf's
  leading layer entry dropped.
* One 4-rank gloo group over a (2, 2) mesh, started once for the module
  (``forkserver``, as ``tests/test_torch_parallel_ranks.py`` starts its
  groups; this module imports no JAX at import, so the ranks never do),
  runs every case below; each test reads its case:

  - the dense, MoE (capacity 4.0, as ``tests/test_sharding.py``), MLA,
    SSM, hybrid, vlm and audio smoke configs in float32: the sharded
    ``loss_fn`` within 1e-5 of ``par=None``'s, every gradient (after the
    reduce-scatter to its parameter's placement) within 2e-5 of
    ``par=None``'s, and every sharded leaf's local shape the full shape
    over the axis sizes on its sharded dims;
  - the reference's ``test_sharded_moe_loss_matches_local`` case
    (qwen3-moe smoke, the reference's own ``model_init`` weights,
    capacity 4.0, its 4 x 32 batch) in float32: the port's sharded
    ``loss_fn`` within 2e-3 (that test's tolerance) of the reference's
    local loss and within 1e-5 of the port's ``par=None`` loss. (In the
    smoke config's bf16 the port's unsharded loss is itself 1.5e-2 from
    the reference's: the packages round in other orders. In float32 the
    two unsharded losses are equal.)
  - greedy and sampled ``generate(par)`` tokens of the dense smoke config
    (float32) equal to ``par=None``'s, and greedy of the MoE and of MLA;
  - ``train(par)`` with ``fail_at_step`` resuming to ``par=None``'s
    losses (float32, within 1e-5), and the checkpoint it saved on (2, 2)
    restored with ``par=None`` bit-equal to the trained parameters;
  - ``constrain`` on the gloo mesh: the placements of its spec and this
    rank's block;
  - on a (1, 4) mesh of the same ranks, attention's layouts where the kv
    heads do not divide the TP axis (``TP4_CFGS``: by heads, by query
    rows with ``wo`` by rows or replicated): loss and gradients as above,
    and ``generate`` (prefill in those layouts, decode over a cache
    sharded on ``head_dim``, MLA's latent cache split four ways) equal to
    ``par=None``'s tokens;
  - ``model_init(par=)`` placing a part at a time, bit-equal to
    ``shard_params`` of the full draw; ``sample_topk(par=)`` on tie-rich
    logits at TP = 2 drawing the tokens it draws without ``par``.
"""
import dataclasses
import datetime
import os
import shutil
import tempfile
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
MESH = (2, 2)
LOSS_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "mamba2-780m",
              "zamba2-2.7b", "internvl2-26b", "hubert-xlarge")
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
REF_MOE_ATOL = 2e-3  # tests/test_sharding.py's


#: smoke configs whose heads meet a TP axis of 4 in each of attention's
#: layouts: kv heads (2) and groups (2) do not divide it but the heads (4)
#: do (chatglm3-6b's with qkv biases and half-width RoPE); neither do the
#: heads (6), their flat width (96) does; nor that (5 x 6). The SSM's: 8
#: heads split; 2 heads of 64 do not,
#: nor does the fused input projection (290 columns), so the state cache
#: splits over d_state
TP4_CFGS = {"qwen3-8b": {}, "chatglm3-6b": {}, "qwen1.5-32b h6": {"n_heads": 6},
            "qwen3-8b h5": {"n_heads": 5, "n_kv_heads": 1, "d_head": 6},
            "mamba2-780m": {}, "mamba2-780m hd64": {"ssm": {"head_dim": 64}}}


def _cfg(arch: str, dtype: str = "float32"):
    from repro_torch.configs import get_smoke_config

    arch, _, variant = arch.partition(" ")
    cfg = get_smoke_config(arch)
    fields = TP4_CFGS.get(f"{arch} {variant}" if variant else "", {})
    fields = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
              for k, v in fields.items()}
    cfg = dataclasses.replace(cfg, dtype=dtype, **fields)
    if cfg.moe is not None:  # capacity is per shard under EP: no drops either way
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    return cfg


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        out = {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim)
                                             ).astype(np.float32)
    out["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _init(cfg):
    from repro_torch.models import model_init

    return model_init(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32)


# ---------------------------------------------------------------------------
# the cases, run on every rank: (par, inputs) -> numpy-able results
# ---------------------------------------------------------------------------


def _loss_case(arch, mesh=None):
    def run(par, inputs):
        if mesh is not None:
            par = inputs["pars"][mesh]
        from torch.distributed.tensor import DTensor

        from repro_torch.models import loss_fn, param_specs
        from repro_torch.optim.adamw import leaves
        from repro_torch.parallel import axis_sizes, shard_params

        cfg = _cfg(arch)
        batch = _batch(cfg)
        p0 = _init(cfg)
        l0s = leaves(p0)
        for t in l0s:
            t.requires_grad_(True)
        loss0 = loss_fn(p0, batch, cfg)
        g0 = torch.autograd.grad(loss0, l0s, allow_unused=True)
        sp = shard_params(_init(cfg), par, param_specs(cfg))
        sl = leaves(sp)
        sizes = list(axis_sizes(par.mesh).values())
        shapes_ok, n_sharded = True, 0
        for t, full in zip(sl, l0s):
            want = list(full.shape)
            for pl, n in zip(t.placements, sizes):
                if pl.is_shard():
                    want[pl.dim] //= n
                    n_sharded += n > 1
            shapes_ok &= list(t.to_local().shape) == want
        for t in sl:
            t.requires_grad_(True)
        loss1 = loss_fn(sp, batch, cfg, par=par)
        g1 = torch.autograd.grad(loss1, sl, allow_unused=True)
        gerr = 0.0
        for a, b, prm in zip(g0, g1, sl):
            if a is None and b is None:
                continue
            if isinstance(b, DTensor) and b.placements != prm.placements:
                b = b.redistribute(placements=prm.placements)
            gerr = max(gerr, float((a - b.full_tensor()).abs().max()))
        return {"loss0": float(loss0), "loss1": float(loss1), "gerr": gerr,
                "shapes_ok": bool(shapes_ok), "n_sharded": n_sharded}
    return run


def _ref_moe_case(par, inputs):
    """The reference's weights (converted) and batch: (sharded, unsharded)."""
    from repro_torch.models import loss_fn, param_specs
    from repro_torch.parallel import shard_params

    cfg = _cfg("qwen3-moe-30b-a3b")
    batch = {k: torch.from_numpy(inputs[f"ref_moe_{k}"]) for k in ("tokens", "targets")}
    plain = float(loss_fn(_tree(inputs["ref_moe_params"]), batch, cfg))
    sp = shard_params(_tree(inputs["ref_moe_params"]), par, param_specs(cfg))
    return float(loss_fn(sp, batch, cfg, par=par)), plain


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v) for v in t]
    return torch.from_numpy(np.array(t))


def _generate_case(par, inputs):
    from repro_torch.models import model_init, param_specs
    from repro_torch.parallel import shard_params
    from repro_torch.serving import ServeConfig, generate

    out = {}
    for arch, temps in (("qwen3-8b", (0.0, 0.8)), ("qwen3-moe-30b-a3b", (0.0,)),
                        ("deepseek-v2-lite-16b", (0.0,))):
        cfg = _cfg(arch)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
        for temp in temps:
            sc = ServeConfig(max_new_tokens=3, top_k=8, temperature=temp, seed=3)

            def init():
                return model_init(torch.Generator().manual_seed(0), cfg, "cpu")

            want = generate(init(), {"tokens": tokens}, cfg, sc, device="cpu")["tokens"]
            sp = shard_params(init(), par, param_specs(cfg))
            got = generate(sp, {"tokens": tokens}, cfg, sc, device="cpu", par=par)["tokens"]
            out[f"{arch} t={temp}"] = (want, got)
    return out


def _train_case(par, inputs):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig
    from repro_torch.models import model_init
    from repro_torch.optim import OptConfig, opt_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import full_params
    from repro_torch.runtime import TrainConfig, train

    cfg = _cfg("qwen3-8b")
    dc = DataConfig(seq_len=16, global_batch=4)
    oc = OptConfig(warmup_steps=2, total_steps=10)
    d = inputs["ckpt_dir"]
    rank = dist.get_rank()
    ref = train(cfg, dc, TrainConfig(steps=6, ckpt_every=2, ckpt_dir=f"{d}/plain{rank}"), oc,
                device="cpu")
    tc = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=f"{d}/sharded")
    first = None
    try:
        train(cfg, dc, tc, oc, par=par, fail_at_step=3, device="cpu")
    except RuntimeError as e:
        first = str(e)
    out = train(cfg, dc, tc, oc, par=par, device="cpu")
    full = full_params(out["params"])
    tmpl = model_init(None, cfg, "cpu", torch.float32)
    (restored, _), extra = CheckpointManager(f"{d}/sharded").restore(
        6, (tmpl, opt_init(tmpl)))
    same = all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(full)))
    return {"ref": ref["losses"], "resumed": out["losses"], "fault": first,
            "restored_equal": bool(same), "step": extra["step"]}


def _tp4_generate_case(par, inputs):
    """Tokens on (1, 4) against ``par=None``'s, prompts of 10: sampled by
    query heads, greedy by query rows (its last rank's rows padded), MLA's
    latent cache split four ways, the SSM's caches by heads (zamba2's
    hybrid stack) and over d_state."""
    from repro_torch.models import model_init
    from repro_torch.serving import ServeConfig, generate

    par = inputs["pars"][(1, 4)]
    out = {}
    for arch, temps in (("qwen3-8b", (0.8,)), ("qwen1.5-32b h6", (0.0,)),
                        ("deepseek-v2-lite-16b", (0.0,)), ("zamba2-2.7b", (0.0,)),
                        ("mamba2-780m hd64", (0.0,))):
        cfg = _cfg(arch)
        tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 10)).astype(np.int32)
        for temp in temps:
            sc = ServeConfig(max_new_tokens=3, top_k=8, temperature=temp, seed=3)
            want = generate(model_init(torch.Generator().manual_seed(0), cfg, "cpu"),
                            {"tokens": tokens}, cfg, sc, device="cpu")["tokens"]
            sp = model_init(torch.Generator().manual_seed(0), cfg, "cpu", par=par)
            got = generate(sp, {"tokens": tokens}, cfg, sc, device="cpu", par=par)["tokens"]
            out[f"{arch} t={temp}"] = (want, got)
    return out


def _init_case(par, inputs):
    """``model_init(par=)``, placed a part at a time, against
    ``shard_params`` of the full draw: every local block bit-equal."""
    from repro_torch.models import model_init, param_specs
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import shard_params

    out = {}
    for arch in ("qwen3-8b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "internvl2-26b"):
        cfg = _cfg(arch)
        a = model_init(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32, par=par)
        b = shard_params(_init(cfg), par, param_specs(cfg))
        out[arch] = all(x.placements == y.placements and torch.equal(x.to_local(), y.to_local())
                        for x, y in zip(leaves(a), leaves(b)))
    return out


def _tie_sampler_case(par, inputs):
    """Tie-rich logits (quarters of integers): ``sample_topk`` under
    ``par`` (one k, a ragged k) against the same draw without."""
    from repro_torch.serving.sample import sample_topk

    logits = torch.from_numpy((np.random.default_rng(4).integers(-8, 8, (3, 64)) * 0.25
                               ).astype(np.float32))
    out = {}
    for name, k in (("k 8", 8), ("ragged", [8, 3, 5])):
        got = sample_topk(logits, k=k, temperature=0.7, par=par,
                          generator=torch.Generator().manual_seed(5))
        want = sample_topk(logits, k=k, temperature=0.7,
                           generator=torch.Generator().manual_seed(5))
        out[name] = (want.numpy(), got.numpy())
    return out


def _constrain_case(par, inputs):
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    y = par.constrain(x, "data", "model")
    z = par.constrain(y, None, "model")
    return {"placements": [(type(p).__name__, p.dim) for p in y.placements],
            "local": y.to_local(),
            "full": y.full_tensor(), "z_local": z.to_local()}


CASES = tuple((f"loss {a}", _loss_case(a)) for a in LOSS_ARCHS) + tuple(
    (f"loss tp4 {a}", _loss_case(a, (1, 4))) for a in TP4_CFGS) + (
    ("ref moe", _ref_moe_case), ("generate", _generate_case),
    ("generate tp4", _tp4_generate_case), ("init", _init_case),
    ("sampler ties", _tie_sampler_case), ("train", _train_case),
    ("constrain", _constrain_case))


def _rank_main(rank, world, rdv, inputs, out_dir):
    os.environ["REPRO_RESILIENCE"] = "0"  # a failed rung raises: no rank degrades alone
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.parallel import init_mesh, make_parallelism

        par = make_parallelism(init_mesh("cpu", MESH))
        inputs = dict(inputs, pars={MESH: par, (1, 4): make_parallelism(init_mesh(
            "cpu", (1, 4)))})
        res = {"seconds": {}}
        for name, fn in CASES:
            t0 = time.perf_counter()
            try:
                res[name] = fn(par, inputs)
            except Exception:  # noqa: BLE001 — the parent's test reports it
                res[name] = "error: " + traceback.format_exc()
            res["seconds"][name] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start(inputs):
    mp.set_forkserver_preload([__name__])
    d = tempfile.mkdtemp()
    inputs = dict(inputs, ckpt_dir=os.path.join(d, "ckpt"))
    box = {}

    def start():  # blocks until the server has imported this module
        box["ctx"] = mp.start_processes(
            _rank_main, args=(WORLD, os.path.join(d, "rendezvous"), inputs, d), nprocs=WORLD,
            join=False, start_method="forkserver")

    starter = threading.Thread(target=start)
    starter.start()

    def wait():
        starter.join()
        try:
            while not box["ctx"].join():
                pass
            return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                    for r in range(WORLD)]
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return wait


def _reference_moe():
    """The reference's weights (converted) and batch of
    ``test_sharded_moe_loss_matches_local``, and a function that gives
    its local loss."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import loss_fn as j_loss
    from repro.models import model_init as j_init

    from repro_torch.models import params_from_jax

    cfg = j_smoke("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, dtype="float32",
                              moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    params, _ = j_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)

    def loss():
        return float(jax.jit(lambda p, b: j_loss(p, b, cfg))(
            params, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}))

    host = params_from_jax(jax.tree.map(np.asarray, params), _cfg("qwen3-moe-30b-a3b"), "cpu")
    return host, tokens, targets, loss


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


@pytest.fixture(scope="module", autouse=True)
def group():
    """Starts the ranks when the module's first test starts; a test that
    needs their results calls the fixture's value, which computes the
    reference's MoE loss while they run, then joins them. The tests that
    need no rank run first, beside the ranks."""
    params, tokens, targets, ref_loss = _reference_moe()
    wait = _start({"ref_moe_params": _numpy_tree(params), "ref_moe_tokens": tokens,
                   "ref_moe_targets": targets})
    box = {}

    def results():
        if not box:
            box["loss"] = ref_loss()
            box["res"] = wait()
        return box["res"], box["loss"]

    yield results
    results()  # joined even if no test asked


@pytest.fixture
def ranks(group):
    return group()


def _case(ranks, name):
    res, _ = ranks
    out = [r[name] for r in res]
    for r, o in enumerate(out):
        if isinstance(o, str) and o.startswith("error: "):
            pytest.fail(f"rank {r}, case {name}:\n{o}")
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "mamba2-780m",
                                  "internvl2-26b", "qwen1.5-32b", "chatglm3-6b",
                                  "deepseek-coder-33b", "qwen3-8b", "zamba2-2.7b",
                                  "hubert-xlarge"])
def test_param_specs_match_reference(arch):
    import jax

    from repro.configs import get_config as j_config
    from repro.models import model_init as j_init
    from repro.parallel import sharding as j_sharding
    from test_torch_parallel import StandInMesh

    from repro_torch.configs import get_config
    from repro_torch.models import model_init, param_specs
    from repro_torch.parallel import sharding as t_sharding

    cell = {}

    def only_params(key):
        p, cell["specs"] = j_init(key, j_config(arch))
        return p

    shapes = jax.eval_shape(only_params, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    meta = model_init(None, cfg, "meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        meta, is_leaf=lambda x: isinstance(x, torch.Tensor)))

    def per_layer(jtree, n):  # a stacked reference leaf: one spec a layer, less its layer
        return [jax.tree.map(lambda s: tuple(s)[1:], jtree,
                             is_leaf=lambda x: isinstance(x, j_sharding.P))] * n

    for sizes in (dict(data=16, model=16), dict(pod=2, data=16, model=16)):
        mesh = StandInMesh(**sizes)
        jp = j_sharding.build_param_pspecs(shapes, cell["specs"], mesh)
        tp = t_sharding.build_param_pspecs(meta, param_specs(cfg), mesh)
        tp = jax.tree.map(tuple, tp, is_leaf=lambda x: isinstance(x, t_sharding.PSpec))
        want = {k: jax.tree.map(tuple, v, is_leaf=lambda x: isinstance(x, j_sharding.P))
                for k, v in jp.items() if k != "stack"}
        assert {k: v for k, v in tp.items() if k != "stack"} == want
        jst, tst = jp["stack"], tp["stack"]
        assert sorted(jst) == sorted(tst)
        for part in tst:
            if part == "head":
                assert tst[part] == [jax.tree.map(tuple, d, is_leaf=lambda x: isinstance(
                    x, j_sharding.P)) for d in jst[part]]
            elif part == "shared":
                assert tst[part] == jax.tree.map(tuple, jst[part], is_leaf=lambda x: isinstance(
                    x, j_sharding.P))
            else:
                assert tst[part] == per_layer(jst[part], len(tst[part]))
        assert any(e is not None for leaf in jax.tree.leaves(
            tp, is_leaf=lambda x: isinstance(x, tuple)) for e in leaf)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_and_grads_match_unsharded(ranks, arch):
    out = _case(ranks, f"loss {arch}")
    for o in out:
        assert abs(o["loss1"] - o["loss0"]) <= LOSS_ATOL, o
        assert o["gerr"] <= GRAD_ATOL, o
        assert o["shapes_ok"], o
        assert o["n_sharded"] > 0  # something is split on this mesh
    assert len({o["loss1"] for o in out}) == 1  # every rank the same mean


@pytest.mark.parametrize("arch", list(TP4_CFGS))
def test_tp4_attention_layouts_match_unsharded(ranks, arch):
    """A TP axis of 4 that the kv heads do not divide: the heads layout
    (qwen3-8b smoke), the rows layout with ``wo`` by rows (6 heads) and
    with ``wo`` replicated (5 heads of 6); the SSM mixer by heads and with
    every head: loss and gradients as on (2, 2)."""
    out = _case(ranks, f"loss tp4 {arch}")
    for o in out:
        assert abs(o["loss1"] - o["loss0"]) <= LOSS_ATOL, o
        assert o["gerr"] <= GRAD_ATOL, o
        assert o["shapes_ok"], o
    assert len({o["loss1"] for o in out}) == 1


def test_tp4_generate_matches_unsharded(ranks):
    """Prefill in the heads and rows layouts, decode over the cache
    sharded on head_dim (never gathered): tokens as without ``par``."""
    for o in _case(ranks, "generate tp4"):
        for name, (want, got) in o.items():
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_model_init_par_places_as_shard_params(ranks):
    for o in _case(ranks, "init"):
        assert all(o.values()), o


def test_sample_topk_par_draws_canonical_tokens(ranks):
    """TP = 2: the token of a tied draw is the lowest id of its value, as
    without ``par``."""
    for o in _case(ranks, "sampler ties"):
        for name, (want, got) in o.items():
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_sharded_moe_loss_matches_reference_local(ranks):
    _, ref_loss = ranks
    for sharded, plain in _case(ranks, "ref moe"):
        assert abs(sharded - ref_loss) <= REF_MOE_ATOL, (sharded, ref_loss)
        assert abs(sharded - plain) <= LOSS_ATOL, (sharded, plain)


def test_sharded_generate_matches_unsharded(ranks):
    for o in _case(ranks, "generate"):
        for name, (want, got) in o.items():
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_sharded_train_resumes_to_unsharded_losses(ranks):
    for o in _case(ranks, "train"):
        assert o["fault"] == "injected fault at step 3"
        # the resumed run starts from step 2's checkpoint: steps 2..5
        np.testing.assert_allclose(o["resumed"], o["ref"][2:], rtol=0, atol=LOSS_ATOL)


def test_sharded_checkpoint_restores_unsharded(ranks):
    for o in _case(ranks, "train"):
        assert o["step"] == 6 and o["restored_equal"]


def test_constrain_places_by_spec(ranks):
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for r, o in enumerate(_case(ranks, "constrain")):
        assert o["placements"] == [("Shard", 0), ("Shard", 1)]
        d, m = divmod(r, 2)
        assert torch.equal(o["local"], full[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        assert torch.equal(o["full"], full)
        assert torch.equal(o["z_local"], full[:, 3 * m:3 * m + 3])
