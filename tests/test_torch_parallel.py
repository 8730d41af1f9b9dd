"""CPU parity of the port's distribution layer (``repro_torch.parallel``,
``repro_torch.streaming.tree``, ``par=`` through the library, the sampler
and the MoE layer) against the JAX package.

Two module-scoped fixtures spawn a gloo group each, of 4 ranks (the
butterfly, expert parallelism) and of 3 (the gather tree, a split that
is not a power of two); every case runs inside those two spawns
(``tests/test_torch_parallel_ranks.py``) and each rank's outputs come
back here. The reference's ``shard_map`` bodies run in this process
under ``jax.vmap(body, axis_name="model")`` on the stacked per-rank
slices: :func:`vmap_shard_map` replaces ``shard_map_compat`` for a
stand-in mesh, so the reference's own entry points (``sample_sort``,
``tree_topk``, ``pipeline_apply``, ``moe_apply``, ``repro.sort(...,
par=)``) run their bodies that way; a replicated output is rank 0's
buffer, as the reference returns it. The inputs are numpy arrays from a
seed, made here and handed to the ranks.

Tolerances: sort, merge, top-k and the sampler's tokens bit-equal, ties
included; the pipeline within 1e-6 (float32 tanh layers); compression's
int8 codes and scales bit-equal, the reduced gradient within 1e-6
relative (the ranks' float sums run in another order); MoE expert
parallelism within 1e-5 of the layer's largest magnitude (einsum and bmm
sum in other orders). The partition specs are held in-process against
the reference's on stand-in meshes of (2, 4) and (2, 16, 16).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro
import repro.parallel.sharding as j_sharding
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as j_moe
from repro.parallel import compress as j_compress
from repro.parallel import dist_sort as j_dist
from repro.parallel import pipeline as j_pipeline
from repro.serving import sample as j_sample
from repro.streaming import tree as j_tree

import repro_torch
from repro_torch.parallel import sharding as t_sharding
from repro_torch.streaming import cache as tcache
from test_torch_parallel_ranks import MOE_BLOCK, MOE_LAYER, start_groups

WORLDS = (4, 3)


class StandInMesh:
    """The two attributes of a mesh the reference reads, hashable for its
    jitted entry points' static arguments."""

    def __init__(self, **sizes):
        self._sizes = tuple(sizes.items())

    @property
    def axis_names(self):
        return tuple(n for n, _ in self._sizes)

    @property
    def shape(self):
        return dict(self._sizes)

    def __hash__(self):
        return hash(self._sizes)

    def __eq__(self, other):
        return isinstance(other, StandInMesh) and other._sizes == self._sizes


#: every stacked (rank-major) output of the bodies run since the last clear
STACKED = []


def vmap_shard_map(f, mesh, in_specs, out_specs, check=False):
    """``shard_map`` over the one mesh axis larger than 1, run as
    ``jax.vmap(f, axis_name=axis)`` on the per-rank blocks."""
    axis = [a for a, n in mesh.shape.items() if n > 1]
    assert len(axis) == 1, mesh.shape
    axis = axis[0]
    size = mesh.shape[axis]

    def dim_of(spec):
        for d, e in enumerate(spec):
            if axis in (e if isinstance(e, tuple) else (e,)):
                return d
        return None

    def split(spec, a):
        d = dim_of(spec)
        a = jnp.asarray(a)
        if d is None:
            return a, None
        sh = a.shape
        a = a.reshape(sh[:d] + (size, sh[d] // size) + sh[d + 1:])
        return jnp.moveaxis(a, d, 0), 0

    def join(spec, o):
        d = dim_of(spec)
        if d is None:
            return o[0]  # a replicated output: rank 0's buffer
        o = jnp.moveaxis(o, 0, d)
        return o.reshape(o.shape[:d] + (o.shape[d] * o.shape[d + 1],) + o.shape[d + 2:])

    def is_spec(x):
        return isinstance(x, P)

    def run(*args):
        specs = (in_specs,) if is_spec(in_specs) else tuple(in_specs)
        blocks, axes = [], []
        for spec_tree, arg in zip(specs, args):
            pairs = jax.tree.map(lambda s, sub: jax.tree.map(lambda a: split(s, a), sub),
                                 spec_tree, arg, is_leaf=is_spec)
            leaf = lambda x: isinstance(x, tuple) and len(x) == 2 and not is_spec(x)  # noqa
            blocks.append(jax.tree.map(lambda pr: pr[0], pairs, is_leaf=leaf))
            axes.append(jax.tree.map(lambda pr: pr[1], pairs, is_leaf=leaf))
        out = jax.vmap(f, in_axes=tuple(axes), axis_name=axis, axis_size=size)(*blocks)
        STACKED.append(out)
        if is_spec(out_specs):
            return join(out_specs, out)
        return type(out)(join(s, o) for s, o in zip(out_specs, out))

    return run


@pytest.fixture(scope="module", autouse=True)
def reference_under_vmap():
    """The reference's shard_map bodies under vmap, its ladder off (no
    rung may answer for a failed body), both planners on empty caches."""
    import tempfile

    from repro.resilience import set_resilience_enabled
    from repro.streaming.cache import AutotuneCache, set_default_cache

    mp = pytest.MonkeyPatch()
    mp.setattr(j_sharding, "shard_map_compat", vmap_shard_map)
    prev_res = set_resilience_enabled(False)
    d = tempfile.mkdtemp()
    prev = set_default_cache(AutotuneCache(os.path.join(d, "ref.json")))
    prev_t = tcache.set_default_cache(tcache.AutotuneCache(os.path.join(d, "port.json")))
    yield
    set_default_cache(prev)
    tcache.set_default_cache(prev_t)
    set_resilience_enabled(prev_res)
    mp.undo()


def jpar_for(world):
    return j_sharding.make_parallelism(StandInMesh(data=1, model=world))


def make_inputs(world: int) -> dict:
    """Every case's inputs, numpy from one seed; lengths split over ``world``."""
    rng = np.random.default_rng(28 + world)
    w = world
    inp = {"ties": rng.integers(-6, 6, (2, 8 * w)).astype(np.int32)}
    for i, ln in enumerate((3 * w, 5 * w, 2 * w)):
        inp[f"list{i}"] = np.sort(rng.integers(-6, 6, (2, ln)), axis=1).astype(np.int32)
    # the float cases share the int32 cases' shapes: the ops layer sends
    # int32 keys, so the reference's jitted bodies compile once for both
    inp["floats"] = (rng.integers(-8, 8, (2, 8 * w)) * 0.5).astype(np.float32)
    for i, ln in enumerate((3 * w, 5 * w, 2 * w)):
        inp[f"flist{i}"] = np.sort(rng.integers(-5, 5, (2, ln)) * 0.25, axis=1).astype(np.float32)
        inp[f"fid{i}"] = (np.arange(2 * ln).reshape(2, ln) + 1000 * i).astype(np.int32)
    inp["logits"] = (rng.integers(-20, 20, (3, 32 * w)) * 0.25).astype(np.float32)
    inp["ks"] = np.array([3, 8, 5])
    inp["g8"] = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (3, 8), jnp.float32))
    inp["gks"] = np.asarray(jax.random.gumbel(jax.random.PRNGKey(2), (3, 8), jnp.float32))
    inp["tree"] = rng.integers(-10, 10, (2, 64 * w)).astype(np.float32)
    inp["pipe_w"] = (rng.standard_normal((w, 8, 8)) * 0.5).astype(np.float32)
    inp["pipe_b"] = (rng.standard_normal((w, 8)) * 0.1).astype(np.float32)
    inp["pipe_x"] = rng.standard_normal((3, 2, 8)).astype(np.float32)
    inp["grad"] = rng.standard_normal((w, 8, 100)).astype(np.float32)
    inp["err"] = (rng.standard_normal((w, 8, 100)) * 0.01).astype(np.float32)
    d, e, f = MOE_LAYER["d_model"], MOE_BLOCK["n_experts"], MOE_BLOCK["d_expert"]
    inp["moe_router"] = (rng.integers(-4, 5, (d, e)) * 0.25).astype(np.float32)
    inp["moe_wi"] = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    inp["moe_wg"] = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    inp["moe_wo"] = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    inp["moe_prefill"] = (rng.integers(-6, 7, (2, 8, d)) * 0.25).astype(np.float32)
    inp["moe_decode"] = (rng.integers(-6, 7, (2, 1, d)) * 0.25).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def groups():
    """Both gloo groups, started at once: {world: (world, inputs, results)}."""
    inputs = {w: make_inputs(w) for w in WORLDS}
    results = Results(start_groups(inputs))
    return {w: (w, inputs[w], results.of(w)) for w in WORLDS}


class Results:
    """The groups' results, waited for at the first read: the tests compute
    their reference outputs while the ranks run."""

    def __init__(self, wait):
        self._wait, self._got = wait, None

    def of(self, world: int):
        return _Ranks(self, world)

    def ranks(self, world: int) -> list:
        if self._got is None:
            self._got = self._wait()
        return self._got[world]


class _Ranks:
    def __init__(self, results: Results, world: int):
        self._results, self._world = results, world

    def __iter__(self):
        return iter(self._results.ranks(self._world))


@pytest.fixture(scope="module")
def ranks4(groups):
    return groups[4]


@pytest.fixture(scope="module")
def ranks3(groups):
    return groups[3]


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def group(request):
    return request.getfixturevalue(f"ranks{request.param}")


def outputs(results, case):
    """Every rank's output of one case; a case that raised fails here."""
    outs = [r[case] for r in results]
    for r, o in enumerate(outs):
        if isinstance(o, str):
            pytest.fail(f"rank {r}, case {case}:\n{o}")
    return outs


def same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        got, want = got.view(np.int32 if got.itemsize == 4 else np.int16), want.view(
            np.int32 if want.itemsize == 4 else np.int16)
    np.testing.assert_array_equal(got, want, err_msg=what)


def every_rank(outs, want, what=""):
    """Every rank returned ``want`` (a tensor or a tuple of them)."""
    for r, o in enumerate(outs):
        if isinstance(want, tuple):
            for i, (g, w) in enumerate(zip(o, want)):
                same(g, w, f"{what} rank {r} output {i}")
        else:
            same(o, want, f"{what} rank {r}")


# ---------------------------------------------------------------------------
# the sample-sort and the k-way sample-merge
# ---------------------------------------------------------------------------


def test_sample_sort_matches_reference(group):
    """int32 rows with ties, with positions, and values only (the
    values of the same sort)."""
    world, inp, res = group
    x = jnp.asarray(inp["ties"])
    iota = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32), x.shape)
    wv, wp = j_dist.sample_sort(x, mesh=StandInMesh(data=1, model=world), axis_name="model",
                                pos=iota)
    every_rank(outputs(res, "sort_ties_pos"), (np.asarray(wv), np.asarray(wp)), "positions")
    every_rank(outputs(res, "sort_ties"), np.asarray(wv), "values")


def test_sample_merge_k_matches_reference(ranks4):
    """Three ragged int32 lists with ties (lengths 12, 20, 8), with and
    without positions."""
    world, inp, res = ranks4
    lists = [jnp.asarray(inp[f"list{i}"]) for i in range(3)]
    offs = np.cumsum([0] + [t.shape[1] for t in lists])
    pos = [jnp.broadcast_to(jnp.arange(t.shape[1], dtype=jnp.int32) + int(o), t.shape)
           for t, o in zip(lists, offs)]
    wv, wp = j_dist.sample_merge_k(lists, mesh=StandInMesh(data=1, model=world),
                                   axis_name="model", pos=pos)
    every_rank(outputs(res, "merge_ties_pos"), (np.asarray(wv), np.asarray(wp)), "positions")
    every_rank(outputs(res, "merge_ties"), np.asarray(wv), "values")


def _keys(t):
    """The ops layer's total-order int32 keys of a float tensor."""
    from repro_torch.api.keys import encode_keys

    return encode_keys(t).numpy()


def test_ops_sort_matches_reference_and_single_device(ranks4):
    """Float keys through the ops layer: values, positions (ties in the
    reference's order) and ``stable=True`` descending against the
    reference's sharded rung, values and the stable positions against
    the port's single-device call."""
    world, inp, res = ranks4
    x = inp["floats"]
    iota = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32), x.shape)
    tx, ti = torch.from_numpy(x), torch.from_numpy(iota.copy())
    # the reference's body on the total-order keys the ops layer sends
    # (the same shapes as the int32 case: its compile is cached)
    _, wp = j_dist.sample_sort(jnp.asarray(_keys(tx)), mesh=StandInMesh(data=1, model=world),
                               axis_name="model", pos=jnp.asarray(iota))
    wp = np.asarray(wp)
    wv = np.take_along_axis(x, wp, axis=1)
    outs = outputs(res, "ops_sort")
    every_rank([o[:3] for o in outs], (wv, wv, wp), "sort")
    same(outs[0][0], repro_torch.sort(tx).numpy(), "values against the single device")
    sv, sp = repro_torch.sort(tx, payload=ti, stable=True, descending=True)
    every_rank([o[3:] for o in outs], (sv.numpy(), sp.numpy()), "stable, descending")
    # the tie order of the unstable payload is the sharded route's own: on
    # these rows it differs from the single-device route's
    assert not np.array_equal(outs[0][2], repro_torch.sort(tx, payload=ti)[1].numpy())


def test_ops_merge_matches_reference_and_single_device(ranks4):
    """Float lists through ``merge_k`` (values, an int32 payload, ties in
    the reference's order) against the reference's sharded rung; the
    values and the sharded 2-way ``merge`` against the port's single
    device."""
    world, inp, res = ranks4
    lists = [inp[f"flist{i}"] for i in range(3)]
    tl = [torch.from_numpy(t) for t in lists]
    offs = np.cumsum([0] + [t.shape[1] for t in lists])
    pos = [jnp.broadcast_to(jnp.arange(t.shape[1], dtype=jnp.int32) + int(o), t.shape)
           for t, o in zip(lists, offs)]
    _, wp = j_dist.sample_merge_k([jnp.asarray(_keys(t)) for t in tl],
                                  mesh=StandInMesh(data=1, model=world), axis_name="model",
                                  pos=pos)
    wp = np.asarray(wp)
    wv = np.take_along_axis(np.concatenate(lists, axis=1), wp, axis=1)
    ids = np.take_along_axis(np.concatenate([inp[f"fid{i}"] for i in range(3)], axis=1), wp,
                             axis=1)
    outs = outputs(res, "ops_merge")
    every_rank([o[:3] for o in outs], (wv, wv, ids), "merge")
    same(outs[0][0], repro_torch.merge_k(tl).numpy(), "values against the single device")
    same(outs[0][3], repro_torch.merge(tl[0], tl[1]).numpy(), "2-way against the single device")


def test_topk_and_sampler_match_reference(ranks4):
    """``topk(par=)`` (auto: the device tree) and the sampler's tokens
    (one k, a ragged k, the nucleus) on every rank against the
    reference's; the values against the port's single-device top-k. The
    logits are tie-rich (quarters of integers): the port's
    ``sample_topk(par=)`` draws the canonical token (the lowest id of the
    drawn value) on every mesh, the reference's unsharded token; the
    reference's sharded one takes the candidate's own index."""
    world, inp, res = ranks4
    jpar = jpar_for(world)
    logits = jnp.asarray(inp["logits"])
    wv, wi = jax.jit(lambda lg: repro.topk(lg, 8, par=jpar))(logits)
    outs = outputs(res, "ops_topk")
    every_rank(outs, (np.asarray(wv), np.asarray(wi)), "topk")
    same(outs[0][0], repro_torch.topk(torch.from_numpy(inp["logits"]), 8)[0].numpy(),
         "values against the single device")
    ks = [int(k) for k in inp["ks"]]

    @jax.jit
    def tokens(lg):
        return (j_sample.sample_topk(jax.random.PRNGKey(1), lg, k=8, temperature=0.7),
                j_sample.sample_topk(jax.random.PRNGKey(2), lg, k=ks, temperature=0.7),
                j_sample.sample_topp(jax.random.PRNGKey(1), lg, p=0.8, k_max=8,
                                     temperature=0.7, par=jpar))

    every_rank(outputs(res, "sampler"), tuple(np.asarray(t) for t in tokens(logits)), "tokens")


# ---------------------------------------------------------------------------
# the device-tree top-k: the butterfly's ranks agree
# ---------------------------------------------------------------------------


def test_tree_topk_every_rank_is_reference_rank0(group):
    """Ties included: every port rank returns the reference's returned
    array (its rank 0's buffer). On a power-of-two axis the reference's
    own rank 1 holds other tied indices (its butterfly merges each rank's
    own list first); the port merges the lower rank's first."""
    world, inp, res = group
    mesh = StandInMesh(data=1, model=world)

    @jax.jit
    def ref(x):  # the returned array and every rank's buffer
        out = j_tree.tree_topk(x, 16, mesh=mesh, axis="model")
        return out, STACKED[-1]

    (wv, wi), (sv, si) = ref(jnp.asarray(inp["tree"]))
    every_rank(outputs(res, "tree"), (np.asarray(wv), np.asarray(wi)), "tree_topk")
    sv, si = np.asarray(sv), np.asarray(si)
    assert all(np.array_equal(sv[r], sv[0]) for r in range(world))  # values agree
    if world & (world - 1) == 0:
        assert not np.array_equal(si[1], si[0]), "the reference's rank 1 kept rank 0's ties"


# ---------------------------------------------------------------------------
# the pipeline and the compressed reduction
# ---------------------------------------------------------------------------


def test_pipeline_matches_reference(ranks4):
    world, inp, res = ranks4
    params = {"w": jnp.asarray(inp["pipe_w"]), "b": jnp.asarray(inp["pipe_b"])}
    mesh = StandInMesh(data=1, model=world)
    want = jax.jit(lambda p, x: j_pipeline.pipeline_apply(
        lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, x, mesh, axis="model"))(
        params, jnp.asarray(inp["pipe_x"]))
    for r, o in enumerate(outputs(res, "pipeline")):
        np.testing.assert_allclose(o, np.asarray(want), rtol=0, atol=1e-6, err_msg=f"rank {r}")


def test_compressed_psum_matches_reference(ranks4):
    world, inp, res = ranks4
    g, e = jnp.asarray(inp["grad"]), jnp.asarray(inp["err"])

    # codes and scales eagerly: under jit XLA may turn the scale's division
    # by 127 into a multiplication, one ulp off
    wq, ws = jax.vmap(j_compress.compress)(g + e)
    wg, we = jax.jit(jax.vmap(lambda a, b: j_compress.compressed_psum(a, "model", b),
                              axis_name="model"))(g, e)
    for r, (q, s, gh, ne) in enumerate(outputs(res, "compress")):
        same(q, np.asarray(wq[r]), f"codes rank {r}")
        same(s, np.asarray(ws[r]), f"scales rank {r}")
        np.testing.assert_allclose(gh, np.asarray(wg[r]), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(wg).max()))
        # the residual is a difference of near-equal values (and the jitted
        # reference fuses its multiply-subtract): within 1e-6 of |g + err|
        np.testing.assert_allclose(ne, np.asarray(we[r]), rtol=0,
                                   atol=1e-6 * float(np.abs(g + e).max()))


# ---------------------------------------------------------------------------
# MoE expert parallelism (8 experts over the 4-rank axis)
# ---------------------------------------------------------------------------


def _jmoe(dispatch):
    kw = {k: v for k, v in MOE_LAYER.items()}
    return JModelConfig(moe=JMoEConfig(**MOE_BLOCK, dispatch=dispatch), **kw)


def test_moe_expert_parallel_matches_reference(ranks4):
    """Both EP modes (the all_to_all prefill of 2 x 8 tokens, the psum
    decode of 2 x 1) in float32 against the reference's EP layer, the
    scatter and the sorted dispatch, each against the port's local layer
    too."""
    world, inp, res = ranks4
    jp = {name: {"w": jnp.asarray(inp[f"moe_{name}"])} for name in ("router", "wi", "wg", "wo")}
    jpar = jpar_for(world)
    ep = jax.jit(lambda p, x: j_moe.moe_apply(p, x, _jmoe("scatter"), par=jpar))
    outs = outputs(res, "moe")
    i = 0
    for dispatch in ("scatter", "sorted"):
        for x in (inp["moe_prefill"], inp["moe_decode"]):
            want = np.asarray(ep(jp, jnp.asarray(x)))
            tol = 1e-5 * float(np.abs(want).max())
            for r, o in enumerate(outs):
                np.testing.assert_allclose(o[i], want, rtol=0, atol=tol,
                                           err_msg=f"{dispatch} {x.shape} rank {r}")
                np.testing.assert_allclose(o[i + 1], want, rtol=0, atol=tol,
                                           err_msg=f"local {dispatch} {x.shape} rank {r}")
            i += 2


def test_moe_expert_parallel_refusals(ranks4):
    """What EP still refuses: ragged ``expert_capacities`` (the reference
    asserts it), and an EP axis that does not divide the experts."""
    _, _, res = ranks4
    for msgs in outputs(res, "moe_refusals"):
        assert "expert_capacities is a non-EP feature" in msgs[0]
        assert "do not split over an EP axis of 3" in msgs[1]


# ---------------------------------------------------------------------------
# planning and the partition specs (no process group)
# ---------------------------------------------------------------------------


def test_plan_routes_sharded_with_par(group):
    """With a TP axis dividing the lists, the decision-table rows of the
    sharded backend are planned: the sample-sort, the sample-merge and the
    device tree."""
    world, _, res = group

    for rows in outputs(res, "plan"):
        for got, n in zip(rows, (1 << 20, 50_000, 151_936)):
            assert (got == "sharded") == (n % world == 0), (n, got)


def test_sharded_backend_without_par_raises_as_reference():
    x = np.arange(64, dtype=np.float32)[None]
    with pytest.raises(ValueError):
        repro.sort(jnp.asarray(x), backend="sharded")
    with pytest.raises(ValueError, match="backend 'sharded' cannot run"):
        repro_torch.sort(torch.from_numpy(x), backend="sharded")


MESHES = (dict(data=2, model=4), dict(pod=2, data=16, model=16))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "internvl2-26b", "hubert-xlarge"])
def test_pspecs_match_reference(arch):
    """``build_param_pspecs`` / ``batch_pspecs`` on the reference's spec
    trees and ``eval_shape`` shapes of the smoke configs, and
    ``cache_pspecs`` on the port's own cache layout (a dict of one layer,
    each layer of a list) against the reference's on its layout (a
    layer-stacked dict: its leading layer entry dropped), on stand-in
    meshes of (2, 4) and (2, 16, 16)."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import init_cache as j_init_cache
    from repro.models import model_init as j_model_init

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_cache as t_init_cache

    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    cell = {}

    def only_params(key):
        p, cell["specs"] = j_model_init(key, jcfg)
        return p

    shapes = jax.eval_shape(only_params, jax.random.PRNGKey(0))
    cache = (None if jcfg.family == "audio"
             else jax.eval_shape(lambda: j_init_cache(jcfg, 32, 64)))

    def flat(tree, cls):
        return [tuple(v) for v in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, cls))]

    for sizes in MESHES:
        sm = StandInMesh(**sizes)
        jpar, tpar = j_sharding.make_parallelism(sm), t_sharding.make_parallelism(sm)
        assert (tpar.dp_axes, tpar.dp_size, tpar.tp_size) == (jpar.dp_axes, jpar.dp_size,
                                                              jpar.tp_size)
        got = flat(t_sharding.build_param_pspecs(shapes, cell["specs"], sm), t_sharding.PSpec)
        assert flat(j_sharding.build_param_pspecs(shapes, cell["specs"], sm), P) == got
        assert any(any(e is not None for e in g) for g in got)  # something is sharded
        jb, tb = j_sharding.batch_pspecs(jcfg, jpar), t_sharding.batch_pspecs(tcfg, tpar)
        assert {k: tuple(v) for k, v in jb.items()} == {k: tuple(v) for k, v in tb.items()}
        if cache is not None:
            jc = j_sharding.cache_pspecs(jcfg, jpar, cache)
            tc = t_sharding.cache_pspecs(tcfg, tpar, t_init_cache(tcfg, 32, 64, device="meta"))
            assert sorted(jc) == sorted(tc)
            for part, jsub in jc.items():
                if isinstance(jsub, list):  # the reference's unstacked head
                    jlayers = [{k: tuple(v) for k, v in d.items()} for d in jsub]
                else:  # stacked: one spec for every layer, less the layer entry
                    one = {k: tuple(v)[1:] for k, v in jsub.items()}
                    jlayers = [one] * len(tc[part])
                    assert all(tuple(v)[0] is None for v in jsub.values())
                assert [{k: tuple(v) for k, v in d.items()} for d in tc[part]] == jlayers
            assert any(e is not None for d in tc["body"] for v in d.values() for e in v)


def test_pspec_rules_fall_back_to_replication():
    mesh = StandInMesh(data=16, model=16)
    for shape, logical in (((4096, 40, 128), ("embed", "heads", "head_dim")),
                           ((4096, 32, 128), ("embed", "heads", "head_dim")),
                           ((7, 4096, 64), ("heads", "embed")),
                           ((32, 16), ("expert", "mlp"))):
        assert tuple(j_sharding._pspec_for(shape, logical, mesh)) == \
            tuple(t_sharding._pspec_for(shape, logical, mesh))
    assert dataclasses.is_dataclass(t_sharding.Parallelism)
