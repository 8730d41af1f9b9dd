"""``repro_torch.launch.dryrun`` and ``launch.mesh``: one rank's step of a
cell on a fake 16 x 16 process group, counted with no device and no
allocation.

The fake group is process-global and outlives a test, so the cells run
in a child process (``python -c``, started with the module and run
beside its other tests): qwen3-8b's smoke config at a train and a decode
shape cut to 32 tokens and a batch of 32, and qwen3-moe-30b-a3b's (expert
parallelism) at the train shape. In it:

* the record's argument bytes equal the sum of the local shard bytes
  computed from the specs (``build_param_pspecs``, the moments beside
  the float32 masters, ``batch_pspecs_for``, ``cache_pspecs``);
* the rank's FLOPs times the 256 ranks are no less than the same step's
  FLOPs without ``par`` (the whole batch on one device);
* the decode cell's cache is split on no sequence dim.

Here, with no group: ``cell_skip_reason`` skips ``long_500k`` for every
full-attention arch and the encoder's decode, as the reference's does;
``cache_pspecs`` splits no sequence dim of any arch's full-width decode
cache on the production meshes; importing ``launch.mesh`` builds no mesh.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, math
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import decode_step, init_cache, loss_fn, model_init, param_specs
from repro_torch.optim.adamw import leaves
from repro_torch.parallel import (PSpec, axis_sizes, build_param_pspecs, cache_pspecs,
                                  make_parallelism)
from repro_torch.launch.mesh import make_production_mesh

SHAPES = [ShapeConfig("train_s", 32, 32, "train"), ShapeConfig("decode_s", 32, 32, "decode")]


def spec_leaves(tree):
    if isinstance(tree, PSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in spec_leaves(v)]
    return [s for v in tree for s in spec_leaves(v)]


def local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for d, e in zip(shape, list(spec) + [None] * (len(shape) - len(spec))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


out = []
for arch, shapes in (("qwen3-8b", SHAPES), ("qwen3-moe-30b-a3b", SHAPES[:1])):
    cfg = get_smoke_config(arch)
    for shape in shapes:
        rec = dryrun.run_cell(arch, shape, "pod", smoke=True)
        mesh = make_production_mesh(device_type="cpu")
        sizes = axis_sizes(mesh)
        par = make_parallelism(mesh, ep=True)
        train = shape.kind == "train"
        meta = model_init(None, cfg, "meta", torch.float32 if train else None)
        ps = build_param_pspecs(meta, param_specs(cfg), mesh)
        want = 0
        for t, s in zip(leaves(meta), spec_leaves(ps)):
            # float32 masters and their two moments, or the served weights
            want += local_bytes(t.shape, s, sizes, t.element_size()) * (3 if train else 1)
        want += 4 if train else 0  # the step counter
        bps = dryrun.batch_pspecs_for(cfg, shape, par)
        for name, (shp, dt) in dryrun.input_specs(cfg, shape).items():
            want += local_bytes(shp, bps[name], sizes, torch.empty((), dtype=dt).element_size())
        seq_split = []
        if shape.kind != "train":
            cache = init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
            cps = cache_pspecs(cfg, par, cache)
            for part, layers in cache.items():
                for lc, lp in zip(layers, cps[part]):
                    for name, t in lc.items():
                        want += local_bytes(t.shape, lp[name], sizes, t.element_size())
            with dryrun.fake_mode():
                placed = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu", par=par)
            seq_dim = {"k": 3, "v": 2, "ckv": 2, "kpe": 2}
            for layers in placed.values():
                for lc in layers:
                    for name, t in lc.items():
                        if name in seq_dim:
                            seq_split += [p.is_shard(seq_dim[name]) for p in t.placements]
        # the same step without par: the whole batch on one device
        with dryrun.fake_mode(), FlopCounterMode(display=False) as fc:
            p = model_init(None, cfg, "cpu", torch.float32 if train else None)
            b, s = shape.global_batch, shape.seq_len
            toks = torch.zeros((b, s), dtype=torch.int32)
            if train:
                ls = leaves(p)
                for t in ls:
                    t.requires_grad_(True)
                torch.autograd.grad(loss_fn(p, {"tokens": toks, "targets": toks}, cfg), ls,
                                    allow_unused=True)
            else:
                decode_step(p, toks[:, :1], init_cache(cfg, b, s, "cpu"), cfg,
                            positions=toks[:, :1])
        out.append({"arch": arch, "shape": shape.name, "status": rec["status"],
                    "args": rec["memory"]["argument_bytes"], "want": want,
                    "flops": rec["flops"], "single": int(fc.get_total_flops()),
                    "n": rec["n_chips"], "seq_split": any(seq_split),
                    "n_cache": len(seq_split), "peak": rec["memory"]["peak_temp_bytes"],
                    "coll": rec["collectives"]["total_bytes"], "accum": rec["grad_accum"]})
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def child():
    """The child starts with the module's first test; the tests that need
    no group run beside it, and ``cells`` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, "-c", CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def cells(child):
    out, err = child.communicate(timeout=300)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert child.returncode == 0 and lines, err[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


def test_cell_skip_reason_matches_reference():
    from repro.configs import get_config as j_config
    from repro.configs import get_shape as j_shape

    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.launch.dryrun import cell_skip_reason

    skipped = set()
    for arch in ARCHS:
        for shape in SHAPES:
            got = cell_skip_reason(get_config(arch), shape)
            # the reference's rule, on its own configs (its module sets a
            # process-wide XLA flag at import, so it is restated here)
            jc, js = j_config(arch), j_shape(shape.name)
            want = ("encoder-only: no decode step" if js.kind == "decode" and not jc.causal
                    else "pure full-attention arch: 500k decode needs sub-quadratic mixing"
                    if js.name == "long_500k" and not jc.sub_quadratic else None)
            assert got == want, (arch, shape.name)
            if got:
                skipped.add((arch, shape.name))
    full_attention = [a for a in ARCHS if get_config(a).family not in ("ssm", "hybrid")]
    assert {(a, "long_500k") for a in full_attention} <= skipped
    assert ("mamba2-780m", "long_500k") not in skipped
    assert ("zamba2-2.7b", "long_500k") not in skipped


@pytest.mark.parametrize("multi", [False, True])
def test_cache_pspecs_split_no_sequence_dim(multi):
    from test_torch_parallel import StandInMesh

    from repro_torch.configs import ARCHS, get_config, get_shape
    from repro_torch.models import init_cache
    from repro_torch.parallel import cache_pspecs, make_parallelism

    sizes = dict(pod=2, data=16, model=16) if multi else dict(data=16, model=16)
    par = make_parallelism(StandInMesh(**sizes))
    seq_dim = {"k": 3, "v": 2, "ckv": 2, "kpe": 2}
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.is_encoder_only:
            continue
        shape = get_shape("decode_32k")
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
        specs = cache_pspecs(cfg, par, cache)
        split = 0
        for part, layers in cache.items():
            for lc, lp in zip(layers, specs[part]):
                for name, t in lc.items():
                    spec = tuple(lp[name]) + (None,) * (t.ndim - len(lp[name]))
                    if name in seq_dim:
                        assert spec[seq_dim[name]] is None, (arch, part, name, spec)
                    split += any(e is not None for e in spec)
        assert split, arch  # the caches are split somewhere


def test_mesh_import_builds_nothing():
    import torch.distributed as dist

    import repro_torch.launch.mesh as mesh_mod

    assert callable(mesh_mod.make_production_mesh) and callable(mesh_mod.make_host_mesh)
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            mesh_mod.make_host_mesh(device_type="cpu")


def test_argument_bytes_are_the_local_shards(cells):
    assert len(cells) == 3
    for c in cells:
        assert c["status"] == "ok", c
        assert c["args"] == c["want"], c
        assert c["peak"] > 0 and c["coll"] > 0, c


def test_rank_flops_cover_the_unsharded_step(cells):
    for c in cells:
        assert c["n"] == 256 and c["single"] > 0, c
        assert c["flops"] * c["n"] >= c["single"], c


def test_decode_cell_splits_no_sequence_dim(cells):
    for c in cells:
        if c["shape"] != "train_s":
            assert c["n_cache"] > 0 and not c["seq_split"], c
