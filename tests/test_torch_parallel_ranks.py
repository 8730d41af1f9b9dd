"""The rank programs of ``tests/test_torch_parallel.py``, and the tests of
the port's distribution layer that need neither JAX nor a process group.

``run_groups`` starts ``world`` gloo ranks (``torch.multiprocessing``,
start method ``forkserver``, one CPU thread each) over a (1, world) mesh named
("data", "model"), for every world asked at once. Every rank runs every case of :data:`CASES` on the
same inputs (numpy arrays made by the parent) and saves what it returned;
a case that raises saves its traceback instead, so one failing case
fails one test. This module imports no JAX: the spawned ranks import it.
"""
import datetime
import os
import shutil
import tempfile
import threading
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import moe as t_moe
from repro_torch.parallel import (Parallelism, PSpec, compress, compressed_psum, init_mesh,
                                  make_parallelism, pipeline_apply, sample_merge_k,
                                  sample_sort, to_named)
from repro_torch.serving.sample import sample_topk, sample_topp
from repro_torch.streaming.tree import tree_topk

# ---------------------------------------------------------------------------
# the MoE layer of the EP cases (d_model 16, 8 experts, top-2, no drops)
# ---------------------------------------------------------------------------

MOE_LAYER = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                 d_ff=32, vocab_size=64, dtype="float32")
MOE_BLOCK = dict(n_experts=8, top_k=2, d_expert=8, router_block=4, capacity_factor=8.0)


def moe_cfg(dispatch="scatter"):
    return ModelConfig(moe=MoEConfig(**MOE_BLOCK, dispatch=dispatch), **MOE_LAYER)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _moe_params(inp):
    return {name: {"w": _t(inp[f"moe_{name}"])} for name in ("router", "wi", "wg", "wo")}


# ---------------------------------------------------------------------------
# the cases: (name, function of (par, inputs) -> tensors, expert-parallel)
# ---------------------------------------------------------------------------


def _sort_ties(par, inp):
    return sample_sort(_t(inp["ties"]), mesh=par.mesh, axis_name="model")[0]


def _sort_ties_pos(par, inp):
    x = _t(inp["ties"])
    iota = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape).contiguous()
    return sample_sort(x, mesh=par.mesh, axis_name="model", pos=iota)


def _merge_lists(inp):
    return [_t(inp[f"list{i}"]) for i in range(3)]


def _merge_ties(par, inp):
    return sample_merge_k(_merge_lists(inp), mesh=par.mesh, axis_name="model")[0]


def _merge_ties_pos(par, inp):
    lists = _merge_lists(inp)
    offs = np.cumsum([0] + [t.shape[1] for t in lists])
    pos = [(torch.arange(t.shape[1], dtype=torch.int32) + int(o)).expand(t.shape).contiguous()
           for t, o in zip(lists, offs)]
    return sample_merge_k(lists, mesh=par.mesh, axis_name="model", pos=pos)


def _ops_sort(par, inp):
    x = _t(inp["floats"])
    iota = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape)
    return (repro_torch.sort(x, par=par, backend="sharded"),
            *repro_torch.sort(x, par=par, backend="sharded", payload=iota),
            *repro_torch.sort(x, par=par, backend="sharded", payload=iota, stable=True,
                              descending=True))


def _ops_merge(par, inp):
    lists = [_t(inp[f"flist{i}"]) for i in range(3)]
    ids = [_t(inp[f"fid{i}"]) for i in range(3)]
    return (repro_torch.merge_k(lists, par=par, backend="sharded"),
            *repro_torch.merge_k(lists, par=par, backend="sharded", payload=ids),
            repro_torch.merge(lists[0], lists[1], par=par, backend="sharded"))


def _ops_topk(par, inp):
    return repro_torch.topk(_t(inp["logits"]), 8, par=par)


def _sampler(par, inp):
    logits = _t(inp["logits"])
    return (sample_topk(logits, k=8, temperature=0.7, par=par, gumbel=_t(inp["g8"])),
            sample_topk(logits, k=list(inp["ks"]), temperature=0.7, par=par,
                        gumbel=_t(inp["gks"])),
            sample_topp(logits, p=0.8, k_max=8, temperature=0.7, par=par,
                        gumbel=_t(inp["g8"])))


def _tree(par, inp):
    return tree_topk(_t(inp["tree"]), 16, mesh=par.mesh, axis="model")


def _pipeline(par, inp):
    params = {"w": _t(inp["pipe_w"]), "b": _t(inp["pipe_b"])}
    return pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params,
                          _t(inp["pipe_x"]), par.mesh, axis="model")


def _compress(par, inp):
    me = par.coordinate("model")
    g, e = _t(inp["grad"][me]), _t(inp["err"][me])
    q, s = compress(g + e)
    return (q, s, *compressed_psum(g, par.group("model"), e))


def _moe(par, inp):
    p = _moe_params(inp)
    out = []
    for dispatch in ("scatter", "sorted"):
        cfg = moe_cfg(dispatch)
        for x in (_t(inp["moe_prefill"]), _t(inp["moe_decode"])):
            out += [t_moe.moe_apply(p, x, cfg, par=par), t_moe.moe_apply(p, x, cfg)]
    return tuple(out)


def _moe_refusals(par, inp):
    cfg = moe_cfg()
    caps = ModelConfig(moe=MoEConfig(**MOE_BLOCK, expert_capacities=(32,) * 8), **MOE_LAYER)
    p, x = _moe_params(inp), _t(inp["moe_prefill"])
    msgs = []
    for call in (lambda: t_moe.moe_apply(p, x, caps, par=par),
                 lambda: t_moe.moe_ffn_local(p, x[0], cfg, axis_name=par.group("model"),
                                             ep_size=3)):
        try:
            call()
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    return np.array(msgs)


def _plan(par, inp):
    """The routes ``plan`` takes with this ``par``: (op, backend) rows."""
    from repro_torch.api import SortSpec, plan
    from repro_torch.parallel import dist_sort_axis, vocab_topk_axis

    sharded = dist_sort_axis(par, (1 << 20,)) is not None
    rows = [plan(SortSpec(op="sort", lengths=(1 << 20,), batch=8, device="cpu",
                          sharded=sharded), par).backend,
            plan(SortSpec(op="merge_k", lengths=(50_000,) * 4, device="cpu",
                          sharded=dist_sort_axis(par, (50_000,) * 4) is not None), par).backend,
            plan(SortSpec(op="topk", lengths=(151_936,), k=64, batch=4, device="cpu",
                          sharded=vocab_topk_axis(par, 151_936) is not None), par).backend]
    return np.array(rows)


CASES = (
    ("sort_ties", _sort_ties, False), ("sort_ties_pos", _sort_ties_pos, False),
    ("merge_ties", _merge_ties, False), ("merge_ties_pos", _merge_ties_pos, False),
    ("ops_sort", _ops_sort, False), ("ops_merge", _ops_merge, False),
    ("ops_topk", _ops_topk, False), ("sampler", _sampler, False), ("tree", _tree, False),
    ("pipeline", _pipeline, False), ("compress", _compress, False), ("moe", _moe, True),
    ("moe_refusals", _moe_refusals, True), ("plan", _plan, False),
)


def _numpy(out):
    if isinstance(out, torch.Tensor):
        return out.numpy()
    if isinstance(out, (tuple, list)):
        return tuple(_numpy(o) for o in out)
    return out


def _rank_main(rank, world, rdv, inputs, out_dir):
    os.environ["REPRO_RESILIENCE"] = "0"  # a failed rung raises: no rank degrades alone
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        par = make_parallelism(init_mesh("cpu", (1, world)))
        res = {}
        for name, fn, ep in CASES:
            if ep and MOE_BLOCK["n_experts"] % world:
                continue  # the experts do not split over this axis
            try:
                res[name] = _numpy(fn(par, inputs))
            except Exception:  # noqa: BLE001 — the parent's test reports it
                res[name] = "error: " + traceback.format_exc()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_groups(inputs: dict):
    """Start one gloo group a world of ``inputs`` ({world: inputs}), all at
    once, and return ``wait()``, which joins them and returns {world:
    every rank's results (one dict a rank)}; the caller may work while
    the ranks run. The ranks are forked from a fresh server process that
    imported this module once (``forkserver``: nothing of the test
    process, JAX's threads included, is inherited, and no rank imports
    torch again)."""
    mp.set_forkserver_preload([__name__])
    d = tempfile.mkdtemp()
    ctxs = {}

    def start():  # blocks until the server has imported this module
        for w, inp in inputs.items():
            out = os.path.join(d, f"world{w}")
            os.mkdir(out)
            ctxs[w] = mp.start_processes(
                _rank_main, args=(w, os.path.join(out, "rendezvous"), inp, out), nprocs=w,
                join=False, start_method="forkserver")

    starter = threading.Thread(target=start)
    starter.start()

    def wait() -> dict:
        starter.join()
        try:
            for ctx in ctxs.values():
                while not ctx.join():
                    pass
            return {w: [torch.load(os.path.join(d, f"world{w}", f"rank{r}.pt"),
                                   weights_only=False) for r in range(w)] for w in inputs}
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return wait


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------


class _StandIn:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 4}


def test_parallelism_sizes_and_splits():
    par = make_parallelism(_StandIn())
    assert (par.dp_axes, par.tp_axis, par.dp_size, par.tp_size) == (("data",), "model", 2, 4)
    assert par.dp_for(8) == ("data",) and par.dp_for(3) is None
    assert par.tp_for(12) == "model" and par.tp_for(2) is None
    with pytest.raises(ValueError, match="lacks axis 'pod'"):
        par.constrain(torch.zeros(2), "pod")


def test_to_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    tree = {"w": PSpec("data", "model"), "b": [PSpec(None, "model"), PSpec()],
            "x": PSpec(("data",), None)}
    got = to_named(tree, _StandIn())
    assert got["w"] == (Shard(0), Shard(1))
    assert got["b"] == [(Replicate(), Shard(1)), (Replicate(), Replicate())]
    assert got["x"] == (Shard(0), Replicate())


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh("cuda", (1, 1))
    with pytest.raises(ValueError, match="device_type"):
        init_mesh("tpu", (1, 1))
    assert Parallelism(mesh=_StandIn()).tp_size == 4
