"""Production dry-run: one rank's step of every (arch x shape x mesh) cell
on the production meshes, with no device and no allocation
(counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's analyses. Here the step runs eagerly as one rank
of the mesh would run it: a fake process group of 256 (``pod``) or 512
(``multipod``) ranks, whose collectives move nothing, a ``DeviceMesh``
over it (:func:`repro_torch.launch.mesh.make_production_mesh` on
``"cpu"``), and every tensor a ``FakeTensor`` (shapes and types only).
The parameters, moments, batch and caches are DTensors placed as
``train`` / ``generate`` place them (:func:`~repro_torch.parallel.shard_params`,
:func:`~repro_torch.parallel.cache_pspecs`). For each cell it records:

* ``argument_bytes``: the rank's parameters, optimizer state, batch and
  cache, exact from its local shards;
* ``peak_temp_bytes``: the peak of the live tensor bytes the step makes
  (the counterpart of ``temp_size_in_bytes``), followed through a
  dispatch mode, each storage counted once (a DTensor's by its local
  tensor);
* ``flops``: the rank's FLOPs (``torch.utils.flop_counter``: products,
  convolutions, attention);
* ``collectives``: counts and result bytes per kind (all-gather,
  all-reduce, reduce-scatter, all-to-all, permute), from the collectives
  the dispatch mode sees (DTensor's and :mod:`repro_torch.parallel.spmd`'s
  functional collectives, ``torch.distributed``'s own).

The budget is the card's memory, not the reference's 16 GiB of HBM:
``torch.cuda.get_device_properties(0).total_memory`` where a card is
present, else :data:`CARD_BYTES`, the value an H100 run recorded. A
decode cell whose arguments exceed it is run again with an fp8 cache, as
the reference does.

What has no counterpart: ``cpu_upcast_bytes`` and the HLO regexes (no
compiler output to read), and ``estimate_cost``'s extrapolation, which
exists because XLA counts a scanned layer once: eager counting sees every
layer. A train cell with gradient accumulation (the reference's rule:
microbatches until the activation stack is under 4 GiB a device) runs one
microbatch; its FLOPs and collectives are multiplied by their count (the
microbatches are identical in shape), the update's counted once.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, get_smoke_config
from repro_torch.configs.base import ModelConfig, ShapeConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

#: the card's memory (``torch.cuda.get_device_properties(0).total_memory``
#: on an NVIDIA H100 80GB HBM3), the budget where no card is present
CARD_BYTES = 85_017_493_504
CARD_NAME = "NVIDIA H100 80GB HBM3"

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "permute")


def card_budget():
    """(bytes, name) of the budget: this host's card, else the H100's."""
    if torch.cuda.is_available():
        return (int(torch.cuda.get_device_properties(0).total_memory),
                torch.cuda.get_device_name(0))
    return CARD_BYTES, CARD_NAME


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "pure full-attention arch: 500k decode needs sub-quadratic mixing"
    return None


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------


def init_fake_group(world: int) -> None:
    """A process group of ``world`` ranks whose collectives move nothing,
    this process being rank 0 (the layouts are uniform: every rank's
    counts are the same); an existing default group is destroyed."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    except ImportError:  # register the backend from the C++ class ourselves
        from torch._C._distributed_c10d import FakeProcessGroup

        dist.Backend.register_backend(
            "fake", lambda store, r, size, timeout: FakeProcessGroup(r, size),
            devices=["cpu"])
        store = dist.HashStore()
    dist.init_process_group("fake", store=store, rank=0, world_size=world)


@contextlib.contextmanager
def fake_mode():
    """A ``FakeTensorMode`` for one cell. The per-device caches of the
    model stack (RoPE's inverse frequencies) are cleared on entry and on
    exit, so no fake tensor outlives the mode in them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import layers

    layers._inv_freq.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        layers._inv_freq.cache_clear()


# ---------------------------------------------------------------------------
# inputs (full arrays; the model takes each rank's block)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)} of a cell's batch (``dryrun.py:58``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": ((b, s, cfg.frontend_dim), torch.bfloat16),
                    "targets": ((b, s), i32)}
        if cfg.family == "vlm":
            t = s - cfg.frontend_len
            return {"tokens": ((b, t), i32), "targets": ((b, t), i32),
                    "patches": ((b, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16)}
        return {"tokens": ((b, s), i32), "targets": ((b, s), i32)}
    return {"tokens": ((b, 1), i32), "positions": ((b, 1), i32)}


def batch_pspecs_for(cfg: ModelConfig, shape: ShapeConfig, par) -> dict:
    """The batch's partition specs: rows over the dp axes where the global
    batch divides them (``dryrun.py:86``)."""
    from repro_torch.parallel.sharding import PSpec

    dp = par.dp_axes if par.dp_for(shape.global_batch) is not None else None
    return {name: PSpec(dp, *([None] * (len(shp) - 1)))
            for name, (shp, _) in input_specs(cfg, shape).items()}


def grad_accum_steps(cfg: ModelConfig, shape: ShapeConfig, par) -> int:
    """The reference's rule (``dryrun.py:124-130``): microbatches until the
    per-microbatch activation stack (layers x rows a device x seq x d_model
    x 2 bytes) is under 4 GiB a device."""
    act = cfg.n_layers * (shape.global_batch / max(1, par.dp_size)) * shape.seq_len \
        * cfg.d_model * 2
    k = 1
    while act / k > 4 * 2 ** 30 and k < shape.global_batch:
        k *= 2
    return k


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _kind(func) -> Optional[str]:
    name = str(getattr(func, "overloadpacket", func)).lower()
    if "c10d" not in name:
        return None
    for keys, kind in ((("all_gather", "allgather"), "all-gather"),
                       (("reduce_scatter", "reducescatter"), "reduce-scatter"),
                       (("all_reduce", "allreduce"), "all-reduce"),
                       (("all_to_all", "alltoall"), "all-to-all"),
                       (("send", "permute"), "permute")):
        if any(k in name for k in keys):
            return kind
    return None


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except Exception:  # noqa: BLE001 — a tensor with no storage (a subclass wrapper)
        return None


def _tensors(tree):
    from torch.utils import _pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepCounter:
    """A dispatch mode that follows the live bytes of the storages a step
    makes (each counted from the op that made it until the storage itself
    is freed, whichever tensors share it; ``pinned`` storages, the
    arguments, not counted) and the collectives by kind, into the current
    :attr:`region`."""

    def __init__(self, pinned=()):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter._seen(func, args, out)
                return out

        self.mode = _Mode()
        self.pinned = set(pinned)
        self.refs = {}
        self.live = 0
        self.peak = 0
        self.region = "step"
        self.coll = {}

    def _seen(self, func, args, out):
        from torch.distributed.tensor import DTensor

        # a DTensor is a wrapper: its local tensor holds the memory (the
        # local ops of a DTensor op run below this mode, unseen)
        outs = [t._local_tensor if isinstance(t, DTensor) else t for t in _tensors(out)]
        kind = _kind(func)
        if kind is not None and "wait" not in str(func):
            ts = outs or _tensors(args)[:1]
            reg = self.coll.setdefault(self.region, {"bytes": dict.fromkeys(KINDS, 0),
                                                     "counts": dict.fromkeys(KINDS, 0)})
            reg["bytes"][kind] += sum(t.numel() * t.element_size() for t in ts)
            reg["counts"][kind] += 1
        for t in outs:
            key = _storage_key(t)
            if key is None or key in self.pinned or key in self.refs:
                continue
            st = t.untyped_storage()  # one Python object a storage, while it lives
            self.refs[key] = n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        n = self.refs.pop(key, None)
        if n is not None:
            self.live -= n

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _local_keys(tree):
    from torch.distributed.tensor import DTensor

    return {_storage_key(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree)}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, remat: str = "dots"):
    """The cell's arguments (DTensors of fake tensors, placed as the
    entry points place them) and its step as regions run one after
    another, each a function of the previous one's result: ``(args,
    [(region, fn), ...], k_acc)``. Call it under a ``FakeTensorMode``."""
    from repro_torch.models import (decode_step, forward, init_cache, loss_fn, model_init,
                                    param_specs, prefill)
    from repro_torch.optim import OptConfig, opt_init, opt_update
    from repro_torch.optim.adamw import leaves, map_tree
    from repro_torch.parallel import make_parallelism
    from repro_torch.parallel.sharding import build_param_pspecs, shard_tree

    par = make_parallelism(mesh, ep=cfg.moe is not None, remat=remat)
    train = shape.kind == "train"
    meta = model_init(None, cfg, "meta", torch.float32 if train else None)
    pspecs = build_param_pspecs(meta, param_specs(cfg), mesh)
    params = shard_tree(map_tree(lambda m: torch.empty(m.shape, dtype=m.dtype), meta),
                        pspecs, mesh)
    specs = input_specs(cfg, shape)
    full = {k: torch.zeros(shp, dtype=dt) for k, (shp, dt) in specs.items()}
    batch = shard_tree(dict(full), batch_pspecs_for(cfg, shape, par), mesh)

    if train:
        oc = OptConfig(total_steps=10_000)
        opt_state = opt_init(params)
        k_acc = grad_accum_steps(cfg, shape, par)
        mb = {k: v[: v.shape[0] // k_acc] for k, v in full.items()}
        ps = leaves(params)

        def grads(_):
            for t in ps:
                t.requires_grad_(True)
            loss = loss_fn(params, mb, cfg, par=par, remat=remat)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
            for t in ps:
                t.requires_grad_(False)
            gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, ps)]
            if k_acc > 1:  # the accumulator the reference's scan carries
                gs = [g + torch.zeros_like(g) for g in gs]
            return gs

        def update(gs):
            opt_update(gs, opt_state, ps, oc)

        return ({"params": params, "opt_state": opt_state, "batch": batch},
                [("microbatch", grads), ("update", update)], k_acc)

    if cfg.is_encoder_only:
        return ({"params": params, "batch": batch},
                [("step", lambda _: forward(params, full, cfg, par=par))], 1)

    cache = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu", par=par)
    if shape.kind == "prefill":
        return ({"params": params, "batch": batch, "cache": cache},
                [("step", lambda _: prefill(params, full, cache, cfg, par=par))], 1)

    def serve(_):
        logits, _ = decode_step(params, full["tokens"], cache, cfg,
                                positions=full["positions"], par=par)
        return logits.to_local().argmax(dim=-1)

    return {"params": params, "batch": batch, "cache": cache}, [("step", serve)], 1


def run_cell(arch: str, shape_name, mesh_kind: str, *, remat: str = "dots",
             cache_dtype: Optional[str] = None, smoke: bool = False,
             layers: Optional[int] = None) -> dict:
    """One cell's record (the module docstring). ``shape_name``: a name of
    :data:`SHAPES`, or a :class:`ShapeConfig`; ``mesh_kind``: ``pod``,
    ``multipod``, or ``<data>x<model>`` for a (data, model) mesh of that
    shape (a host of cards, e.g. ``4x1``)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cache_dtype:
        cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else get_shape(shape_name)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind, "kind": shape.kind,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "n_layers": cfg.n_layers, "smoke": smoke, "remat": remat}
    reason = cell_skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    multi = mesh_kind == "multipod"
    host = None if mesh_kind in ("pod", "multipod") else tuple(
        int(v) for v in mesh_kind.split("x"))
    world = 512 if multi else 256 if host is None else host[0] * host[1]
    if not (dist.is_initialized() and dist.get_world_size() == world):
        init_fake_group(world)
    if host is None:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    else:
        from repro_torch.parallel.sharding import init_mesh

        mesh = init_mesh("cpu", host, ("data", "model"))
    t0 = time.time()
    flops = {}
    with fake_mode():
        args, regions, k_acc = build_cell(cfg, shape, mesh, remat=remat)
        arg_bytes = _local_bytes(args)
        counter = StepCounter(pinned=_local_keys(args))
        out = None
        with counter:
            for region, fn in regions:
                counter.region = region
                with FlopCounterMode(display=False) as fc:
                    out = fn(out)
                flops[region] = int(fc.get_total_flops())
        del out
    budget, budget_of = card_budget()
    coll = {"bytes": dict.fromkeys(KINDS, 0), "counts": dict.fromkeys(KINDS, 0)}
    for region, reg in counter.coll.items():
        times = k_acc if region == "microbatch" else 1
        for k in KINDS:
            coll["bytes"][k] += reg["bytes"][k] * times
            coll["counts"][k] += reg["counts"][k] * times
    coll["total_bytes"] = sum(coll["bytes"].values())
    total = arg_bytes + counter.peak
    rec.update({
        "status": "ok",
        "n_chips": world,
        "seconds": round(time.time() - t0, 1),
        "grad_accum": k_acc,
        "memory": {"argument_bytes": arg_bytes, "peak_temp_bytes": counter.peak,
                   "per_device_total_bytes": total, "budget_bytes": budget,
                   "budget_of": budget_of, "fits": total <= budget},
        "flops": sum(v * (k_acc if r == "microbatch" else 1) for r, v in flops.items()),
        "flops_by_region": flops,
        "collectives": coll,
    })
    if cfg.cache_dtype:
        rec["kv_cache_dtype"] = cfg.cache_dtype
    return rec


def _shape(name: str, args) -> ShapeConfig:
    s = get_shape(name)
    if args.seq_len is None and args.batch is None:
        return s
    return dataclasses.replace(s, seq_len=args.seq_len or s.seq_len,
                               global_batch=args.batch or s.global_batch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    help="pod, multipod, both, or <data>x<model> (e.g. 4x1)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this")
    ap.add_argument("--seq-len", type=int, default=None, help="the shape's, else")
    ap.add_argument("--batch", type=int, default=None, help="the shape's global batch, else")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_dir = os.path.abspath(args.out or OUT_DIR)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s.name) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    failures = 0
    records = []
    for mesh_kind in meshes:
        os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
        for arch, shape in cells:
            path = os.path.join(out_dir, mesh_kind, f"{arch}__{shape}.json")
            try:
                rec = run_cell(arch, _shape(shape, args), mesh_kind, remat=args.remat,
                               smoke=args.smoke, layers=args.layers)
                mem = rec.get("memory", {})
                if (rec.get("status") == "ok" and rec.get("kind") == "decode"
                        and mem["argument_bytes"] > mem["budget_bytes"]):
                    # the cache alone exceeds the card: again with an fp8 cache
                    rec = run_cell(arch, _shape(shape, args), mesh_kind, remat=args.remat,
                                   cache_dtype="float8_e4m3fn", smoke=args.smoke,
                                   layers=args.layers)
            except Exception:  # noqa: BLE001 — recorded, and counted as a failure
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "status": "error", "trace": traceback.format_exc()}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            records.append(rec)
            extra = ""
            if rec["status"] == "ok":
                m = rec["memory"]
                extra = (f" args/dev={m['argument_bytes'] / 2**30:.2f}GiB"
                         f" peak/dev={m['per_device_total_bytes'] / 2**30:.2f}GiB"
                         f" flops/dev={rec['flops']:.4g}"
                         f" coll/dev={rec['collectives']['total_bytes'] / 2**30:.3f}GiB"
                         f" accum={rec['grad_accum']} {rec['seconds']}s")
            elif rec["status"] == "skipped":
                extra = f" ({rec['reason']})"
            print(f"[dryrun] {mesh_kind}/{arch}__{shape}: {rec['status']}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return records


if __name__ == "__main__":
    main()
