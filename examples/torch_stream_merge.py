"""Streaming walkthrough of the PyTorch port: chunked merges, the planner,
the tree top-k and the autotune cache.

  PYTHONPATH=src python examples/torch_stream_merge.py [--n 100000] [--cache PATH] [--device cpu]

Merges two sorted streams of ``--n`` elements through the planner, 4-way
merges ragged shard lists, scores a tree top-k against ``torch.topk`` and
autotunes a 2-way merge into the cache at ``--cache`` (by default a file
under the system's temporary directory). The counterpart of
``examples/stream_merge.py``; it runs on the card unless ``--device cpu``
asks for the CPU, and returns what it checked.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

import repro_torch
from repro_torch import SortSpec
from repro_torch.device import resolve_device
from repro_torch.streaming import autotune_merge2, chunked_merge_k, plan_chunked
from repro_torch.streaming.cache import AutotuneCache
from repro_torch.streaming.tree import tree_topk


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000, help="length of each stream")
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(),
                                                    "repro_torch_example_autotune.json"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    checks = {}

    def sorted_f32(n):
        return torch.sort(torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                                           ).to(dev)).values

    # 1) two sorted streams far larger than any single kernel tile: the
    #    planner routes the merge to the chunked pipeline itself
    a, b = sorted_f32(args.n), sorted_f32(args.n)
    dec = repro_torch.plan(SortSpec(op="merge", lengths=(args.n, args.n), device=dev.type))
    plan = plan_chunked(args.n, args.n, batch=1)
    out = repro_torch.merge(a, b)
    checks["merge"] = torch.equal(out, torch.sort(torch.cat([a, b])).values)
    print(f"repro_torch.merge -> {dec.backend}/{dec.detail}: merged {out.shape[-1]} elems "
          f"in {plan.tile}-wide tiles, sorted={checks['merge']}")

    # 2) k-way: ragged per-shard candidate lists
    lists = [sorted_f32(n) for n in (5000, 1234, 777, 4096)]
    outk = chunked_merge_k(lists, tile=128)
    checks["merge_k"] = torch.equal(outk, torch.sort(torch.cat(lists)).values)
    print(f"chunked 4-way: {outk.shape[-1]} elems, sorted={checks['merge_k']}")

    # 3) tree top-k (the single-device log-tree here; pass mesh / axis on a
    #    TP-sharded vocab to reduce over ranks)
    logits = torch.from_numpy(rng.standard_normal((4, 32_000)).astype(np.float32)).to(dev)
    vals, idx = tree_topk(logits, 32)
    checks["tree_topk"] = torch.equal(vals, torch.topk(logits, 32).values) and torch.equal(
        vals, torch.gather(logits, 1, idx.long()))
    print(f"tree top-k: values equal torch.topk's = {checks['tree_topk']}")

    # 4) planner autotune: measure once, cached on disk afterwards
    cache = AutotuneCache(args.cache)
    tuned = autotune_merge2(256, 256, batch=8, cache=cache, device=dev)
    again = autotune_merge2(256, 256, batch=8, cache=cache, device=dev)
    checks["autotune_cached"] = again.source == "cache"
    print(f"autotune: picked network={tuned.network} n_cols={tuned.n_cols} "
          f"(source={tuned.source}); second call source={again.source}")
    return {"checks": checks, "tuned": tuned, "again": again}


if __name__ == "__main__":
    main()
