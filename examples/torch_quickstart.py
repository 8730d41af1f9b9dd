"""Quickstart of the PyTorch port: the paper's List Offset Merge Sorters
behind one namespace.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``repro_torch.merge / merge_k / sort / topk / median_of_lists``: callers
state *what* to sort (any axis, either direction, stable or not, payloads
of any pytree riding the permutation) and the planner picks *how*: the
schedule executor, a CUDA kernel, the chunked streaming pipeline. The
counterpart of ``examples/quickstart.py``; it runs on the card unless
``--device cpu`` asks for the CPU, and returns what it checked.
"""
import argparse

import numpy as np
import torch

import repro_torch
from repro_torch import SortSpec
from repro_torch.api import schedules
from repro_torch.core import comparator_count, depth, loms_2way, loms_kway
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    checks = {}

    def on_dev(x):
        return torch.as_tensor(x).to(dev)

    # --- 2-way merge: any UP-x/DN-y mixture, always a 2-stage device ------
    a = torch.sort(on_dev(rng.integers(0, 100, 7).astype(np.int32))).values
    b = torch.sort(on_dev(rng.integers(0, 100, 5).astype(np.int32))).values
    merged = repro_torch.merge(a, b)
    print("UP-7/DN-5 merged:", merged.tolist())
    print("  LOMS stages:", depth(loms_2way(7, 5)),
          "| Batcher 8+8 stages:", depth(schedules.merge_schedule(8, 8, "batcher-oe")))
    checks["merge2"] = torch.equal(merged, torch.sort(torch.cat([a, b])).values)

    # --- 3-way merge + 2-stage median (paper Fig. 6) ----------------------
    lists = [torch.sort(on_dev(rng.integers(0, 100, 7).astype(np.int32))).values
             for _ in range(3)]
    merged3 = repro_torch.merge_k(lists)
    median = repro_torch.median_of_lists(lists)
    print("3c_7r merged:", merged3.tolist())
    print("median after 2 stages:", int(median))
    s3 = loms_kway((7, 7, 7))
    print("  stages:", depth(s3), "comparators:", comparator_count(s3))
    want3 = torch.sort(torch.cat(lists)).values
    checks["merge_k"] = torch.equal(merged3, want3)
    checks["median"] = int(median) == int(want3[10])

    # --- uniform semantics: axis, descending, stable, pytree payloads -----
    x = on_dev(rng.standard_normal((4, 160)).astype(np.float32))
    col_sorted = repro_torch.sort(x, axis=0, descending=True)  # sort each column
    checks["axis0_descending"] = bool((torch.diff(col_sorted, dim=0) <= 0).all())
    print("axis=0 descending sort ok:", checks["axis0_descending"])
    toks = on_dev(rng.integers(0, 50, 12).astype(np.int32))
    emb = on_dev(rng.standard_normal((12, 8)).astype(np.float32))
    pos = torch.arange(12, dtype=torch.int32, device=dev)
    sorted_toks, carried = repro_torch.sort(toks, stable=True,
                                            payload={"emb": emb, "pos": pos})
    print("pytree payload rides the permutation:", tuple(sorted_toks.shape),
          tuple(carried["emb"].shape), carried["pos"][:4].tolist())
    order = torch.sort(toks, stable=True).indices
    checks["stable_payload"] = (torch.equal(sorted_toks, toks[order])
                                and torch.equal(carried["pos"], pos[order])
                                and torch.equal(carried["emb"], emb[order]))

    # --- top-k (the MoE-router / sampler primitive), planner-routed -------
    v, i = repro_torch.topk(x, 6)
    print("router top-6 values:", np.round(v[0].cpu().numpy(), 2))
    checks["topk"] = torch.equal(v, torch.gather(x, 1, i.long())) and torch.equal(
        v, torch.topk(x, 6).values)
    checks["sort"] = bool((repro_torch.sort(x).cpu().numpy()
                           == np.sort(x.cpu().numpy(), -1)).all())
    print("full sort matches numpy:", checks["sort"])

    # --- the dispatch layer is inspectable --------------------------------
    plans = {}
    for spec in (
        SortSpec(op="topk", lengths=(x.shape[-1],), k=6, batch=4, device="cpu"),
        SortSpec(op="topk", lengths=(152_064,), k=64, batch=8, device="cuda"),
        SortSpec(op="merge", lengths=(100_000, 100_000), device="cuda"),
    ):
        d = repro_torch.plan(spec)
        plans[spec.describe()] = f"{d.backend}/{d.detail}"
        print(f"plan {spec.describe():42s} -> {d.backend}/{d.detail}")
    return {"checks": checks, "plans": plans}


if __name__ == "__main__":
    main()
