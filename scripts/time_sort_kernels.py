#!/usr/bin/env python3
"""Time the port's sort and merge kernels on one CUDA card at the shapes
of their main paths, for one copy of the port's package:

  python3 scripts/time_sort_kernels.py [--src DIR] [--label NAME] [--lanes N]
                                       [--kernels 2,6,8,1,9,5] [--breakdown]

``--kernels`` names the kernel rows to time (default ``2,6``): row 2 the
fused sort and row 6 the class sort at their five shapes; row 8 the k-way
merge (3 x 7 f32 over 1,048,576 rows and its median, the 5 x 7 median,
4 x 64 bf16 descending with int32 ids over 65,536 rows, 8 x 128 int32 over
16,384 rows, the 65,536 segment rows of ``chunked_merge_k`` of 8 x 2^20,
(100, 50, 25) f32 over 65,536 rows); row 1 the 2-way merge ((65,536,
32 + 32) f32, (4,096, 512 + 512) f32 descending with ids, (64, 65,536 +
32) f32). Rows 8 and 1 also print, per shape, one PyTorch call on the
same input (``torch.sort`` (+ a gather of the ids) or ``torch.kthvalue``:
a yardstick, never the port's path) and the bound: the larger of the
bytes over 3.35 TB/s and two int32 instructions a comparison over the
card's int32 peak (SMs x 64 lanes x top SM clock), as chip_smoke.py
counts them.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two versions of the package (say a
parent commit unpacked with ``git archive``) can be timed in turns, one after
the other on one card. Each shape prints one JSON line: the device time
of one call in ms (a CUDA graph of the call replayed between two CUDA
events), the label, and the card's name and power limit as nvidia-smi
reports them. ``--lanes`` forces the lanes a thread of the sort executor
(a package that has one). ``--breakdown`` times instead, with row 2 asked,
the fused sort of 2^24 bf16 lanes with an int32 payload cut into rows of
64 to 1024: at 64 the loms tree is its six S2MS levels alone, and each
doubling adds one column-device level, so the differences are the
levels' costs; with row 8 asked, the k-way merge of 8 x 128 int32 over
16,384 rows, of 4 x 64 bf16 descending with ids over 65,536 rows and of
3 x 7 f32 over 1,048,576 rows cut after each stage (``n_stages``), so the
differences are the stages' costs; with row 9 asked, the grid merge at
(8, 2^22 + 2^22) cut into its split pass and its merge (a package that
has the split pass), and the values-only spill level by level; with row 5
asked, the vocab merge tree at (4, 151,936) k 64 cut into its two passes,
and the whole tree at subtrees of 32, 64 and 128 lists and 256, 512 and
1024 threads a CTA (a package whose tree has them). ``--grid-items`` forces the outputs a
thread of the grid merge takes (its tile: 256 times that). Row 9
(``--kernels 9``): ``grid_chunked_merge2`` at (8, 2^22 + 2^22) int32
(tied keys, and uniform random keys), ``repro_torch.merge`` of 100,000 +
100,000 f32, the whole values-only ``segment_sort`` of 16 x 65,536 f32
(eager: the call from Python, host cost included) and each level of its
spill alone, with the grid-merge launches of each; the yardstick is
``torch.sort`` of the same rows. Row 5 (``--kernels 5``): the vocab merge
tree after phase 1 at (1, 4, 8) x 151,936 bf16, k 64 (block 64, 12
levels) and at (4, 151,936) k 64 with block 16 (lists of 16 that grow to
64), with its launches; the yardstick is ``torch.topk`` of the phase-1
lists. Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def tile(rows, n, dtype, seed):
    """Heavy ties; floats also NaN, ±inf and -0.0 (chip_smoke.seg_tile's mix)."""
    import torch

    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-3, 4, (rows, n)).astype(np.int32)).cuda()
    x = (rng.integers(-3, 4, (rows, n)) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random((rows, n)) < frac] = val
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def sorted_lists(rows, lens, dtype, seed, descending=False):
    """``tile`` rows cut into lists, each sorted in the total order of its
    keys (NaN last, -0.0 below +0.0), concatenated: (rows, sum(lens))."""
    import torch

    from repro_torch.kernels.common import encode_key_values

    out = []
    for j, n in enumerate(lens):
        x = tile(rows, n, dtype, seed + j)
        keys = encode_key_values(x) if dtype.is_floating_point else x
        order = torch.argsort(keys, dim=-1, stable=True)
        if descending:
            order = order.flip(-1)
        out.append(torch.gather(x.view(torch.int16) if x.element_size() == 2 else x, 1, order)
                   .view(dtype))
    return torch.cat(out, dim=1).contiguous()


def kway_cases(ops_per_s):
    """Row 8 at its main paths' shapes: (name, iters, kernel call, PyTorch
    call, its name, bound ms)."""
    import torch

    from repro_torch.kernels.kway import kway_merge
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import kway_schedule, median_schedule

    lg = lambda k: max(k - 1, 1).bit_length()  # noqa: E731  ceil(log2 k)
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    cases = []
    for name, rows, lens, dt, desc, ids, median in (
            ("row 8 3 x 7 f32 (1048576 rows)", 1 << 20, (7, 7, 7), f32, False, False, False),
            ("row 8 3 x 7 f32 median (1048576 rows)", 1 << 20, (7, 7, 7), f32, False, False,
             True),
            ("row 8 5 x 7 int32 median (1048576 rows)", 1 << 20, (7,) * 5, i32, False, False,
             True),
            ("row 8 4 x 64 bf16 desc + int32 ids (65536 rows)", 65_536, (64,) * 4, bf16, True,
             True, False),
            ("row 8 8 x 128 int32 (16384 rows)", 16_384, (128,) * 8, i32, False, False, False),
            ("row 8 8 x 128 int32 (65536 rows: the chunked_merge_k segments)", 65_536,
             (128,) * 8, i32, False, False, False),
            ("row 8 (100, 50, 25) f32 (65536 rows)", 65_536, (100, 50, 25), f32, False, False,
             False)):
        x = sorted_lists(rows, lens, dt, sum(lens), desc)
        total = x.shape[1]
        lanes = ((torch.arange(rows * total, dtype=i32, device="cuda").reshape(rows, total),)
                 if ids else ())
        key = dt if dt.is_floating_point else None
        if median:
            sched = median_readout(*median_schedule(lens))
            kw = dict(key_dtype=key)
            mid = total // 2 + 1
            lib = ("torch.kthvalue", lambda x=x, mid=mid: torch.kthvalue(x, mid, dim=-1))
            nbytes = rows * total * x.element_size() + rows * x.element_size()
        else:
            sched = kway_schedule(lens)
            kw = dict(lens=lens, key_dtype=key, descending=desc)
            if ids:
                def lib_call(x=x, lanes=lanes, desc=desc):
                    v, i = torch.sort(x, dim=-1, descending=desc, stable=True)
                    return v, torch.gather(lanes[0], 1, i)
                lib = ("torch.sort + gather", lib_call)
            else:
                lib = ("torch.sort", lambda x=x, desc=desc: torch.sort(x, dim=-1,
                                                                         descending=desc))
            nbytes = rows * total * (x.element_size() + (4 if ids else 0)) * 2
        bound = max(nbytes / HBM_BYTES_PER_S,
                    rows * total * lg(len(lens)) * 2 / ops_per_s) * 1e3
        cases.append((name, 20, lambda x=x, sched=sched, lanes=lanes, kw=kw:
                      kway_merge(x, sched, lanes, **kw), lib, bound))
    return cases


def merge_cases(ops_per_s):
    """Row 1 at its main paths' shapes, as :func:`kway_cases`."""
    import torch

    from repro_torch.kernels.loms_merge import loms_merge2
    from repro_torch.networks import pick_merge_cols

    cases = []
    for name, rows, m, n, desc, ids in (
            ("row 1 (65536, 32 + 32) f32", 65_536, 32, 32, False, False),
            ("row 1 (4096, 512 + 512) f32 desc + int32 ids", 4096, 512, 512, True, True),
            ("row 1 (64, 65536 + 32) f32", 64, 65_536, 32, False, False)):
        a = sorted_lists(rows, (m,), torch.float32, m, desc)
        b = sorted_lists(rows, (n,), torch.float32, n + 1, desc)
        lanes = ((torch.arange(rows * (m + n), dtype=torch.int32, device="cuda")
                  .reshape(rows, m + n),) if ids else ())
        kw = dict(n_cols=pick_merge_cols(m, n), key_dtype=torch.float32, descending=desc)
        cat = torch.cat([a, b], dim=1)
        if ids:
            def lib_call(cat=cat, lanes=lanes, desc=desc):
                v, i = torch.sort(cat, dim=-1, descending=desc, stable=True)
                return v, torch.gather(lanes[0], 1, i)
            lib = ("torch.sort + gather", lib_call)
        else:
            lib = ("torch.sort", lambda cat=cat, desc=desc: torch.sort(cat, dim=-1,
                                                                     descending=desc))
        nbytes = rows * (m + n) * 8 * (2 if ids else 1)
        bound = max(nbytes / HBM_BYTES_PER_S, rows * (m + n) * 2 / ops_per_s) * 1e3
        cases.append((name, 50, lambda a=a, b=b, lanes=lanes, kw=kw:
                      loms_merge2(a, b, lanes, **kw), lib, bound))
    return cases


def grid_cases(ops_per_s):
    """Row 9 at its main paths' shapes, as :func:`kway_cases`; each case
    also says whether it is timed as a CUDA graph or eagerly."""
    import torch

    import repro_torch
    from repro_torch.kernels.common import encode_key_values
    from repro_torch.streaming.grid_merge import grid_chunked_merge2

    def bound(total, comparisons):
        return max(total * 8 / HBM_BYTES_PER_S, comparisons * 2 / ops_per_s) * 1e3

    cases = []
    f32 = torch.float32
    ka = encode_key_values(sorted_lists(8, (1 << 22,), f32, 1))
    kb = encode_key_values(sorted_lists(8, (1 << 22,), f32, 2))
    rng = np.random.default_rng(3)
    ra, rb = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (8, 1 << 22),
                                            dtype=np.int64).astype(np.int32))
              .cuda().sort(-1)[0] for _ in range(2))
    for name, a, b in (("row 9 grid_chunked_merge2 (8, 2^22 + 2^22) int32, tied keys", ka, kb),
                       ("row 9 grid_chunked_merge2 (8, 2^22 + 2^22) int32, random keys",
                        ra, rb)):
        cat = torch.cat([a, b], dim=1)
        cases.append((name, 20, lambda a=a, b=b: grid_chunked_merge2(a, b),
                      ("torch.sort", lambda cat=cat: torch.sort(cat, dim=-1)),
                      bound(cat.numel(), cat.numel()), "graph"))
    a7, b7 = (torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)).cuda()
              .sort()[0] for _ in range(2))
    cat7 = torch.cat([a7, b7])
    cases.append(("row 9 repro_torch.merge 100,000 + 100,000 f32", 50,
                  lambda: repro_torch.merge(a7, b7),
                  ("torch.sort", lambda: torch.sort(cat7)), bound(200_000, 200_000), "graph"))
    s, n = 16, 65_536
    v8 = tile(1, s * n, f32, 11).reshape(-1)
    offs8 = tuple(range(0, s * n + 1, n))
    rows8 = v8.reshape(s, n)
    cases.append(("row 9 segment_sort 16 x 65,536 f32, values only (the spill), eager", 10,
                  lambda: repro_torch.segment_sort(v8, offs8),
                  ("torch.sort", lambda: torch.sort(rows8, dim=-1)),
                  bound(s * n, s * n * 16), "eager"))
    keys = encode_key_values(tile(s, n, f32, 12))
    for lvl in range(1, 8):
        ln = 512 << (lvl - 1)
        cur = keys.reshape(s, n // ln, ln).sort(-1)[0].reshape(s, n)
        pairs = cur.reshape(s * n // (2 * ln), 2 * ln)
        cases.append((f"row 9 spill level {lvl}: ({s * n // (2 * ln)}, {ln} + {ln}) int32", 20,
                      spill_level(cur, ln),
                      ("torch.sort", lambda p=pairs: torch.sort(p, dim=-1)),
                      bound(s * n, s * n), "graph"))
    return cases


def spill_level(cur, ln):
    """One level of the values-only sort spill on the (rows, W) runs of
    length ``ln`` in ``cur``, as the imported package runs it: one launch
    (a package with ``spill_merge_level``) or one launch a pair of runs."""
    from repro_torch.segmented import core

    m = cur.shape[1] // ln
    level = getattr(core, "spill_merge_level", None)
    if level is not None:
        return lambda: level(cur, m, ln, 0, 512)
    from repro_torch.streaming.grid_merge import grid_chunked_merge2

    runs = list(cur.reshape(cur.shape[0], m, ln).unbind(1))
    if ln > 512:  # past the first level the runs are whole tensors
        runs = [r.contiguous() for r in runs]
    return lambda: [grid_chunked_merge2(runs[i].contiguous(), runs[i + 1].contiguous(),
                                        tile=512) for i in range(0, m - 1, 2)]


def vocab_cases(ops_per_s):
    """Row 5, the vocab merge tree after phase 1, as :func:`kway_cases`."""
    import torch

    from repro_torch.kernels import topk as K

    v, k = 151_936, 64
    rng = np.random.default_rng(5)
    cases = []
    for bsz, blk in ((4, 64), (1, 64), (8, 64), (4, 16)):
        x = torch.from_numpy(rng.standard_normal((bsz, v)).astype(np.float32) * 3).to(
            device="cuda", dtype=torch.bfloat16)
        keys, idx = K.vocab_phase1(x, k, blk)
        nblk, kk = keys.shape[1], keys.shape[2]
        tree = getattr(K, "vocab_merge_tree", None) or functools.partial(level_chain, K)
        flat = keys.view(bsz, nblk * kk)
        comps, g, ln = 0, nblk, kk
        while g > 1:
            comps += bsz * g * ln * max(ln, 1).bit_length()
            g, ln = g // 2, min(k, 2 * ln)
        bound = max((bsz * nblk * kk * 8 + bsz * k * 6) / HBM_BYTES_PER_S,
                    comps * 2 / ops_per_s) * 1e3
        cases.append((f"row 5 vocab merge tree ({bsz}, {v}) bf16 k {k}, block {blk} "
                      f"({nblk} lists of {kk})", 100,
                      lambda keys=keys, idx=idx, tree=tree: tree(keys, idx, k, torch.bfloat16),
                      ("torch.topk", lambda flat=flat: torch.topk(flat, k, dim=-1)), bound,
                      "graph"))
    return cases


def grid_breakdown_cases():
    """Row 9 cut into its split pass and its merge at (8, 2^22 + 2^22) (a
    package whose grid merge has the split pass), and the spill's levels."""
    import torch

    from repro_torch.kernels.common import encode_key_values
    from repro_torch.streaming import grid_merge as GM

    cases = []
    ka = encode_key_values(sorted_lists(8, (1 << 22,), torch.float32, 1))
    kb = encode_key_values(sorted_lists(8, (1 << 22,), torch.float32, 2))
    phases = getattr(GM, "grid_merge2_phases", None)
    if phases is not None:
        out, splits = phases(ka, kb)
        for what, ph in (("split pass", 1), ("merge", 2), ("split pass + merge", 3)):
            cases.append((f"row 9 (8, 2^22 + 2^22) int32, {what}", 20,
                          lambda ph=ph: phases(ka, kb, out=out, splits=splits, which=ph)))
    else:
        cases.append(("row 9 (8, 2^22 + 2^22) int32, one kernel (no split pass)", 20,
                      lambda: GM.grid_chunked_merge2(ka, kb)))
    s, n = 16, 65_536
    keys = encode_key_values(tile(s, n, torch.float32, 12))
    for lvl in range(1, 8):
        ln = 512 << (lvl - 1)
        cur = keys.reshape(s, n // ln, ln).sort(-1)[0].reshape(s, n)
        cases.append((f"row 9 spill level {lvl}: ({s * n // (2 * ln)}, {ln} + {ln}) int32",
                      20, spill_level(cur, ln)))
    return cases


def vocab_breakdown_cases():
    """Row 5 at (4, 151,936) bf16 k 64 (block 64) cut into its passes (a
    package with ``vocab_merge_tree_launch``): the first pass alone, the
    second alone (the lists of each row in one CTA), both in one launch
    (the last CTA of each row merges the second), and the whole tree at
    other subtree sizes and thread counts."""
    import torch

    from repro_torch.kernels import topk as K

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 151_936)).astype(np.float32) * 3).to(
        device="cuda", dtype=torch.bfloat16)
    keys, idx = K.vocab_phase1(x, 64, 64)
    one = getattr(K, "vocab_merge_tree_launch", None)
    if one is None:
        return [("row 5 (4, 151936) k 64: the tree, one launch a level", 100,
                 lambda: level_chain(K, keys, idx, 64, None))]
    from repro_torch.kernels import launch

    def knobs(fn, threads, group=0):
        def call():
            old = K.TREE_THREADS, launch.VOCAB_GROUP
            K.TREE_THREADS, launch.VOCAB_GROUP = threads, group
            try:
                return fn()
            finally:
                K.TREE_THREADS, launch.VOCAB_GROUP = old
        return call

    g1, g2 = K.vocab_merge_plan(keys.shape[1], keys.shape[2], 64)
    mid_k, mid_i = one(keys, idx, 64, g1)
    cases = [(f"row 5 (4, 151936) k 64: pass 1 (subtrees of {1 << g1} lists)", 100,
              lambda: one(keys, idx, 64, g1)),
             (f"row 5 (4, 151936) k 64: pass 2 ({1 << g2} lists a row, one CTA)", 100,
              lambda: one(mid_k, mid_i, 64, g2, 0, torch.bfloat16)),
             ("row 5 (4, 151936) k 64: both passes, one launch", 100,
              lambda: one(keys, idx, 64, g1, g2, torch.bfloat16))]
    for group in (32, 64, 128):
        for threads in (256, 512, 1024):
            cases.append((f"row 5 (4, 151936) k 64: the tree, subtrees of {group} lists, "
                          f"{threads} threads a CTA", 100,
                          knobs(lambda: K.vocab_merge_tree(keys, idx, 64, torch.bfloat16),
                                threads, group)))
    return cases


def level_chain(K, kx, ix, k, dtype):
    """The tree one launch a level (a package with ``vocab_merge_level``)."""
    while kx.shape[1] > 1:
        kx, ix = K.vocab_merge_level(kx, ix, k, dtype if kx.shape[1] == 2 else None)
    return kx, ix


def launches_of(fn) -> dict:
    """The kernel launches one call of ``fn`` makes (nonzero counts)."""
    import torch

    from repro_torch.kernels import topk as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return {n: c for n, c in K.LAUNCHES.items() if c}


def events_ms(fn, iters: int) -> float:
    """Eager time of one call (host launch cost included), CUDA events."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--lanes", type=int, default=0)
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--grid-items", type=int, default=0,
                    help="outputs a thread of the grid merge (a package that sizes them)")
    ap.add_argument("--kernels", default="2,6",
                    help="comma-separated kernel rows among 2, 6, 8, 1, 9, 5")
    args = ap.parse_args()
    rows_asked = {int(r) for r in args.kernels.split(",")}
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_sort_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import launch
    from repro_torch.kernels import segmented as SK
    from repro_torch.kernels.sort import loms_sort

    if args.lanes:
        launch.SORT_LANES = args.lanes
    if args.grid_items:
        launch.GRID_ITEMS = args.grid_items

    card = card_line()
    ops_per_s = (torch.cuda.get_device_properties(0).multi_processor_count * 64
                 * max_sm_mhz() * 1e6)
    cases = []
    if args.breakdown and 8 in rows_asked:
        from repro_torch.kernels.kway import kway_merge
        from repro_torch.networks import kway_schedule

        for lens, rows, dt, ids in (((128,) * 8, 16_384, torch.int32, False),
                                    ((64,) * 4, 65_536, torch.bfloat16, True),
                                    ((7, 7, 7), 1 << 20, torch.float32, False)):
            sched = kway_schedule(lens)
            x = sorted_lists(rows, lens, dt, sum(lens), ids)
            lanes = ((torch.arange(x.numel(), dtype=torch.int32, device="cuda")
                      .reshape(x.shape),) if ids else ())
            key = dt if dt.is_floating_point else None
            for st in range(len(sched.stages) + 1):
                cases.append((f"row 8 {len(lens)} x {lens[0]} {dt} ({rows} rows), "
                              f"{st} stages", 20,
                              lambda x=x, s=sched, st=st, lanes=lanes, key=key, ids=ids:
                              kway_merge(x, s, lanes, n_stages=st, lens=s.meta_dict()["lens"],
                                         key_dtype=key, descending=ids)))
    if args.breakdown and 2 in rows_asked:
        for w in (64, 128, 256, 512, 1024):
            rows = (1 << 24) // w
            x = tile(rows, w, torch.bfloat16, w)
            ids = torch.arange(rows * w, dtype=torch.int32, device="cuda").reshape(rows, w)
            cases.append((f"row 2 ({rows}, {w}) bf16 + int32 payload", 20,
                          lambda x=x, ids=ids: loms_sort(x, (ids,), key_dtype=torch.bfloat16)))
            cases.append((f"row 2 ({rows}, {w}) bf16, values only", 20,
                          lambda x=x: loms_sort(x, key_dtype=torch.bfloat16)))
    for name, rows, n, dt, desc, pay in () if args.breakdown or 2 not in rows_asked else (
            ("row 2 (16384, 1024) bf16 + int32 payload", 16_384, 1024, torch.bfloat16,
             False, True),
            ("row 2 (16, 1007) f32 desc", 16, 1007, torch.float32, True, False)):
        x = tile(rows, n, dt, n)
        lanes = ((torch.arange(rows * n, dtype=torch.int32, device="cuda").reshape(rows, n),)
                 if pay else ())
        cases.append((name, 20, lambda x=x, lanes=lanes, dt=dt, desc=desc: loms_sort(
            x, lanes, key_dtype=dt, descending=desc)))
    for name, rows, w, dt, k_out, flip, pay in () if args.breakdown or 6 not in rows_asked else (
            ("row 6 (4, 256) bf16 k_out 64 (the engine tick)", 4, 256, torch.bfloat16, 64,
             True, False),
            ("row 6 (1, 1024) int32 + int32 payload (MoE grouping)", 1, 1024, torch.int32,
             1024, False, True),
            ("row 6 (4096, 1024) bf16 k_out 64 (re-rank)", 4096, 1024, torch.bfloat16, 64,
             True, False)):
        x = tile(rows, w, dt, w + rows)
        lens = torch.full((rows, 1), w, dtype=torch.int32, device="cuda")
        lanes = ((torch.arange(rows * w, dtype=torch.int32, device="cuda").reshape(rows, w),)
                 if pay else ())
        cases.append((name, 200, lambda x=x, lens=lens, lanes=lanes, k_out=k_out, flip=flip:
                      SK.segment_class_sort(x, lens, lanes, k_out=k_out, flip=flip,
                                            want_perm=True)))
    if args.breakdown and 9 in rows_asked:
        cases += grid_breakdown_cases()
    if args.breakdown and 5 in rows_asked:
        cases += vocab_breakdown_cases()
    for name, iters, fn in cases:
        print(json.dumps({"label": args.label, "lanes": args.lanes, "shape": name,
                          "ms": graph_ms(fn, iters), "card": card}), flush=True)
    yard = []
    for r in (8, 1):
        if r in rows_asked and not args.breakdown:
            yard += kway_cases(ops_per_s) if r == 8 else merge_cases(ops_per_s)
    for name, iters, fn, (lib_name, lib), bound in yard:
        print(json.dumps({"label": args.label, "shape": name, "ms": graph_ms(fn, iters),
                          "torch": lib_name, "torch_ms": graph_ms(lib, iters),
                          "bound_ms": bound, "card": card}), flush=True)
    timed = []
    for r in (9, 5):
        if r in rows_asked and not args.breakdown:
            timed += grid_cases(ops_per_s) if r == 9 else vocab_cases(ops_per_s)
    for name, iters, fn, (lib_name, lib), bound, how in timed:
        try:
            ms = graph_ms(fn, iters) if how == "graph" else events_ms(fn, iters)
        except RuntimeError as err:  # a call that cannot be captured in a graph
            print(f"time_sort_kernels: {name}: no graph ({err}); timed eagerly",
                  file=sys.stderr)
            how, ms = "eager", events_ms(fn, iters)
        print(json.dumps({"label": args.label, "shape": name, "ms": ms, "timing": how,
                          "launches": launches_of(fn), "torch": lib_name,
                          "torch_ms": graph_ms(lib, iters), "bound_ms": bound,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
