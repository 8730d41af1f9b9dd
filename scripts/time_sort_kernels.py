#!/usr/bin/env python3
"""Time the port's sort and merge kernels on one CUDA card at the shapes
of their main paths, for one copy of the port's package:

  python3 scripts/time_sort_kernels.py [--src DIR] [--label NAME] [--lanes N]
                                       [--kernels 2,6] [--breakdown]

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
differences are the stages' costs. Needs a
card; exits 2 without one.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--kernels", default="2,6",
                    help="comma-separated kernel rows among 2, 6, 8, 1")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
