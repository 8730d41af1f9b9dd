#!/usr/bin/env python3
"""Time the fused sort (kernel row 2) and the class sort (row 6) on one
CUDA card at the five shapes of their main paths, for one copy of the
port's package:

  python3 scripts/time_sort_kernels.py [--src DIR] [--label NAME] [--lanes N]
                                       [--breakdown]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two versions of the package (say a
parent commit unpacked with ``git archive``) can be timed in turns, one after
the other on one card. Each shape prints one JSON line: the device time
of one call in ms (a CUDA graph of the call replayed between two CUDA
events), the label, and the card's name and power limit as nvidia-smi
reports them. ``--lanes`` forces the lanes a thread of the sort executor
(a package that has one). ``--breakdown`` times instead the fused sort of
2^24 bf16 lanes with an int32 payload cut into rows of 64 to 1024: at 64
the loms tree is its six S2MS levels alone, and each doubling adds one
column-device level, so the differences are the levels' costs. Needs a
card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    args = ap.parse_args()
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
    cases = []
    if args.breakdown:
        for w in (64, 128, 256, 512, 1024):
            rows = (1 << 24) // w
            x = tile(rows, w, torch.bfloat16, w)
            ids = torch.arange(rows * w, dtype=torch.int32, device="cuda").reshape(rows, w)
            cases.append((f"row 2 ({rows}, {w}) bf16 + int32 payload", 20,
                          lambda x=x, ids=ids: loms_sort(x, (ids,), key_dtype=torch.bfloat16)))
            cases.append((f"row 2 ({rows}, {w}) bf16, values only", 20,
                          lambda x=x: loms_sort(x, key_dtype=torch.bfloat16)))
    for name, rows, n, dt, desc, pay in () if args.breakdown else (

            ("row 2 (16384, 1024) bf16 + int32 payload", 16_384, 1024, torch.bfloat16,
             False, True),
            ("row 2 (16, 1007) f32 desc", 16, 1007, torch.float32, True, False)):
        x = tile(rows, n, dt, n)
        lanes = ((torch.arange(rows * n, dtype=torch.int32, device="cuda").reshape(rows, n),)
                 if pay else ())
        cases.append((name, 20, lambda x=x, lanes=lanes, dt=dt, desc=desc: loms_sort(
            x, lanes, key_dtype=dt, descending=desc)))
    for name, rows, w, dt, k_out, flip, pay in () if args.breakdown else (
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
