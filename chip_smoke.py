#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

  python3 chip_smoke.py

Finds ``src/repro_torch`` beside this file by itself (no PYTHONPATH) and
imports neither JAX nor the JAX package. Phases, each of which ends the
script with a non-zero exit code when it fails:

1. environment, the card's name and power limit, and the kernel build
   (nvcc, from ``src/repro_torch/csrc/`` only);
2. every CUDA kernel against its plain PyTorch version on the card,
   bit-equal values and indices (and permutations and payload lanes for
   the segmented class kernels, the 2-way merge, the fused sort and the
   k-way merge), in bf16, f32 and int32, on rows that hold NaN, ±inf,
   ±0.0 and many ties; the sort executor of the fused sort and the class
   sort at every lanes-a-thread layout at the shapes of phases 3d and 3e;
   the tiled 2-way merge forced onto short rows at tiles of 1, 5 and 64
   rows (several CTAs a row); the vocab merge tree (row 5) at B = 1, 4
   and 8, k 16, 64 and 256, block 16 with k 64, in its plan's one launch
   and at forced subtrees of 2, 4 and 32 lists; the grid merge (row 9) at
   its own tiles and forced tiles of 256 and 768 outputs, on strided row
   views, and the values-only sort spill at 3, 5 and 128 runs a row with
   one launch a level; the k-way merge's executors (a thread a row
   up to 64 cells, the one-thread and warp sorts of the (key, index)
   pairs, the two-chain merge) at every schedule of phase 3f, the medians
   and MWMS in bf16, f32 and int32; and the 2-way merge, the fused sort
   and the k-way merge in the reference's raw-float mode
   (``use_mxu=True``, the values-only wrappers' mode), NaN bits included,
   on rows with -0.0 / +0.0 mixes, all-negative rows with a -0.0, ±inf
   and NaN;
3. the main paths, each with its launch counts zeroed just before it and
   read just after it:
   a. ``generate`` on Qwen3-8B at full width (bf16, random weights from
      seed 0), batch 4, prompt 128, 16 new tokens, top_k 64, temperature
      0.8; the same with ragged prompt lengths; once greedy; and the
      launcher on the smoke-width config (vocab 256: the router kernel);
      each run's first-step candidates and token are checked against the
      plain top-k;
   b. the request scheduler (``ScheduledEngine``) on the same full-width
      model: six staggered requests of mixed k, nucleus and greedy, each
      stream checked bit-equal to a solo ``generate`` of it; and one
      decode step, alone against a batch of 4, traced op by op with the
      rows unpadded and padded (the padded one must not differ);
   c. ``--engine`` at smoke width (vocab 256: the class sort per decode
      tick), its first tick's candidates checked against the plain class
      sort;
   d. the segmented library calls (``segment_sort / segment_merge /
      segment_topk / segment_argmax``) at the MoE grouping and re-rank
      shapes, checked against the CPU;
   e. the library's ``merge`` and ``sort`` at their users' sizes: the
      paper's 32 + 32 device over 65,536 rows, two kept lists of 512 per
      query (descending, int32 ids), 32 new keys into runs of 65,536
      (the tiled merge: several CTAs a row), sorts of (16,384, 1024) bf16 with a
      payload and (16, 1007) descending, merges past the routing budget
      ((8, 2^22) pairs and the stream-merge example's 100,000 + 100,000:
      the grid merge), and the values-only ``segment_sort`` /
      ``segment_merge`` spills (the sort spill of 16 x 65,536: one grid
      merge a level, 7); each checked bit-equal to the CPU's plain
      versions, or for the largest values-only rows to torch.sort of the
      keys, decoded;
   f. the k-way merge and the median at their users' sizes (kernel row
      8): the paper's 3 x 7 device (``merge_k`` and ``median_of_lists``)
      over 1,048,576 rows, four vocab shards' kept top-64 lists merged
      descending with their token ids (65,536 rows, bf16), 8 x 128 int32
      over 16,384 rows (the six-stage device at 1,024), (100, 50, 25)
      f32 over 65,536 rows, the median of 5 x 7 over 1,048,576 rows, and
      ``chunked_merge_k`` of 8 runs of 2^20 (an external sort's merge
      phase: 65,536 segment rows in one launch); each checked bit-equal
      to the plain version run in chunks, or to torch.sort of the keys;
4. times (CUDA events) of every kernel beside its bound, its plain
   version and one PyTorch call on the same input (``torch.topk``,
   ``torch.sort``, ``torch.kthvalue``: a yardstick the port never calls),
   row 8 also at 8 x 128 int32 and at the chunked_merge_k segments, row
   9 also the whole values-only sort spill of phase 3e.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Needs one card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
#: 32-bit integer results (add, compare, min/max) per clock per SM on
#: compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instruction throughput); the keys the kernels compare are int32
INT32_PER_CLOCK_PER_SM = 64
#: int32 instructions per comparison: the compare, and the add (or the
#: select) that folds it into a rank or a search bound
OPS_PER_COMPARISON = 2
SOURCE = "src/repro_torch/csrc/topk.cu"
SEG_SOURCE = "src/repro_torch/csrc/segmented.cu"
MERGE_SOURCE = "src/repro_torch/csrc/merge.cu"
SORT_SOURCE = "src/repro_torch/csrc/sort.cu"
GRID_SOURCE = "src/repro_torch/csrc/grid_merge.cu"
KWAY_SOURCE = "src/repro_torch/csrc/kway.cu"


def log(*args) -> None:
    print(*args, flush=True)


def smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def int32_ops_per_s() -> float:
    """The card's peak int32 rate: SMs x int32 lanes x its top SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm", ",nounits"))
    return sms * INT32_PER_CLOCK_PER_SM * mhz * 1e6


def bits(t):
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over slots where both are numbers; NaN against NaN
    counts as equal, NaN against a number as infinitely far."""
    import torch

    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    one_nan = torch.isnan(a) ^ torch.isnan(b)
    if bool(one_nan.any()):
        return float("inf")
    same = (a == b) | both_nan  # equal infinities differ by nan otherwise
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def require_equal(name, got, want) -> float:
    """Bit-equal values and indices, else raise; returns max |err|."""
    (gv, gi), (wv, wi) = got, want
    import torch

    if gv.shape != wv.shape or not torch.equal(bits(gv), bits(wv)):
        raise AssertionError(f"{name}: values differ from the plain version")
    if not torch.equal(gi, wi):
        raise AssertionError(f"{name}: indices differ from the plain version")
    return max_abs_err(gv, wv)


def special_logits(rows, n, dtype, device, seed):
    """Random logits with many ties, and NaN, ±inf, ±0.0 in the first rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.integers(-64, 65, (rows, n)) * 0.125).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    if rows > 1:
        x[1, -5:] = [-0.0, 0.0, np.inf, np.nan, -np.inf]
    if rows > 2:
        x[2, :] = 0.0
        x[2, 1::3] = -0.0
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: ``fn`` captured once in a CUDA graph and
    replayed ``iters`` times between two events, so the host's launch
    cost (Python, ctypes, allocation) stays out of the window."""
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
    return cuda_ms(graph.replay, iters)


def bound_ms(nbytes: float, comparisons: float, ops_per_s: float):
    """The least time for the work: bytes over the memory rate, or int32
    instructions (``OPS_PER_COMPARISON`` per comparison) over the peak
    int32 rate, whichever is larger; and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = comparisons * OPS_PER_COMPARISON / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def search_steps(n: int) -> int:
    """Comparisons of one binary search over a list of n."""
    return max(n, 1).bit_length()


#: lanes a thread of the sort executor held in phase 2 (0: the plan's)
LANE_LAYOUTS = (0, 1, 4, 8)


class merge_tile:
    """Force the rows a tile of the tiled 2-way merge (row 1), and with it
    the tiled kernel on every row a single-level program merges."""

    def __init__(self, rows: int):
        self.rows = rows

    def __enter__(self):
        from repro_torch.kernels import launch

        self.old, launch.MERGE_TILE = launch.MERGE_TILE, self.rows

    def __exit__(self, *exc):
        from repro_torch.kernels import launch

        launch.MERGE_TILE = self.old


class vocab_group:
    """Force the lists a CTA of the vocab merge tree takes (row 5) and the
    threads of its CTAs."""

    def __init__(self, group: int, threads: int = 512):
        self.group, self.threads = group, threads

    def __enter__(self):
        from repro_torch.kernels import launch
        from repro_torch.kernels import topk as K

        self.old = launch.VOCAB_GROUP, K.TREE_THREADS
        launch.VOCAB_GROUP, K.TREE_THREADS = self.group, self.threads

    def __exit__(self, *exc):
        from repro_torch.kernels import launch
        from repro_torch.kernels import topk as K

        launch.VOCAB_GROUP, K.TREE_THREADS = self.old


class grid_items:
    """Force the outputs a thread of the grid merge takes (row 9), and so
    its tile (that many times 256)."""

    def __init__(self, items: int):
        self.items = items

    def __enter__(self):
        from repro_torch.kernels import launch

        self.old, launch.GRID_ITEMS = launch.GRID_ITEMS, self.items

    def __exit__(self, *exc):
        from repro_torch.kernels import launch

        launch.GRID_ITEMS = self.old


class sort_lanes:
    """Force the lanes a thread of the sort executor (rows 2 and 6)."""

    def __init__(self, lanes: int):
        self.lanes = lanes

    def __enter__(self):
        from repro_torch.kernels import launch

        self.old, launch.SORT_LANES = launch.SORT_LANES, self.lanes

    def __exit__(self, *exc):
        from repro_torch.kernels import launch

        launch.SORT_LANES = self.old


def phase_kernels(dev, K, topk_block) -> dict:
    """Phase 2: every kernel bit-equal to its plain version on the card."""
    import torch

    err = {"router_topk": 0.0, "vocab_phase1": 0.0, "vocab_merge_level": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        # the MoE-router shapes, and the smoke-width serve's (4, 256) k=64
        for t, e, k in ((4096, 256, 16), (4096, 128, 8), (4, 256, 64)):
            x = special_logits(t, e, dtype, dev, seed=e + k)
            blk = topk_block(e, k)
            got = K.router_topk(x, k, block=blk)
            err["router_topk"] = max(err["router_topk"], require_equal(
                f"router T={t} E={e} k={k} {dtype}", got, K.router_topk_plain(x, k, blk)))
            log(f"  router_topk T={t} E={e} k={k} block={blk} {dtype}: bit-equal")
        # the serving shapes (k 64, 16, 256 at their planner's block), B = 1, 4
        # and 8, k 64 at block 16 (lists that grow 16 -> 32 -> 64), and a
        # vocab of 3000 (one launch); the tree at its plan and at forced
        # subtrees of 2, 4 and 32 lists
        for b, v, k, blk in ((8, 151_936, 64, None), (8, 151_936, 16, None),
                             (8, 151_936, 256, None), (1, 151_936, 64, None),
                             (4, 151_936, 64, None), (4, 151_936, 64, 16),
                             (3, 3000, 64, 16)):
            x = special_logits(b, v, dtype, dev, seed=k + b)
            blk = blk or topk_block(v, k)
            keys, idx = K.vocab_phase1(x, k, blk)
            pk, pi = K.vocab_phase1_plain(x, k, blk)
            err["vocab_phase1"] = max(err["vocab_phase1"], require_equal(
                f"phase1 B={b} k={k} {dtype}", (keys, idx), (pk, pi)))
            want = K.vocab_merge_tree_plain(keys, idx, k, dtype)
            for group, threads in ((0, 512), (2, 512), (4, 512), (32, 512), (0, 128)):
                with vocab_group(group, threads):
                    got = K.vocab_merge_tree(keys, idx, k, dtype)
                err["vocab_merge_level"] = max(err["vocab_merge_level"], require_equal(
                    f"merge tree B={b} k={k} block={blk} group={group} threads {threads} "
                    f"{dtype}", got, want))
            require_equal(f"vocab top-k B={b} k={k} {dtype}", K.vocab_topk(x, k, block=blk),
                          K.vocab_topk_plain(x, k, blk))
            plan = K.vocab_merge_plan(keys.shape[1], keys.shape[2], k)
            log(f"  vocab B={b} V={v} k={k} block={blk} {dtype}: phase 1 and the merge tree "
                f"({K.vocab_levels(v, blk)} levels in passes of {plan}; forced subtrees "
                "of 2, 4, 32 lists; CTAs of 128 threads) bit-equal")
    torch.cuda.synchronize()
    return err


def seg_tile(rows, w, dtype, device, seed):
    """A class tile with heavy ties; floats also hold NaN, ±inf and ±0.0,
    int32 its extremes (INT32_MAX ties the key-domain sentinel)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = rng.integers(-3, 4, (rows, w)).astype(np.int32)
        x[rng.random((rows, w)) < 0.05] = np.iinfo(np.int32).max
        x[rng.random((rows, w)) < 0.05] = np.iinfo(np.int32).min
        return torch.from_numpy(x).to(device)
    x = (rng.integers(-3, 4, (rows, w)) * 0.5).astype(np.float32)
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random((rows, w)) < frac] = val
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def seg_lens(rows, w, device, seed, full=False):
    """Valid lengths from 0 to w (the first row full, the second empty)."""
    import numpy as np
    import torch

    lens = np.random.default_rng(seed).integers(0, w + 1, (rows, 1)).astype(np.int32)
    if full:
        lens[:] = w
    else:
        lens[0], lens[1 % rows] = w, 0
    return torch.from_numpy(lens).to(device)


def require_same_class(name, got, want) -> float:
    """Class-kernel results bit-equal: values, perm and every payload lane."""
    import torch

    (gv, gp, gl), (wv, wp, wl) = got, want
    if gv.shape != wv.shape or not torch.equal(bits(gv), bits(wv)):
        raise AssertionError(f"{name}: values differ from the plain version")
    if (gp is None) != (wp is None) or (gp is not None and not torch.equal(gp, wp)):
        raise AssertionError(f"{name}: permutations differ from the plain version")
    for a, b in zip(gl, wl):
        a = bits(a) if a.dtype.is_floating_point else a
        b = bits(b) if b.dtype.is_floating_point else b
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: payload lanes differ from the plain version")
    return max_abs_err(gv, wv)


def plain_in_chunks(fn, rows, chunk=512):
    """Run a plain class version over row chunks (its comparison clouds
    are large at W = 1024) and stitch the results."""
    import torch

    parts = [fn(slice(i, min(i + chunk, rows))) for i in range(0, rows, chunk)]
    perm = None if parts[0][1] is None else torch.cat([p[1] for p in parts])
    return (torch.cat([p[0] for p in parts]), perm,
            tuple(torch.cat([p[2][j] for p in parts]) for j in range(len(parts[0][2]))))


def phase_seg_kernels(dev, SK, capable_families) -> dict:
    """Phase 2, segmented: the class sort and class merge bit-equal to
    their plain versions, values, perm and payload lanes."""
    import torch

    err = {"seg_sort": 0.0, "seg_merge": 0.0}
    dtypes = (torch.bfloat16, torch.float32, torch.int32)

    def sort_case(name, x, lens, pay, k_out, fam, flip, layouts=(0,)):
        want = plain_in_chunks(lambda r: SK.segment_class_sort_plain(
            x[r], lens[r], tuple(p[r] for p in pay), k_out=k_out, network=fam, flip=flip,
            want_perm=True), x.shape[0])
        for lanes in layouts:
            with sort_lanes(lanes):
                got = SK.segment_class_sort(x, lens, pay, k_out=k_out, network=fam,
                                            flip=flip, want_perm=True)
            err["seg_sort"] = max(err["seg_sort"], require_same_class(
                f"{name} lanes={lanes}", got, want))

    # every width, dtype, order and capable family, lengths 0..W
    for w in (2, 16, 64, 128, 256, 512, 1024):
        for dt in dtypes:
            x = seg_tile(64, w, dt, dev, seed=w)
            lens = seg_lens(64, w, dev, seed=w + 1)
            pay = (torch.arange(64 * w * 2, dtype=torch.int32, device=dev).reshape(64, w, 2),
                   seg_tile(64, w, torch.bfloat16, dev, seed=w + 2))
            for fam in capable_families("sort", (w,)):
                for flip in (False, True):
                    sort_case(f"class sort W={w} {dt} {fam} flip={flip}", x, lens, pay,
                              max(1, w // 3), fam, flip)
        log(f"  seg_sort W={w}: {', '.join(capable_families('sort', (w,)))} x bf16/f32/"
            f"int32 x both orders, 64 rows, lens 0..W, 2 payload lanes: bit-equal")
    # the shapes the paths give it
    for name, rows, w, dt, k_out, flip, full, with_pay in (
            ("engine decode tile (4, 256) f32 k_out 64", 4, 256, torch.float32, 64, True,
             True, False),
            ("MoE grouping sort (1, 1024) int32 + int32 payload", 1, 1024, torch.int32,
             1024, False, True, True),
            ("re-rank (4096, 1024) bf16 k_out 64", 4096, 1024, torch.bfloat16, 64, True,
             False, False)):
        x = seg_tile(rows, w, dt, dev, seed=rows + w)
        lens = seg_lens(rows, w, dev, seed=rows, full=full)
        pay = ((torch.arange(rows * w, dtype=torch.int32, device=dev).reshape(rows, w),)
               if with_pay else ())
        for fam in capable_families("sort", (w,)):
            sort_case(f"{name} {fam}", x, lens, pay, k_out, fam, flip, LANE_LAYOUTS)
        log(f"  seg_sort {name}: {', '.join(capable_families('sort', (w,)))}, lanes a thread "
            f"{LANE_LAYOUTS}: bit-equal")
    # merges: lengths below the widths, a payload lane, both orders
    for wa, wb in ((16, 16), (64, 256), (512, 512)):
        for dt in dtypes:
            for flip in (False, True):
                la, lb = seg_lens(64, wa, dev, seed=wa), seg_lens(64, wb, dev, seed=wb + 5)
                a = SK.segment_class_sort_plain(seg_tile(64, wa, dt, dev, seed=1), la,
                                                flip=flip)[0]
                b = SK.segment_class_sort_plain(seg_tile(64, wb, dt, dev, seed=2), lb,
                                                flip=flip)[0]
                pay = (torch.arange(64 * (wa + wb), dtype=torch.int32,
                                    device=dev).reshape(64, wa + wb),)
                for fam in capable_families("merge2", (wa, wb)):
                    got = SK.segment_class_merge(a, b, la, lb, pay, network=fam, flip=flip,
                                                 want_perm=True)
                    want = SK.segment_class_merge_plain(a, b, la, lb, pay, network=fam,
                                                        flip=flip, want_perm=True)
                    err["seg_merge"] = max(err["seg_merge"], require_same_class(
                        f"class merge ({wa}, {wb}) {dt} {fam} flip={flip}", got, want))
        log(f"  seg_merge ({wa}, {wb}): {', '.join(capable_families('merge2', (wa, wb)))}"
            f" x bf16/f32/int32 x both orders, lens below the widths, payload: bit-equal")
    torch.cuda.synchronize()
    return err


def phase_serve(dev, K):
    """Phase 3: the main path at full width, launches counted."""
    import numpy as np
    import torch

    from repro_torch import topk
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.sample import canonical_token, categorical, gumbel_noise

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    lens = rng.integers(1, plen + 1, bsz).astype(np.int32)
    ragged = tokens.copy()
    for r, n in enumerate(lens):
        ragged[r, n:] = 0
    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0,
                     time_steps=True)
    smoke_plen = 32
    smoke_args = ["--arch", "qwen3-8b", "--smoke", "--batch", str(bsz),
                  "--prompt-len", str(smoke_plen), "--new-tokens", str(new),
                  "--top-k", str(k), "--temperature", str(temp), "--device", str(dev)]

    vocab = cfg.vocab_size
    blk = topk_block(vocab, k)
    tree = K.vocab_merge_launches(vocab, blk, k)
    if tree > 2:
        raise AssertionError(f"the merge tree takes {tree} launches a call, not at most 2")
    # one draw per new token: a sampled full-width run launches phase 1
    # and the merge tree per token, greedy launches nothing, and the
    # smoke-width launcher (vocab 256) the router kernel per token
    vocab_run = {"router_topk": 0, "vocab_phase1": new, "vocab_merge_level": new * tree}
    runs = (
        ("sampled", lambda: generate(params, {"tokens": tokens}, cfg, sc, device=dev),
         vocab_run),
        ("ragged", lambda: generate(params, {"tokens": ragged, "lengths": lens}, cfg, sc,
                                    device=dev), vocab_run),
        ("greedy", lambda: generate(params, {"tokens": tokens}, cfg,
                                    dataclasses.replace(sc, temperature=0.0), device=dev),
         {"router_topk": 0, "vocab_phase1": 0, "vocab_merge_level": 0}),
        ("smoke launcher", lambda: launcher.main(smoke_args),
         {"router_topk": new, "vocab_phase1": 0, "vocab_merge_level": 0}),
    )
    outs, launches = {}, {name: 0 for name in K.LAUNCHES}
    for name, run, want in runs:
        want = {**{n: 0 for n in K.LAUNCHES}, **want}
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  launches, {name} run: {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
    log(f"  vocab block {blk}, {K.vocab_levels(vocab, blk)} merge levels in {tree} "
        f"launches per sampled token; "
        f"main path in all: {launches}")
    out, out_r, out_g, out_s = (outs[n] for n in ("sampled", "ragged", "greedy",
                                                  "smoke launcher"))
    for name, o, v in (("sampled", out, vocab), ("ragged", out_r, vocab),
                       ("greedy", out_g, vocab), ("smoke launcher", out_s, 256)):
        t = o["tokens"]
        if t.shape != (bsz, new) or t.min() < 0 or t.max() >= v:
            raise AssertionError(f"{name} run gave tokens {t.shape} outside [0, {v})")
    for name, o in (("sampled", out), ("ragged", out_r), ("greedy", out_g)):
        log(f"  {name}: prefill {o['prefill_s'] * 1e3:.2f} ms, decode step p50 "
            f"{o['decode_step_p50_us'] / 1e3:.3f} ms p99 {o['decode_step_p99_us'] / 1e3:.3f} ms, "
            f"{o['tok_per_s']:.1f} tok/s; first tokens {o['tokens'][0, :6].tolist()}")

    def first_step(name, p, c, toks, plain):
        """A run's first step again: its prefill logits through
        ``repro_torch.topk`` (the kernels) and through the plain top-k give
        the same candidates, and the token the run drew (seed 0)."""
        with torch.inference_mode():
            lg, _ = prefill(p, {"tokens": torch.from_numpy(toks).to(dev)},
                            init_cache(c, bsz, toks.shape[1] + new, dev), c)
            if lg.shape != (bsz, c.vocab_size) or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{name}: prefill logits are not finite of shape (B, V)")
            got = topk(lg, k)
            want_tk = plain(lg)
            require_equal(f"{name}: first-step candidates", got, want_tk)
            noise = gumbel_noise((bsz, k), generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
            tok_k = canonical_token(lg, got[0], categorical(got[0].float() / temp, gumbel=noise))
            tok_p = canonical_token(lg, want_tk[0],
                                    categorical(want_tk[0].float() / temp, gumbel=noise))
        if not torch.equal(tok_k, tok_p):
            raise AssertionError(f"{name}: first token differs between the kernel and plain top-k")
        if not np.array_equal(tok_k.cpu().numpy(), outs[name]["tokens"][:, 0]):
            raise AssertionError(f"{name}: first token differs from the one the run drew")
        log(f"  {name} first step: candidates bit-equal to the plain top-k, token "
            f"{tok_k.tolist()} equal to the run's")
        return lg

    logits = first_step("sampled", params, cfg, tokens,
                        lambda lg: K.vocab_topk_plain(lg, k, blk))
    if not np.array_equal(out_g["tokens"][:, 0], torch.argmax(logits, -1).cpu().numpy()):
        raise AssertionError("greedy first token is not the argmax")
    # the smoke-width launcher's model and prompt, as it makes them: its
    # vocab of 256 goes through the router kernel at the block it ran with
    scfg = get_smoke_config("qwen3-8b")
    sp = model_init(torch.Generator(device=dev).manual_seed(0), scfg, dev)
    stoks = np.random.default_rng(0).integers(
        0, scfg.vocab_size, (bsz, smoke_plen)).astype(np.int32)
    rb = topk_block(scfg.vocab_size, k)
    smoke_logits = first_step("smoke launcher", sp, scfg, stoks,
                              lambda lg: K.router_topk_plain(lg, k, rb))
    log(f"  smoke launcher: router block {rb} at vocab {scfg.vocab_size}, k={k}")

    # a small input against the CPU: the smoke config in float32
    small = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    p_gpu = model_init(torch.Generator(device=dev).manual_seed(1), small, dev)
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    toks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 24)).astype(np.int32))
    with torch.inference_mode():
        lg, _ = prefill(p_gpu, {"tokens": toks.to(dev)}, init_cache(small, 2, 24, dev), small)
        lc, _ = prefill(p_cpu, {"tokens": toks}, init_cache(small, 2, 24, "cpu"), small)
    diff = float((lg.cpu() - lc).abs().max())
    if not diff <= 1e-4:
        raise AssertionError(f"smoke logits on the card differ from the CPU by {diff}")
    log(f"  smoke config f32: card vs CPU prefill logits max |diff| {diff:.2e} (<= 1e-4)")
    return params, logits, smoke_logits, launches


def sort_comparisons(lens) -> float:
    """Comparisons a comparison sort needs for rows of these valid
    lengths: n log2 n a row (the class sort's k_out prefix is part of
    that sort)."""
    import numpy as np

    n = lens.reshape(-1).double().cpu().numpy()
    return float((n * np.log2(np.maximum(n, 1))).sum())


def phase_engine(dev, K, params, card) -> dict:
    """Phase 3b: the request scheduler at full width. Six staggered
    requests on four slots; every stream bit-equal to a solo ``generate``
    of its request at batch 1 with ``cache_len`` = the slot capacity."""
    import numpy as np
    import torch

    from repro_torch.api import topk_block
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.scheduler import SamplingParams, ScheduledEngine, SchedulerConfig

    cfg = get_config("qwen3-8b")
    vocab = cfg.vocab_size
    sched = SchedulerConfig(n_slots=4, page_size=16, pages_per_slot=9)  # ceil(144 / 16)
    plens, arrivals = (128, 77, 128, 33, 100, 5), (0, 0, 1, 2, 4, 6)
    sps = [SamplingParams(k=64, temperature=0.8, seed=11),
           SamplingParams(k=16, temperature=1.0, seed=12),
           SamplingParams(k=256, temperature=0.7, top_p=0.9, seed=13),
           SamplingParams(temperature=0.0, seed=14),
           SamplingParams(k=64, temperature=0.8, top_p=0.95, max_new_tokens=1, seed=15),
           SamplingParams(k=64, temperature=0.8, max_new_tokens=8, seed=16)]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in plens]

    def levels(k):  # merge-tree launches of one vocab top-k call
        n = K.vocab_merge_launches(vocab, topk_block(vocab, k), k)
        if n > 2:
            raise AssertionError(f"the merge tree takes {n} launches at k {k}, not at most 2")
        return n

    eng = ScheduledEngine(params, cfg, sched, device=dev)
    rids = [eng.submit(p, sp, arrival=a) for p, sp, a in zip(prompts, sps, arrivals)]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(K.LAUNCHES)
    # first tokens: one vocab top-k per sampled request; decode ticks: one
    # stable top-k (the spill of segment_topk) per tick with a sampler
    want = {n: 0 for n in K.LAUNCHES}
    for sp in sps:
        if not sp.greedy:
            want["vocab_phase1"] += 1
            want["vocab_merge_level"] += levels(sp.k)
    for _, _, ks in eng.tick_log:
        if ks:
            want["vocab_phase1"] += 1
            want["vocab_merge_level"] += levels(max(ks))
    log(f"  launches, engine drain: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"engine drain: launch counts {got} != {want}")
    n_tok = sum(len(out[r]) for r in rids)
    for rid, p, sp in zip(rids, prompts, sps):
        K.reset_launch_counts()
        solo = generate(params, {"tokens": p[None]}, cfg, ServeConfig(
            max_new_tokens=sp.max_new_tokens, top_k=sp.k, top_p=sp.top_p,
            temperature=sp.temperature, seed=sp.seed, cache_len=sched.slot_capacity),
            device=dev)["tokens"][0]
        torch.cuda.synchronize()
        solo_got = dict(K.LAUNCHES)
        solo_want = {n: 0 for n in K.LAUNCHES}
        if not sp.greedy:
            solo_want["vocab_phase1"] = sp.max_new_tokens
            solo_want["vocab_merge_level"] = sp.max_new_tokens * levels(sp.k)
        if solo_got != solo_want:
            raise AssertionError(f"solo run {rid}: launch counts {solo_got} != {solo_want}")
        r = eng.requests[rid]
        if r.state.value != "done" or not np.array_equal(out[rid], solo):
            raise AssertionError(f"request {rid} ({sp}): scheduled tokens {out[rid].tolist()} "
                                 f"!= solo generate {solo.tolist()}")
        log(f"  request {rid}: prompt {p.size}, arrival {r.arrival}, admitted at tick "
            f"{r.admit_tick}, {len(out[rid])} tokens, TTFT {(r.t_first - r.t_submit) * 1e3:.2f} "
            f"ms; bit-equal to solo generate (launches {solo_got['vocab_phase1']} phase 1, "
            f"{solo_got['vocab_merge_level']} merge-tree launches)")
    ticks = np.asarray(eng.tick_s) * 1e3
    log(f"  engine drain: {len(rids)} requests, {n_tok} tokens in {wall:.3f} s wall, "
        f"{eng.t} ticks ({len(ticks)} decode ticks), {n_tok / wall:.1f} tok/s, decode tick "
        f"p50 {np.percentile(ticks, 50):.3f} ms (max {ticks.max():.3f} ms); {card}")
    return got


def phase_invariance(dev, params, cfg, card) -> None:
    """Does one row's decode step give other bits alone than inside a
    batch of 4 on this card? Four requests are prefilled alone (prompts
    of 128, 77, 33 and 100 tokens); one decode step then runs for each
    alone and for the four together, once with the rows unpadded
    (``DECODE_TILE`` 1) and once padded to ``DECODE_TILE`` as decode
    runs them. Every weight product, RMS norm and the decode attention
    of the stack is traced, and for each:

    * *alone*: the op run again on one row of the batch's own input (M =
      1 against the batch's M) gives that row other bits, counted over
      the 4 rows and every layer (unpadded run only);
    * *first break*: layer by layer, the first op whose input row has the
      same bits in the two runs and whose output row does not.

    The padded run fails the phase if any row's logits differ; the
    unpadded one is reported, as the reason for the padding."""
    import numpy as np
    import torch

    import repro_torch.models.attention as MA
    import repro_torch.models.layers as ML
    import repro_torch.models.model as MM
    import repro_torch.models.transformer as MT
    from repro_torch.models import init_cache, prefill

    names = {id(params["lm_head"]): "lm_head", id(params["final_norm"]): "final_norm"}
    for lay in params["stack"]["body"]:
        names[id(lay["ln1"])], names[id(lay["ln2"])] = "ln1", "ln2"
        for blk in ("attn", "ffn"):
            for w, p in lay[blk].items():
                names[id(p)] = f"{blk}.{w}"
    rec = []  # (op, its function, its arguments, which of them hold rows, output)

    def traced(real, kind):
        def fn(p, x, *a):
            y = real(p, x, *a)
            rec.append((f"{kind} {names.get(id(p), '?')}", real, (p, x) + a, (1,), y))
            return y
        return fn

    def traced_attention(q, k, v, valid_len):
        y = real_attention(q, k, v, valid_len)
        rec.append(("decode attention", real_attention, (q, k, v, valid_len), (0, 1, 2, 3), y))
        return y

    lens, cap = (128, 77, 33, 100), 144
    rng = np.random.default_rng(3)
    solo = []
    with torch.inference_mode():
        for n in lens:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))
            lg, c = prefill(params, {"tokens": toks.to(dev)}, init_cache(cfg, 1, cap, dev), cfg)
            solo.append((torch.argmax(lg, -1).to(torch.int32)[:, None], c["body"]))

    def step(rows):
        """One decode step of these rows, on copies of their caches."""
        body = [{"k": torch.cat([solo[r][1][i]["k"] for r in rows]),
                 "v": torch.cat([solo[r][1][i]["v"] for r in rows]),
                 "pos": torch.tensor([lens[r] for r in rows], dtype=torch.int32, device=dev)}
                for i in range(cfg.n_layers)]
        pos = torch.tensor([[lens[r]] for r in rows], dtype=torch.int32, device=dev)
        rec.clear()
        logits, _ = MM.decode_step(params, torch.cat([solo[r][0] for r in rows]),
                                   {"body": body}, cfg, positions=pos)
        return logits, list(rec)

    def same(a, b):
        return torch.equal(bits(a), bits(b))

    def count(d, op):
        d[op] = d.get(op, 0) + 1

    seams = [(MA, "dense"), (ML, "dense"), (MM, "dense"), (MA, "rmsnorm"),
             (MT, "rmsnorm"), (MM, "rmsnorm")]
    saved = [(m, n, getattr(m, n)) for m, n in seams]
    real_attention, tile = MA.decode_attention, MM.DECODE_TILE
    try:
        for m, n in seams:
            setattr(m, n, traced(getattr(m, n), n))
        MA.decode_attention = traced_attention
        for t in (1, tile):
            MM.DECODE_TILE = t
            differ, worst, alone, first = 0, 0.0, {}, None
            with torch.inference_mode():
                lg4, rec4 = step(range(4))
                for r in range(4):
                    lg1, rec1 = step([r])
                    if not same(lg4[r], lg1[0]):
                        differ += 1
                        worst = max(worst, (lg4[r].float() - lg1[0].float()).abs().max().item())
                    layer = -1
                    for (op, fn, args, held, y4), (*_, args1, _, y1) in zip(rec4, rec1):
                        layer += op == "rmsnorm ln1"
                        if t == 1:
                            row = [a[r:r + 1] if i in held else a for i, a in enumerate(args)]
                            if not same(fn(*row)[0], y4[r]):
                                count(alone, op)
                        x4, x1 = args[held[0]], args1[held[0]]
                        if first is None and same(x4[r], x1[0]) and not same(y4[r], y1[0]):
                            first = (op, layer, r, int((bits(y4[r]) != bits(y1[0])).sum()))
            log(f"  decode rows padded to a multiple of {t}: rows whose logits differ, batch "
                f"of 4 against alone: {differ} of 4 (max |diff| {worst:.4g})")
            if t == 1:
                log(f"    ops that give a row other bits alone (M = 1) than in the batch "
                    f"(M = 4), over 4 rows x {cfg.n_layers} layers: {alone or 'none'}")
            log("    first break: " + (f"{first[0]} in layer {first[1]}, row {first[2]}, "
                                       f"{first[3]} elements differ" if first else "none"))
            if t == tile and differ:
                raise AssertionError(f"decode with rows padded to {t}: {differ} rows differ "
                                     f"between batch 4 and alone (first break {first})")
    finally:
        for m, n, real in saved:
            setattr(m, n, real)
        MA.decode_attention, MM.DECODE_TILE = real_attention, tile
    log(f"  {card}")


def decode_tile_cost(dev, params, cfg, card) -> None:
    """What the batch-invariant decode costs: ``generate`` at batch 4 with
    the rows padded to DECODE_TILE = 8 and without padding (tile 1), in
    turns 8, 1, 1, 8 within this run."""
    import numpy as np

    import repro_torch.models.model as MM
    from repro_torch.serving import ServeConfig, generate

    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    sc = ServeConfig(max_new_tokens=16, top_k=64, temperature=0.8, time_steps=True)
    tile = MM.DECODE_TILE
    try:
        for t in (tile, 1, 1, tile):
            MM.DECODE_TILE = t
            o = generate(params, {"tokens": toks}, cfg, sc, device=dev)
            log(f"  generate B=4, decode rows padded to a multiple of {t}: step p50 "
                f"{o['decode_step_p50_us'] / 1e3:.3f} ms, p99 "
                f"{o['decode_step_p99_us'] / 1e3:.3f} ms; {card}")
    finally:
        MM.DECODE_TILE = tile


def phase_engine_smoke(dev, K, SK, bsz, plen, new, k, temp):
    """Phase 3c: ``--engine`` at smoke width. The class sort runs once per
    decode tick with a sampling slot; the candidates of the first tick
    with the most slots equal the plain class sort's on the same logits."""
    import torch

    import repro_torch.api as api
    from repro_torch.launch import serve as launcher

    first = {}
    real = api.segment_topk

    def spy(values, offsets, ks, **kw):  # keeps the first tick with the most rows
        res = real(values, offsets, ks, **kw)
        if len(ks) > len(first.get("call", (0, 0, ()))[2]):
            first["call"] = (values.clone(), tuple(offsets), list(ks), res)
        return res

    args = ["--arch", "qwen3-8b", "--smoke", "--engine", "--batch", str(bsz),
            "--prompt-len", str(plen), "--new-tokens", str(new), "--top-k", str(k),
            "--temperature", str(temp), "--device", str(dev)]
    api.segment_topk = spy
    try:
        K.reset_launch_counts()
        res = launcher.main(args)
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
    finally:
        api.segment_topk = real
    eng = res["engine"]
    want = {n: 0 for n in K.LAUNCHES}
    want["router_topk"] = sum(not r.params.greedy for r in eng.requests.values())
    want["seg_sort"] = sum(1 for _, _, ks in eng.tick_log if ks)
    log(f"  launches, --engine at smoke width: {got} (expected {want}; "
        f"{len(eng.tick_log)} decode ticks)")
    if got != want:
        raise AssertionError(f"--engine smoke: launch counts {got} != {want}")
    if any(len(t) != new for t in res["tokens"].values()) or len(res["tokens"]) != bsz:
        raise AssertionError("--engine smoke: not every request got its tokens")
    values, offsets, ks, (vals, idx, out_offs) = first["call"]
    v = offsets[1]
    rows = values.view(-1, v)
    k_out = max(ks)
    pv, pp, _ = SK.segment_class_sort_plain(
        rows, torch.full((rows.shape[0], 1), v, dtype=torch.int32, device=dev),
        k_out=k_out, flip=True, want_perm=True)
    want_v = torch.cat([pv[r, :kr] for r, kr in enumerate(ks)])
    want_i = torch.cat([pp[r, :kr] for r, kr in enumerate(ks)])
    require_equal("--engine decode tick: candidates", (vals, idx), (want_v, want_i))
    log(f"  --engine first decode tick of {rows.shape[0]} slots: {rows.shape[0]} rows x {v}, "
        f"ks {ks}: candidates bit-equal to the plain class sort")
    return got, rows, k_out


def phase_seg_library(dev, K, SK):
    """Phase 3d: the segmented library calls at the shapes their users
    give them, launches counted; the results equal the CPU's (the plain
    versions) on every segment checked."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.segmented import bucket_merge_pairs, bucket_segments

    rng = np.random.default_rng(3)
    # MoE grouping sort: 1024 (token, expert) slots by expert id, token ids riding
    experts = torch.from_numpy(rng.integers(0, 64, 1024).astype(np.int32))
    tok_ids = torch.arange(1024, dtype=torch.int32)
    # re-rank: 4096 queries x 1024 candidate scores (bf16), top-64 each
    nq, nc, kq = 4096, 1024, 64
    scores = seg_tile(nq, nc, torch.bfloat16, "cpu", seed=9).reshape(-1)
    q_offs = tuple(range(0, (nq + 1) * nc, nc))
    # merge each query's 64 kept candidates with a ragged list of new ones
    nb = rng.integers(1, 65, 1024)
    offs_a = tuple(range(0, 1025 * 64, 64))
    offs_b = tuple(np.concatenate([[0], np.cumsum(nb)]).tolist())
    a = seg_tile(1024, 64, torch.float32, "cpu", seed=4).reshape(-1)
    b = seg_tile(1, int(offs_b[-1]), torch.float32, "cpu", seed=5).reshape(-1)

    def calls(device, n_q):
        qo = q_offs[:n_q + 1]
        sa = repro_torch.segment_sort(a.to(device), offs_a, descending=True)
        sb = repro_torch.segment_sort(b.to(device), offs_b, descending=True)
        return (repro_torch.segment_sort(experts.to(device), (0, 1024), payload=tok_ids.to(device)),
                repro_torch.segment_topk(scores[:qo[-1]].to(device), qo, kq),
                repro_torch.segment_merge(sa, sb, offs_a, offs_b, descending=True,
                                          payload=(torch.arange(offs_a[-1]).to(device),
                                                   torch.arange(offs_b[-1]).to(device))),
                repro_torch.segment_argmax(scores[:qo[-1]].to(device), qo))

    K.reset_launch_counts()
    card = calls(dev, nq)
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    want = {n: 0 for n in K.LAUNCHES}
    for lens in ([1024], np.diff(q_offs), np.diff(offs_a), nb, np.diff(q_offs)):
        want["seg_sort"] += sum(c.width > 1 for c in bucket_segments(lens, 1024)[0])
    want["seg_merge"] = len(bucket_merge_pairs(np.diff(offs_a), nb, 1024)[0])
    log(f"  launches, segmented library calls: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"segmented library calls: launch counts {got} != {want}")
    n_check = 256  # the CPU's plain versions on the first 256 queries
    cpu = calls("cpu", n_check)

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [t for v in x.values() for t in flat(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in flat(v)]
        return []

    nt = n_check * kq
    for name, g, c in zip(("segment_sort (MoE grouping)", "segment_topk (re-rank)",
                           "segment_merge", "segment_argmax"), card, cpu):
        gt, ct = flat(g), flat(c)
        if name.startswith("segment_topk"):
            gt = [t[:nt] for t in gt]
        if name.startswith("segment_argmax"):
            gt = [t[:n_check] for t in gt]
        for x, y in zip(gt, ct):
            x = x.cpu()
            x, y = (bits(x), bits(y)) if x.dtype.is_floating_point else (x, y)
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: the card differs from the CPU")
        log(f"  {name}: equal to the CPU's plain versions")
    return got


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def phase_times(dev, K, logits, smoke_logits, launches, err, card, ops_per_s) -> list:
    """Phase 4: each kernel on the main path's own logits, beside its
    bound, its plain version and torch.topk on the same input."""
    import torch

    from repro_torch.api import topk_block

    rows = []
    bsz, vocab = logits.shape
    k = 64
    # router: the smoke-width launcher's prefill logits (4, 256), k = 64
    xr = smoke_logits
    e = xr.shape[1]
    rb = topk_block(e, k)
    eager = {"router_topk": cuda_ms(lambda: K.router_topk(xr, k, block=rb), 200)}
    ms = graph_ms(lambda: K.router_topk(xr, k, block=rb), 200)
    plain = graph_ms(lambda: K.router_topk_plain(xr, k, rb), 20)
    lib = graph_ms(lambda: torch.topk(xr, k, dim=-1), 200)
    g, ln, comps = e // rb, min(k, rb), bsz * e * rb
    while g > 1:
        gp = (g + 1) // 2
        comps += bsz * gp * 2 * ln * search_steps(ln)
        g, ln = gp, min(k, 2 * ln)
    b_ms, b_by = bound_ms(bsz * e * xr.element_size() + bsz * k * (xr.element_size() + 4),
                          comps, ops_per_s)
    rows.append(dict(name="router_topk", route="cuda", source=SOURCE,
                     replaces="src/repro/kernels/topk.py:60",
                     launches=launches["router_topk"], max_abs_err=err["router_topk"],
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    # vocab phase 1: the full-width prefill logits (bf16), k = 64
    vb = topk_block(vocab, k)
    nblk, kk = K.vocab_blocks(vocab, vb), min(k, vb)
    eager["vocab_phase1"] = cuda_ms(lambda: K.vocab_phase1(logits, k, vb), 100)
    ms = graph_ms(lambda: K.vocab_phase1(logits, k, vb), 100)
    plain = graph_ms(lambda: K.vocab_phase1_plain(logits, k, vb), 5)
    padded = torch.cat([logits, logits.new_full((bsz, nblk * vb - vocab), float("-inf"))], 1)
    per_block = padded.view(bsz, nblk, vb)
    lib = graph_ms(lambda: torch.topk(per_block, kk, dim=-1), 100)
    real_blocks = -(-vocab // vb)
    b_ms, b_by = bound_ms(bsz * vocab * logits.element_size() + bsz * nblk * kk * 8,
                          bsz * real_blocks * vb * vb, ops_per_s)
    rows.append(dict(name="vocab_phase1", route="cuda", source=SOURCE,
                     replaces="src/repro/kernels/topk.py:122",
                     launches=launches["vocab_phase1"], max_abs_err=err["vocab_phase1"],
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    # the merge tree of one sampled token, on phase 1's lists (its launches)
    keys, idx = K.vocab_phase1(logits, k, vb)
    eager["vocab_merge_level"] = cuda_ms(
        lambda: K.vocab_merge_tree(keys, idx, k, logits.dtype), 100)
    ms = graph_ms(lambda: K.vocab_merge_tree(keys, idx, k, logits.dtype), 100)
    plain = graph_ms(lambda: K.vocab_merge_tree_plain(keys, idx, k, logits.dtype), 5)
    flat = keys.view(bsz, nblk * kk)
    lib = graph_ms(lambda: torch.topk(flat, k, dim=-1), 100)
    comps, g, ln = 0, nblk, kk
    while g > 1:
        comps += bsz * g * ln * search_steps(ln)
        g, ln = g // 2, min(k, 2 * ln)
    b_ms, b_by = bound_ms(bsz * nblk * kk * 8 + bsz * k * (logits.element_size() + 4),
                          comps, ops_per_s)
    rows.append(dict(name="vocab_merge_level", route="cuda", source=SOURCE,
                     replaces="src/repro/kernels/topk.py:142",
                     launches=launches["vocab_merge_level"],
                     max_abs_err=err["vocab_merge_level"],
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    log("  device time per call (CUDA graph replay); eager = the same call "
        "launched from Python, host launch cost included")
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; eager {eager[r['name']]:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"torch.topk {r['library_ms']:.4f} ms; {card}")
    # the whole vocab top-k of one sampled token against one torch.topk call
    from repro_torch import topk

    log(f"  repro_torch.topk B={bsz} V={vocab} k={k} bf16: "
        f"{graph_ms(lambda: topk(logits, k), 100):.4f} ms "
        f"(eager {cuda_ms(lambda: topk(logits, k), 100):.4f} ms), torch.topk "
        f"{graph_ms(lambda: torch.topk(logits, k, dim=-1), 100):.4f} ms; {card}")
    # the MoE-router shape of the kernel tests: T=4096, E=256, k=16
    xm = special_logits(4096, 256, torch.bfloat16, dev, seed=8)
    rb16 = topk_block(256, 16)
    log(f"  router_topk T=4096 E=256 k=16 bf16: "
        f"{graph_ms(lambda: K.router_topk(xm, 16, block=rb16), 100):.4f} ms, torch.topk "
        f"{graph_ms(lambda: torch.topk(xm, 16, dim=-1), 100):.4f} ms; {card}")
    return rows


def phase_seg_times(dev, SK, rows, k_out, launches, err, card, ops_per_s) -> list:
    """Phase 4, segmented: the class sort at the engine's decode tile (the
    first tick's logits at smoke width), the class merge at (512, 512),
    each beside its bound, its plain version and one torch.sort call."""
    import torch

    out = []

    def sort_row(x, lens, k_out, flip, pay=()):
        s_, w = x.shape
        call = lambda: SK.segment_class_sort(x, lens, pay, k_out=k_out, flip=flip,  # noqa: E731
                                             want_perm=True)
        plain = lambda: SK.segment_class_sort_plain(x, lens, pay, k_out=k_out,  # noqa: E731
                                                    flip=flip, want_perm=True)
        ms, eager = graph_ms(call, 200), cuda_ms(call, 200)
        pl_ms = graph_ms(plain, 5)
        lib = graph_ms(lambda: torch.sort(x, dim=-1, descending=flip, stable=True), 200)
        isz = x.element_size()
        nbytes = (s_ * w * isz + s_ * 4 + s_ * k_out * (isz + 4)
                  + sum(p.numel() * p.element_size() * (1 + k_out / w) for p in pay))
        return ms, eager, pl_ms, lib, bound_ms(nbytes, sort_comparisons(lens), ops_per_s)

    full = torch.full((rows.shape[0], 1), rows.shape[1], dtype=torch.int32, device=dev)
    ms, eager, pl_ms, lib, (b_ms, b_by) = sort_row(rows, full, k_out, True)
    out.append(dict(name="seg_sort", route="cuda", source=SEG_SOURCE,
                    replaces="src/repro/kernels/segmented.py:97",
                    launches=launches["seg_sort"], max_abs_err=err["seg_sort"],
                    ms=ms, plain_ms=pl_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    log(f"  seg_sort engine decode tile {tuple(rows.shape)} {rows.dtype} k_out {k_out}: "
        f"{ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}; eager {eager:.4f} ms), plain "
        f"{pl_ms:.4f} ms, torch.sort {lib:.4f} ms; {card}")
    for name, s_, w, dt, k, flip, pay in (
            ("MoE grouping sort", 1, 1024, torch.int32, 1024, False, True),
            ("re-rank top-64", 4096, 1024, torch.bfloat16, 64, True, False)):
        x = seg_tile(s_, w, dt, dev, seed=w)
        lens = torch.full((s_, 1), w, dtype=torch.int32, device=dev)
        pl = ((torch.arange(s_ * w, dtype=torch.int32, device=dev).reshape(s_, w),)
              if pay else ())
        ms2, eager2, pl2, lib2, (b2, by2) = sort_row(x, lens, k, flip, pl)
        log(f"  seg_sort {name} ({s_}, {w}) {dt} k_out {k}: {ms2:.4f} ms (bound {b2:.6f} ms "
            f"by {by2}; eager {eager2:.4f} ms), plain {pl2:.4f} ms, torch.sort {lib2:.4f} ms; "
            f"{card}")
        for er in (4, 8):  # the sort executor's two layouts of a 1024-wide row
            with sort_lanes(er):
                t = graph_ms(lambda: SK.segment_class_sort(x, lens, pl, k_out=k, flip=flip,
                                                           want_perm=True), 200)
            log(f"  seg_sort {name} at {er} lanes a thread: {t:.4f} ms; {card}")
    # class merge: 256 rows of (512, 512) f32, lengths below the widths, a payload
    s_, wa, wb = 256, 512, 512
    la, lb = seg_lens(s_, wa, dev, seed=1), seg_lens(s_, wb, dev, seed=2)
    a = SK.segment_class_sort_plain(seg_tile(s_, wa, torch.float32, dev, seed=3), la)[0]
    b = SK.segment_class_sort_plain(seg_tile(s_, wb, torch.float32, dev, seed=4), lb)[0]
    pay = (torch.arange(s_ * (wa + wb), dtype=torch.int32, device=dev).reshape(s_, wa + wb),)
    call = lambda: SK.segment_class_merge(a, b, la, lb, pay, want_perm=True)  # noqa: E731
    ms, eager = graph_ms(call, 200), cuda_ms(call, 200)
    pl_ms = graph_ms(lambda: SK.segment_class_merge_plain(a, b, la, lb, pay, want_perm=True), 5)
    cat = torch.cat([a, b], dim=1)
    lib = graph_ms(lambda: torch.sort(cat, dim=-1, stable=True), 200)
    nbytes = s_ * (wa + wb) * (4 + 4) + s_ * 8 + s_ * (wa + wb) * (4 + 4 + 4)
    # a merge needs one comparison per valid output lane
    b_ms, b_by = bound_ms(nbytes, float((la + lb).sum()), ops_per_s)
    out.append(dict(name="seg_merge", route="cuda", source=SEG_SOURCE,
                    replaces="src/repro/kernels/segmented.py:115",
                    launches=launches["seg_merge"], max_abs_err=err["seg_merge"],
                    ms=ms, plain_ms=pl_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    log(f"  seg_merge ({s_}, {wa}+{wb}) f32 + payload: {ms:.4f} ms (bound {b_ms:.6f} ms by "
        f"{b_by}; eager {eager:.4f} ms), plain {pl_ms:.4f} ms, torch.sort of the pair "
        f"{lib:.4f} ms; {card}")
    return out


# ---------------------------------------------------------------------------
# the library's merge and sort: kernel rows 1, 2 and 9
# ---------------------------------------------------------------------------


def total_order_sorted(x, descending=False):
    """Rows in the total order of their keys (NaN last, -0.0 below +0.0):
    the sorted inputs a merge takes."""
    import torch

    from repro_torch.kernels.common import encode_key_values, take_along

    keys = encode_key_values(x) if x.dtype.is_floating_point else x
    order = torch.argsort(keys, dim=-1, stable=True)
    return take_along(x, 1, order.flip(-1) if descending else order)


def finite_sorted(rows, n, dtype, device, seed):
    """Ascending rows with ties, ±inf-free, without NaN and without -0.0:
    the float rows on which the grid kernel's key merge and the plain
    carry loop's raw-float merge agree."""
    import torch

    x = seg_tile(rows, n, dtype, device, seed)
    x = torch.nan_to_num(x, nan=1.0, posinf=2.0, neginf=-2.0) + 0.0  # -0.0 + 0.0 = +0.0
    return total_order_sorted(x)


def sorted_keys_decoded(x):
    """torch.sort of the keys of each row, decoded: the exact values-only
    answer of a merge or sort (a yardstick, never the port's path)."""
    import torch

    from repro_torch.kernels.common import decode_key_values, encode_key_values

    if not x.dtype.is_floating_point:
        return torch.sort(x, dim=-1)[0]
    return decode_key_values(torch.sort(encode_key_values(x), dim=-1)[0], x.dtype)


def phase_merge_sort_kernels(dev, capable_families) -> dict:
    """Phase 2, rows 1, 2 and 9: the 2-way merge, the fused sort and the
    grid merge bit-equal to their plain versions (values, perm, payload
    lanes with and without a feature dim) in bf16, f32 and int32 on rows
    with NaN, ±inf, ±0.0 and heavy ties, every capable family, both
    orders, pow2 and padded widths, and at the shapes of phase 3e."""
    import torch

    from repro_torch.kernels import topk as K
    from repro_torch.kernels.common import ceil_pow2
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain
    from repro_torch.networks import pick_merge_cols
    from repro_torch.streaming.grid_merge import grid_chunked_merge2, grid_chunked_merge2_plain

    err = {"loms_merge2": 0.0, "loms_sort": 0.0, "grid_merge2": 0.0}
    dtypes = (torch.bfloat16, torch.float32, torch.int32)

    def key(dt):
        return dt if dt.is_floating_point else None

    def lanes(rows, width, seed, feat=2):
        return (torch.arange(rows * width * feat, dtype=torch.int32,
                             device=dev).reshape(rows, width, feat),
                seg_tile(rows, width, torch.bfloat16, dev, seed=seed))

    def merge_case(name, a, b, pay, fam, desc, chunk=512):
        kw = dict(network=fam, n_cols=pick_merge_cols(a.shape[1], b.shape[1]),
                  key_dtype=key(a.dtype), descending=desc, want_perm=True)
        got = loms_merge2(a, b, pay, **kw)
        want = plain_in_chunks(lambda r: loms_merge2_plain(
            a[r], b[r], tuple(p[r] for p in pay), **kw), a.shape[0], chunk)
        err["loms_merge2"] = max(err["loms_merge2"], require_same_class(name, got, want))

    def sort_case(name, x, pay, fam, desc, chunk=512, layouts=(0,)):
        kw = dict(network=fam, key_dtype=key(x.dtype), descending=desc, want_perm=True)
        want = plain_in_chunks(lambda r: loms_sort_plain(
            x[r], tuple(p[r] for p in pay), **kw), x.shape[0], chunk)
        for lanes in layouts:
            with sort_lanes(lanes):
                got = loms_sort(x, pay, **kw)
            err["loms_sort"] = max(err["loms_sort"], require_same_class(
                f"{name} lanes={lanes}", got, want))

    for m, n in ((8, 8), (16, 48), (64, 64), (512, 512), (1000, 24), (65_536, 32)):
        rows = 16 if m + n > 2048 else 64
        fams = capable_families("merge2", (m, n))
        for dt in dtypes:
            for desc in (False, True):
                a = total_order_sorted(seg_tile(rows, m, dt, dev, seed=m), desc)
                b = total_order_sorted(seg_tile(rows, n, dt, dev, seed=n + 1), desc)
                for fam in fams:
                    merge_case(f"merge ({m}, {n}) {dt} {fam} desc={desc}", a, b,
                               lanes(rows, m + n, m + 2), fam, desc)
        log(f"  loms_merge2 ({m}, {n}): {', '.join(fams)} x bf16/f32/int32 x both orders, "
            f"{rows} rows, payload lanes (F=2 int32, bf16): bit-equal")
    for n in (1, 2, 16, 37, 128, 1007, 1024):
        fams = capable_families("sort", (ceil_pow2(n),))
        for dt in dtypes:
            x = seg_tile(33, n, dt, dev, seed=n)
            for desc in (False, True):
                for fam in fams:
                    sort_case(f"sort n={n} {dt} {fam} desc={desc}", x, lanes(33, n, n + 3),
                              fam, desc)
        log(f"  loms_sort n={n}: {', '.join(fams)} x bf16/f32/int32 x both orders, 33 rows, "
            f"payload lanes: bit-equal")
    # the tiled kernel of the single-level programs (s2ms, loms columns),
    # forced onto short rows at small tiles so that several CTAs share a row
    for m, n in ((8, 8), (16, 48), (512, 512), (1000, 24), (65_536, 32)):
        rows = 4 if m + n > 2048 else 24
        for dt in dtypes:
            for desc in (False, True):
                a = total_order_sorted(seg_tile(rows, m, dt, dev, seed=m + 5), desc)
                b = total_order_sorted(seg_tile(rows, n, dt, dev, seed=n + 6), desc)
                for tile in (1, 5, 64):
                    with merge_tile(tile):
                        for fam in ("loms", "s2ms"):
                            merge_case(f"tiled merge ({m}, {n}) tile={tile} {dt} {fam} "
                                       f"desc={desc}", a, b, lanes(rows, m + n, m + 7), fam,
                                       desc)
        log(f"  loms_merge2 tiled ({m}, {n}): tiles of 1, 5, 64 rows x loms/s2ms x "
            f"bf16/f32/int32 x both orders, {rows} rows, payload lanes: bit-equal")
    # the shapes of phase 3e
    ids = lambda rows, w: (torch.arange(rows * w, dtype=torch.int32,  # noqa: E731
                                        device=dev).reshape(rows, w),)
    for name, rows, m, n, desc, pay in (
            ("(65536, 32 + 32) f32", 65_536, 32, 32, False, False),
            ("(4096, 512 + 512) f32 desc + int32 ids", 4096, 512, 512, True, True),
            ("(64, 65536 + 32) f32 (tiled)", 64, 65_536, 32, False, False)):
        a = total_order_sorted(seg_tile(rows, m, torch.float32, dev, seed=rows + m), desc)
        b = total_order_sorted(seg_tile(rows, n, torch.float32, dev, seed=rows + n + 1), desc)
        merge_case(f"merge {name}", a, b, ids(rows, m + n) if pay else (), "loms", desc,
                   chunk=8192 if m + n <= 64 else 512)
        log(f"  loms_merge2 {name}: bit-equal")
    for name, rows, n, dt, desc, pay in (
            ("(16384, 1024) bf16 + int32 payload", 16_384, 1024, torch.bfloat16, False, True),
            ("(16, 1007) f32 desc", 16, 1007, torch.float32, True, False)):
        x = seg_tile(rows, n, dt, dev, seed=rows)
        sort_case(f"sort {name}", x, ids(rows, n) if pay else (), "loms", desc,
                  chunk=1024, layouts=LANE_LAYOUTS)
        log(f"  loms_sort {name}: bit-equal at lanes a thread {LANE_LAYOUTS} (0: the plan's)")
    # row 9: int32 keys with their extremes, and float rows as keys, at the
    # wrapper's tiles (up to 4096 outputs) and at forced tiles of 256 and
    # 768 (ties across tile boundaries), B = 1, 4 and 8; then rows read in
    # place from one buffer (strided views), and the sort spill's levels
    def grid_case(name, a, b, want):
        for items in (0, 1, 3):
            with grid_items(items):
                got = grid_chunked_merge2(a, b)
            if not torch.equal(bits(got) if got.dtype.is_floating_point else got,
                               bits(want) if want.dtype.is_floating_point else want):
                tile = f"a tile of {items * 256}" if items else "the wrapper's tile"
                raise AssertionError(f"grid merge {name}, {tile}: differs from the plain "
                                     "version")
            err["grid_merge2"] = max(err["grid_merge2"], max_abs_err(got, want))

    for rows, na, nb in ((3, 1000, 300), (2, 37, 0), (2, 0, 5), (4, 4096, 4096),
                         (1, 100_000, 100_000), (8, 5000, 3333), (1, 70_001, 1)):
        for dt in (torch.int32, torch.float32):
            if dt == torch.int32:
                a = total_order_sorted(seg_tile(rows, na, dt, dev, seed=na))
                b = total_order_sorted(seg_tile(rows, nb, dt, dev, seed=nb + 1))
            else:
                a = finite_sorted(rows, na, dt, dev, seed=na)
                b = finite_sorted(rows, nb, dt, dev, seed=nb + 1)
            grid_case(f"({rows}, {na} + {nb}) {dt}", a, b,
                      grid_chunked_merge2_plain(a, b, tile=512))
        log(f"  grid_merge2 ({rows}, {na} + {nb}) int32 keys and f32 rows: bit-equal to "
            "the plain carry loop at the wrapper's tiles and at 256 and 768 outputs")
    for dt in (torch.int32, torch.bfloat16):
        if dt.is_floating_point:  # no NaN, no -0.0: the key merge is the raw one
            buf = torch.cat([finite_sorted(4, n, dt, dev, seed=n) for n in (1701, 1299)], 1)
        else:
            buf = torch.cat([total_order_sorted(seg_tile(4, n, dt, dev, seed=n))
                             for n in (1701, 1299)], dim=1)
        a, b = buf[:, :1701], buf[:, 1701:]
        grid_case(f"strided (4, 1701 + 1299) {dt}", a, b, grid_chunked_merge2_plain(
            a.contiguous(), b.contiguous(), tile=512))
    log("  grid_merge2 on strided row views (4, 1701 + 1299) int32 and bf16: bit-equal")
    from repro_torch.segmented.core import _spill_sort_values

    for s_, ln in ((4, 1100), (1, 2500), (8, 65_536), (1, 65_536)):
        x = seg_tile(s_, ln, torch.float32, dev, seed=ln + s_)
        K.reset_launch_counts()
        got = _spill_sort_values(x, False, 512)
        torch.cuda.synchronize()
        c = -(-ln // 512)
        if K.LAUNCHES["grid_merge2"] != spill_merges(c):
            raise AssertionError(f"sort spill ({s_}, {ln}): {K.LAUNCHES['grid_merge2']} grid "
                                 f"merges, not {spill_merges(c)}")
        want = _spill_sort_values(x.cpu(), False, 512)
        if not torch.equal(bits(got.cpu()), bits(want)):
            raise AssertionError(f"sort spill ({s_}, {ln}): differs from the plain version")
        log(f"  values-only sort spill ({s_}, {ln}) f32: {c} runs in "
            f"{spill_merges(c)} grid-merge launches, bit-equal to the plain version")
    torch.cuda.synchronize()
    return err


def spill_merges(c: int) -> int:
    """Grid-merge launches of the values-only sort spill of ``c`` runs: one a
    level of pairs, and one more where an odd run meets the carried rest."""
    m, rest, n = c, False, 0
    while m + rest > 1:
        n += (m // 2 > 0) + (m % 2 == 1 and rest)
        m, rest = m // 2, rest or m % 2 == 1
    return n


def phase_library_merge_sort(dev):
    """Phase 3e: the library's merge and sort at the sizes their users
    run, each call with its launch counts zeroed before and read after;
    outputs bit-equal to the CPU's plain versions on the same input (all
    rows or the first ones), or, for the largest values-only rows, to
    torch.sort of the keys, decoded."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import topk as K
    from repro_torch.segmented import bucket_merge_pairs

    def f32_sorted(rows, n, seed, desc=False):
        return total_order_sorted(seg_tile(rows, n, torch.float32, dev, seed=seed), desc)

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        return tuple(to_cpu(t) for t in x) if isinstance(x, (tuple, list)) else x

    def same(name, got, want):
        gs = got if isinstance(got, (tuple, list)) else (got,)
        ws = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(gs, ws):
            g = g.cpu()
            w = w.cpu()
            if g.shape != w.shape or not torch.equal(
                    bits(g) if g.dtype.is_floating_point else g,
                    bits(w) if w.dtype.is_floating_point else w):
                raise AssertionError(f"{name}: differs from the plain version")

    rng = np.random.default_rng(14)
    a1, b1 = f32_sorted(65_536, 32, 1), f32_sorted(65_536, 32, 2)
    a2, b2 = f32_sorted(4096, 512, 3, desc=True), f32_sorted(4096, 512, 4, desc=True)
    id2 = torch.arange(4096 * 1024, dtype=torch.int32, device=dev).reshape(4096, 1024)
    a3, b3 = f32_sorted(64, 65_536, 5), f32_sorted(64, 32, 6)
    x4 = seg_tile(16_384, 1024, torch.bfloat16, dev, seed=7)
    p4 = torch.arange(16_384 * 1024, dtype=torch.int32, device=dev).reshape(16_384, 1024)
    x5 = seg_tile(16, 1007, torch.float32, dev, seed=8)
    a6, b6 = f32_sorted(8, 1 << 22, 9), f32_sorted(8, 1 << 22, 10)
    a7 = torch.sort(torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)))[0]
    b7 = torch.sort(torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)))[0]
    a7, b7 = a7.to(dev), b7.to(dev)
    n_seg, seg_len = 16, 65_536
    v8 = seg_tile(1, n_seg * seg_len, torch.float32, dev, seed=11).reshape(-1)
    offs8 = tuple(range(0, n_seg * seg_len + 1, seg_len))
    la9 = np.array([1000] * 16 + [3000] * 16 + [40] * 32)
    lb9 = np.array([600] * 16 + [50] * 16 + [20] * 32)
    oa9 = tuple(np.concatenate([[0], np.cumsum(la9)]).tolist())
    ob9 = tuple(np.concatenate([[0], np.cumsum(lb9)]).tolist())
    a9 = repro_torch.segment_sort(seg_tile(1, oa9[-1], torch.float32, dev, seed=12)
                                  .reshape(-1), oa9)
    b9 = repro_torch.segment_sort(seg_tile(1, ob9[-1], torch.float32, dev, seed=13)
                                  .reshape(-1), ob9)
    spill_groups = len(bucket_merge_pairs(la9, lb9, 1024)[1])
    chunks = seg_len // 512  # the sort spill's runs a segment: one launch a level

    def one(**kw):
        return {**{n: 0 for n in K.LAUNCHES}, **kw}

    cases = (
        ("merge (65536, 32) + (65536, 32) f32: the paper's 32 + 32 device",
         lambda: repro_torch.merge(a1, b1),
         lambda: repro_torch.merge(a1.cpu(), b1.cpu()), one(loms_merge2=1)),
        ("merge (4096, 512) + (4096, 512) f32 desc, int32 ids: two kept lists a query",
         lambda: repro_torch.merge(a2, b2, descending=True,
                                   payload=(id2[:, :512], id2[:, 512:])),
         lambda: repro_torch.merge(a2[:1024].cpu(), b2[:1024].cpu(), descending=True,
                                   payload=(id2[:1024, :512].cpu(), id2[:1024, 512:].cpu())),
         one(loms_merge2=1)),
        ("merge (64, 65536) + (64, 32) f32: new keys into a long run (tiled)",
         lambda: repro_torch.merge(a3, b3),
         lambda: repro_torch.merge(a3.cpu(), b3.cpu()), one(loms_merge2=1)),
        ("sort (16384, 1024) bf16 + int32 payload",
         lambda: repro_torch.sort(x4, payload=p4),
         lambda: repro_torch.sort(x4[:256].cpu(), payload=p4[:256].cpu()), one(loms_sort=1)),
        ("sort (16, 1007) f32 desc",
         lambda: repro_torch.sort(x5, descending=True),
         lambda: repro_torch.sort(x5.cpu(), descending=True), one(loms_sort=1)),
        ("merge (8, 2^22) + (8, 2^22) f32: past the budget, streams",
         lambda: repro_torch.merge(a6, b6),
         lambda: sorted_keys_decoded(torch.cat([a6, b6], dim=1)), one(grid_merge2=1)),
        ("merge 100,000 + 100,000 f32 (the stream-merge example)",
         lambda: repro_torch.merge(a7, b7),
         lambda: repro_torch.merge(a7.cpu(), b7.cpu()), one(grid_merge2=1)),
        ("segment_sort 16 x 65,536 f32, values only: the spill",
         lambda: repro_torch.segment_sort(v8, offs8),
         lambda: sorted_keys_decoded(v8.reshape(n_seg, seg_len)).reshape(-1),
         one(seg_sort=1, grid_merge2=spill_merges(chunks))),
        ("segment_merge 64 pairs f32, values only, 32 past the class width",
         lambda: repro_torch.segment_merge(a9, b9, oa9, ob9)[0],
         lambda: repro_torch.segment_merge(a9.cpu(), b9.cpu(), oa9, ob9)[0],
         one(seg_merge=1, grid_merge2=spill_groups)),
    )
    total = {n: 0 for n in K.LAUNCHES}
    for name, call, plain, want in cases:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(K.LAUNCHES)
        if counts != want:
            raise AssertionError(f"{name}: launch counts {counts} != {want}")
        for n, c in counts.items():
            total[n] += c
        ref = plain()
        sub = got
        if isinstance(got, tuple):  # values and a payload tree, first rows only
            rows = ref[0].shape[0]
            sub = (got[0][:rows], got[1][:rows])
        elif got.ndim == 2 and ref.shape[0] < got.shape[0]:
            sub = got[:ref.shape[0]]
        same(name, to_cpu(sub), to_cpu(ref))
        out = got[0] if isinstance(got, tuple) else got
        if not bool(torch.isfinite(out.float()).any()) and out.numel():
            raise AssertionError(f"{name}: no finite value out")
        log(f"  {name}: {wall:.2f} ms eager (first call); launches "
            f"{ {n: c for n, c in counts.items() if c} }; bit-equal to the plain version")
    return total


def phase_merge_sort_times(dev, launches, err, card, ops_per_s) -> list:
    """Phase 4, rows 1, 2 and 9 at the shapes of phase 3e, each beside its
    bound, its plain version and one PyTorch call (torch.sort of the
    concatenation, or torch.sort(stable=True) and a gather)."""
    import torch

    from repro_torch.kernels.common import encode_key_values
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain
    from repro_torch.networks import pick_merge_cols
    from repro_torch.streaming.grid_merge import grid_chunked_merge2, grid_chunked_merge2_plain

    rows = []

    def row(name, source, replaces, ms, plain, nbytes, comparisons, lib):
        b_ms, b_by = bound_ms(nbytes, comparisons, ops_per_s)
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=err[name], ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        return b_ms, b_by

    # row 1 at the three merges of 3e; the first is the kernels line's
    merges = []
    for name, bsz, m, n, desc, pay in (
            ("(65536, 32 + 32) f32", 65_536, 32, 32, False, False),
            ("(4096, 512 + 512) f32 desc + int32 ids", 4096, 512, 512, True, True),
            ("(64, 65536 + 32) f32 (tiled)", 64, 65_536, 32, False, False)):
        a = total_order_sorted(seg_tile(bsz, m, torch.float32, dev, seed=m), desc)
        b = total_order_sorted(seg_tile(bsz, n, torch.float32, dev, seed=n), desc)
        lanes = ((torch.arange(bsz * (m + n), dtype=torch.int32, device=dev)
                  .reshape(bsz, m + n),) if pay else ())
        kw = dict(n_cols=pick_merge_cols(m, n), key_dtype=torch.float32, descending=desc)
        ms = graph_ms(lambda: loms_merge2(a, b, lanes, **kw), 50)
        plain = graph_ms(lambda: loms_merge2_plain(a, b, lanes, **kw), 3)
        cat = torch.cat([a, b], dim=1)
        if pay:
            def lib_call():
                v, i = torch.sort(cat, dim=-1, descending=desc, stable=True)
                return v, torch.gather(lanes[0], 1, i)
        else:
            def lib_call():
                return torch.sort(cat, dim=-1, descending=desc)
        lib = graph_ms(lib_call, 50)
        nbytes = bsz * (m + n) * (4 + 4) * (2 if pay else 1)
        merges.append((name, ms, plain, lib, nbytes, bsz * (m + n)))
    name, ms, plain, lib, nbytes, comps = merges[0]
    row("loms_merge2", MERGE_SOURCE, "src/repro/kernels/loms_merge.py:49", ms, plain,
        nbytes, comps, lib)
    for name, ms, plain, lib, nbytes, comps in merges:
        b_ms, b_by = bound_ms(nbytes, comps, ops_per_s)
        log(f"  loms_merge2 {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
            f"{plain:.4f} ms, torch.sort {lib:.4f} ms; {card}")
    # row 2 at the two sorts of 3e; the first is the kernels line's
    sorts = []
    for name, bsz, n, dt, desc, pay in (
            ("(16384, 1024) bf16 + int32 payload", 16_384, 1024, torch.bfloat16, False, True),
            ("(16, 1007) f32 desc", 16, 1007, torch.float32, True, False)):
        x = seg_tile(bsz, n, dt, dev, seed=n)
        lanes = ((torch.arange(bsz * n, dtype=torch.int32, device=dev).reshape(bsz, n),)
                 if pay else ())
        kw = dict(key_dtype=dt, descending=desc)
        ms = graph_ms(lambda: loms_sort(x, lanes, **kw), 20)
        plain = graph_ms(lambda: loms_sort_plain(x, lanes, **kw), 2)

        def lib_call():
            v, i = torch.sort(x, dim=-1, descending=desc, stable=True)
            return (v, torch.gather(lanes[0], 1, i)) if pay else v

        lib = graph_ms(lib_call, 20)
        nbytes = bsz * n * x.element_size() * 2 + (bsz * n * 4 * 2 if pay else 0)
        lg = max(n - 1, 1).bit_length()  # log2 of the padded width
        sorts.append((name, ms, plain, lib, nbytes, float(bsz * n * lg)))
        for er in (4, 8):  # the sort executor's two layouts of a 1024-wide row
            with sort_lanes(er):
                t = graph_ms(lambda: loms_sort(x, lanes, **kw), 20)
            log(f"  loms_sort {name} at {er} lanes a thread: {t:.4f} ms; {card}")
    name, ms, plain, lib, nbytes, comps = sorts[0]
    row("loms_sort", SORT_SOURCE, "src/repro/kernels/sort.py:57", ms, plain, nbytes,
        comps, lib)
    for name, ms, plain, lib, nbytes, comps in sorts:
        b_ms, b_by = bound_ms(nbytes, comps, ops_per_s)
        log(f"  loms_sort {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
            f"{plain:.4f} ms, torch.sort + gather {lib:.4f} ms; {card}")
    # row 9 at (8, 2^22 + 2^22), on the int32 keys the library passes it
    ka = encode_key_values(total_order_sorted(seg_tile(8, 1 << 22, torch.float32, dev, 1)))
    kb = encode_key_values(total_order_sorted(seg_tile(8, 1 << 22, torch.float32, dev, 2)))
    ms = graph_ms(lambda: grid_chunked_merge2(ka, kb), 20)
    plain = cuda_ms(lambda: grid_chunked_merge2_plain(ka, kb, tile=512), 1, warm=0)
    cat = torch.cat([ka, kb], dim=1)
    lib = graph_ms(lambda: torch.sort(cat, dim=-1), 20)
    b_ms, b_by = row("grid_merge2", GRID_SOURCE, "src/repro/streaming/grid_merge.py:43", ms,
                     plain, cat.numel() * 4 * 2, float(cat.numel()), lib)
    log(f"  grid_merge2 (8, 2^22 + 2^22) int32 keys: {ms:.4f} ms (bound {b_ms:.6f} ms by "
        f"{b_by}), plain carry loop {plain:.1f} ms (one call), torch.sort {lib:.4f} ms; "
        f"{card}")
    # the values-only sort spill of phase 3e: one class sort, one grid merge a level
    from repro_torch.segmented.core import _spill_sort_values

    xs = seg_tile(16, 65_536, torch.float32, dev, seed=11)
    spill = graph_ms(lambda: _spill_sort_values(xs, False, 512), 20)
    b_ms, b_by = bound_ms(xs.numel() * 4 * 2, float(xs.numel() * 16), ops_per_s)
    log(f"  sort spill 16 x 65,536 f32 (a class sort, {spill_merges(128)} grid merges): "
        f"{spill:.4f} ms (bound {b_ms:.6f} ms by {b_by}), torch.sort "
        f"{graph_ms(lambda: torch.sort(xs, dim=-1), 20):.4f} ms; {card}")
    return rows


# ---------------------------------------------------------------------------
# the k-way merge and the median: kernel row 8
# ---------------------------------------------------------------------------


def sorted_lists(rows, lens, dtype, device, seed, descending=False):
    """``len(lens)`` class tiles, each row sorted in the total order of its
    keys (descending: reversed)."""
    return [total_order_sorted(seg_tile(rows, n, dtype, device, seed + j), descending)
            for j, n in enumerate(lens)]


def phase_kway_kernels(dev) -> dict:
    """Phase 2, row 8: the k-way kernel bit-equal to its plain version
    (values, perm, payload lanes with and without a feature dim) in bf16,
    f32 and int32 on lists with NaN, ±inf, ±0.0 and heavy ties, both
    orders, the full and the truncated (two-stage) device, the MWMS and
    median schedules, and at the kernel shapes of phase 3f."""
    import torch

    from repro_torch.core import mwms_kway
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import kway_schedule, median_schedule

    err = {"kway_merge": 0.0}

    def case(name, x, sched, pay=(), chunk=512, **kw):
        got = kway_merge(x, sched, pay, **kw)
        want = plain_in_chunks(lambda r: kway_merge_plain(
            x[r], sched, tuple(p[r] for p in pay), **kw), x.shape[0], chunk)
        err["kway_merge"] = max(err["kway_merge"], require_same_class(name, got, want))

    for lens in ((7, 7, 7), (3,) * 8, (64,) * 4, (100, 50, 25), (5,) * 5, (7,) * 5,
                 (128,) * 8, (181,) * 8):
        total, sched = sum(lens), kway_schedule(lens)
        for dt in (torch.bfloat16, torch.float32, torch.int32):
            key = dt if dt.is_floating_point else None
            for desc in (False, True):
                x = torch.cat(sorted_lists(33, lens, dt, dev, total, desc), dim=1)
                pay = (torch.arange(33 * total * 2, dtype=torch.int32, device=dev)
                       .reshape(33, total, 2), seg_tile(33, total, torch.bfloat16, dev, 3))
                for n_stages in (None, 2):
                    case(f"kway {lens} {dt} desc={desc} n_stages={n_stages}", x, sched, pay,
                         n_stages=n_stages, lens=lens, key_dtype=key, descending=desc,
                         want_perm=True)
        log(f"  kway_merge {lens}: bf16/f32/int32 x both orders x full and two-stage "
            "devices, 33 rows, payload lanes (F=2 int32, bf16): bit-equal")
    for dt in (torch.bfloat16, torch.float32, torch.int32):
        key = dt if dt.is_floating_point else None
        for lens in ((7, 7, 7), (7,) * 5):
            x = torch.cat(sorted_lists(64, lens, dt, dev, 5), dim=1)
            med, pos = median_schedule(lens)
            scheds = (med, median_readout(med, pos))
            if len(lens) == 3:
                scheds += (mwms_kway(lens),)
            for sched in scheds:
                case(f"kway {sched.name} {dt}", x, sched, want_perm=True, key_dtype=key)
    log("  kway_merge MWMS 3 x 7 and the 3 x 7 and 5 x 7 median devices (all cells, the "
        "center cell): bf16/f32/int32: bit-equal")
    # the kernel shapes of phase 3f, in the modes the library calls them
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    for name, rows, lens, dt, desc, pay, median in (
            ("3 x 7 f32", 1 << 20, (7, 7, 7), f32, False, False, False),
            ("3 x 7 int32 keys median", 1 << 20, (7, 7, 7), i32, False, False, True),
            ("4 x 64 bf16 desc + int32 ids", 65_536, (64,) * 4, bf16, True, True, False),
            ("8 x 128 int32", 16_384, (128,) * 8, i32, False, False, False),
            ("(100, 50, 25) f32", 65_536, (100, 50, 25), f32, False, False, False),
            ("5 x 7 int32 keys median", 1 << 20, (7,) * 5, i32, False, False, True),
            ("the chunked merge's 8 x 128 int32 segments", 65_536, (128,) * 8, i32,
             False, False, False)):
        x = torch.cat(sorted_lists(rows, lens, dt, dev, rows % 97 + sum(lens), desc), dim=1)
        lanes = ((torch.arange(rows * x.shape[1], dtype=torch.int32, device=dev)
                  .reshape(rows, -1),) if pay else ())
        if median:
            sched, pos = median_schedule(lens)
            sched = median_readout(sched, pos)
        else:
            sched = kway_schedule(lens)
        case(f"kway {name}", x, sched, lanes, chunk=65_536 if sum(lens) <= 64 else 512,
             lens=lens, key_dtype=dt if dt.is_floating_point else None, descending=desc)
        log(f"  kway_merge ({rows}, {name}): bit-equal")
    torch.cuda.synchronize()
    return err


def special_float_rows(rows, n, dtype, device, seed, sort):
    """Rows with a -0.0 / +0.0 mix, all-negative rows with a -0.0, one
    +inf, one -inf, one NaN, several NaNs, the rest tied halves (sorted in
    raw-float order, NaN last, when ``sort``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (rows, n)) * 0.5).astype(np.float32)
    for r in range(0, rows, 8):
        x[r] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
        if r + 7 < rows:
            x[r + 1] = -np.abs(x[r + 1]) - 1.0
            x[r + 1, rng.integers(n)] = -0.0
            x[r + 2, rng.integers(n)] = np.inf
            x[r + 3, rng.integers(n)] = -np.inf
            x[r + 4, rng.integers(n)] = np.nan
            x[r + 5, rng.integers(0, n, 3)] = np.nan
            x[r + 6, rng.integers(n)] = -0.0
            x[r + 7] = -(np.arange(n, dtype=np.float32) + 1.0)
            x[r + 7, 0] = -0.0
    x = np.sort(x, axis=-1) if sort else x
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def phase_rawfloat_kernels(dev) -> dict:
    """Phase 2, the raw-float mode of rows 1, 2 and 8 (the reference's
    use_mxu=True, which its values-only wrappers take for float rows):
    each kernel bit-equal to its plain version on the card, NaN bits
    included (both write the canonical quiet NaN), values and positions,
    both orders, every capable family; and the values-only wrappers of
    ``kernels.ops`` on card rows bit-equal to the same calls on the CPU."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.common import ceil_pow2
    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.loms_merge import loms_merge2, loms_merge2_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.kernels.sort import loms_sort, loms_sort_plain
    from repro_torch.networks import (capable_families, kway_schedule, median_schedule,
                                      pick_merge_cols)

    err = {"loms_merge2": 0.0, "loms_sort": 0.0, "kway_merge": 0.0}

    def check(name, key, got, want):
        err[key] = max(err[key], require_same_class(name, got, want))

    rows = 64
    for dt in (torch.bfloat16, torch.float32):
        for m, n in ((4, 4), (32, 32), (64, 32)):
            for desc in (False, True):
                a = special_float_rows(rows, m, dt, dev, m, True)
                b = special_float_rows(rows, n, dt, dev, n + 1, True)
                if desc:
                    a, b = a.flip(-1).contiguous(), b.flip(-1).contiguous()
                for fam in capable_families("merge2", (m, n)):
                    kw = dict(network=fam, n_cols=pick_merge_cols(m, n), use_mxu=True,
                              descending=desc, want_perm=True)
                    check(f"raw merge ({m}, {n}) {dt} {fam} desc={desc}", "loms_merge2",
                          loms_merge2(a, b, **kw), loms_merge2_plain(a, b, **kw))
        for n in (8, 1007, 1024):
            x = special_float_rows(rows, n, dt, dev, n, False)
            for fam in capable_families("sort", (ceil_pow2(n),)):
                for desc in (False, True):
                    for perm in (False, True):
                        kw = dict(network=fam, use_mxu=True, descending=desc, want_perm=perm)
                        check(f"raw sort n={n} {dt} {fam} desc={desc} perm={perm}",
                              "loms_sort", loms_sort(x, **kw), loms_sort_plain(x, **kw))
        lens = (7, 7, 7)
        x = torch.cat([special_float_rows(rows, 7, dt, dev, 40 + j, True) for j in range(3)],
                      dim=1)
        med, pos = median_schedule(lens)
        for sched in (kway_schedule(lens), med, median_readout(med, pos)):
            kw = dict(use_mxu=True, want_perm=True)
            check(f"raw kway {sched.name} {dt}", "kway_merge", kway_merge(x, sched, **kw),
                  kway_merge_plain(x, sched, **kw))
        log(f"  raw-float mode {dt}: merge (4, 4), (32, 32), (64, 32); sort n = 8, 1007, "
            f"1024; k-way 3 x 7 and its medians: bit-equal to the plain versions, NaN bits "
            f"and positions included")
    a, b = special_float_rows(rows, 32, torch.float32, dev, 1, True), \
        special_float_rows(rows, 32, torch.float32, dev, 2, True)
    x = special_float_rows(rows, 1007, torch.bfloat16, dev, 3, False)
    lists = [special_float_rows(rows, 7, torch.float32, dev, 4 + j, True) for j in range(3)]
    cpu = [t.cpu() for t in lists]
    for name, got, want in (
            ("merge2", ops.merge2(a, b), ops.merge2(a.cpu(), b.cpu())),
            ("sort", ops.sort(x), ops.sort(x.cpu())),
            ("merge_k", ops.merge_k(lists), ops.merge_k(cpu)),
            ("median_k", ops.median_k(lists), ops.median_k(cpu))):
        if not torch.equal(bits(got.cpu()), bits(want)):
            raise AssertionError(f"kernels.ops.{name}: the card differs from the CPU")
    log("  kernels.ops merge2 / sort / merge_k / median_k on special floats: the card's "
        "raw-float kernels bit-equal to the CPU's plain versions")
    torch.cuda.synchronize()
    return err


def phase_library_kway(dev):
    """Phase 3f: the library's k-way calls at the sizes their users run,
    each with its launch counts zeroed before and read after: one row-8
    launch a call; outputs bit-equal to the plain version run in chunks
    on the same input, or for the values-only merges to torch.sort of
    the keys, decoded."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import topk as K
    from repro_torch.kernels.common import decode_key_values, encode_key_values
    from repro_torch.kernels.kway import kway_merge_plain
    from repro_torch.networks import kway_schedule

    def keys_of(x):
        return encode_key_values(x) if x.dtype.is_floating_point else x

    def kth_key(x, k):
        """The k-th smallest of each row in the total order of the keys."""
        ks = torch.sort(keys_of(x), dim=-1)[0][:, k]
        return decode_key_values(ks, x.dtype) if x.dtype.is_floating_point else ks

    def plain_median(lists, lens):
        from repro_torch.kernels.ops import median_readout
        from repro_torch.networks import median_schedule

        x = keys_of(torch.cat(lists, dim=1))
        med = median_readout(*median_schedule(lens))
        got = plain_in_chunks(lambda r: kway_merge_plain(x[r], med), x.shape[0], 65_536)[0]
        return decode_key_values(got[:, 0], lists[0].dtype)

    def plain_merge(lists, lens, payload=None, desc=False):
        x = torch.cat(lists, dim=1)
        pay = () if payload is None else (torch.cat(payload, dim=1),)
        key = x.dtype if x.dtype.is_floating_point else None
        got = plain_in_chunks(lambda r: kway_merge_plain(
            x[r], kway_schedule(lens), tuple(p[r] for p in pay), lens=lens,
            key_dtype=key, descending=desc), x.shape[0])
        return got[0] if payload is None else (got[0], got[2][0])

    rng = np.random.default_rng(15)
    a = sorted_lists(1 << 20, (7, 7, 7), torch.float32, dev, 41)
    b = sorted_lists(65_536, (64,) * 4, torch.bfloat16, dev, 42, descending=True)
    ids = [torch.from_numpy(rng.integers(0, 151_936, (65_536, 64)).astype(np.int32)).to(dev)
           for _ in range(4)]
    c = sorted_lists(16_384, (128,) * 8, torch.int32, dev, 43)
    d = sorted_lists(65_536, (100, 50, 25), torch.float32, dev, 44)
    e = sorted_lists(1 << 20, (7,) * 5, torch.float32, dev, 45)
    runs = sorted_lists(1, (1 << 20,) * 8, torch.int32, dev, 46)
    cat = lambda ls: torch.cat(ls, dim=1)  # noqa: E731

    def one(**kw):
        return {**{n: 0 for n in K.LAUNCHES}, **kw}

    cases = (
        ("merge_k 3 x 7 f32 over 1,048,576 rows: the paper's 3c_7r device",
         lambda: repro_torch.merge_k(a), lambda: sorted_keys_decoded(cat(a))),
        ("median_of_lists 3 x 7 f32 over 1,048,576 rows: its two-stage median",
         lambda: repro_torch.median_of_lists(a), lambda: kth_key(cat(a), 10)),
        ("merge_k 4 x 64 bf16 desc + int32 token ids over 65,536 rows: four vocab "
         "shards' kept top-64",
         lambda: repro_torch.merge_k(b, descending=True, payload=ids),
         lambda: plain_merge(b, (64,) * 4, ids, desc=True)),
        ("merge_k 8 x 128 int32 over 16,384 rows: the six-stage device at 1,024",
         lambda: repro_torch.merge_k(c), lambda: torch.sort(cat(c), dim=1)[0]),
        ("merge_k (100, 50, 25) f32 over 65,536 rows: mixed list sizes",
         lambda: repro_torch.merge_k(d), lambda: plain_merge(d, (100, 50, 25))),
        ("median_of_lists 5 x 7 f32 over 1,048,576 rows",
         lambda: repro_torch.median_of_lists(e), lambda: plain_median(e, (7,) * 5)),
        ("chunked_merge_k 8 runs of 2^20 int32 in one row: an external sort's merge "
         "phase (tile 128, 65,536 segment rows)",
         lambda: repro_torch.chunked_merge_k(runs), lambda: torch.sort(cat(runs), dim=1)[0]),
    )
    total = {n: 0 for n in K.LAUNCHES}
    for name, call, ref in cases:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(K.LAUNCHES)
        if counts != one(kway_merge=1):
            raise AssertionError(f"{name}: launch counts {counts} != one k-way launch")
        for n, c_ in counts.items():
            total[n] += c_
        want = ref()
        gs = got if isinstance(got, tuple) else (got,)
        ws = want if isinstance(want, tuple) else (want,)
        for g, w in zip(gs, ws):
            if g.shape != w.shape or not torch.equal(
                    bits(g) if g.dtype.is_floating_point else g,
                    bits(w) if w.dtype.is_floating_point else w):
                raise AssertionError(f"{name}: differs from the plain version")
        if not bool(torch.isfinite(gs[0].float()).any()):
            raise AssertionError(f"{name}: no finite value out")
        log(f"  {name}: {wall:.2f} ms eager (first call); launches {counts['kway_merge']} "
            f"kway_merge; bit-equal to the plain version, shape {tuple(gs[0].shape)}")
    # two devices are the reference's as they are, faults included (the
    # port is bit-equal to them): its Table 1 stage count is not a merge
    # at (100, 50, 25), and its two-stage median is not the median for
    # five lists; the builders' 0-1 checks skip both (ROADMAP Queue 3)
    out = keys_of(repro_torch.merge_k(d))
    bad = int((out[:, 1:] < out[:, :-1]).any(dim=1).sum())
    log(f"  merge_k (100, 50, 25): {bad} of {out.shape[0]} rows come out unsorted; "
        f"0-1 patterns not merged: {zero_one_faults((100, 50, 25))}")
    med = repro_torch.median_of_lists(e)
    bad = int((bits(med) != bits(kth_key(cat(e), 17))).sum())
    log(f"  median_of_lists 5 x 7: {bad} of {med.shape[0]} rows differ from the 18th "
        f"smallest; 0-1 patterns with a wrong median: {zero_one_faults((7,) * 5, True)}")
    return total


def zero_one_faults(lens, median=False) -> str:
    """How many of the prod(len + 1) per-list-sorted 0-1 inputs the LOMS
    device gets wrong (the 0-1 principle: none, for a merge network)."""
    import numpy as np

    from repro_torch.core import loms_kway, loms_median
    from repro_torch.core.networks import _per_list_sorted_01_patterns, apply_schedule_np

    pats = _per_list_sorted_01_patterns(lens)
    want = np.sort(pats, axis=-1)
    if median:
        sched, pos = loms_median(lens)
        bad = apply_schedule_np(sched, pats)[:, pos] != want[:, pos]
    else:
        bad = (apply_schedule_np(loms_kway(lens), pats) != want).any(axis=-1)
    return f"{int(bad.sum())} of {len(pats)}"


def phase_kway_times(dev, launches, err, card, ops_per_s) -> list:
    """Phase 4, row 8: the paper's 3 x 7 device over 1,048,576 rows (the
    kernels line's row) and its median, four 64-lists in bf16 with token
    ids over 65,536 rows, and eight 128-lists of int32 keys over 16,384
    rows and over the 65,536 segment rows of chunked_merge_k, each beside
    its bound, its plain version and one PyTorch call (torch.sort (+
    gather), torch.kthvalue)."""
    import torch

    from repro_torch.kernels.kway import kway_merge, kway_merge_plain
    from repro_torch.kernels.ops import median_readout
    from repro_torch.networks import kway_schedule, median_schedule

    rows, entries = [], []
    lg = lambda k: max(k - 1, 1).bit_length()  # noqa: E731  ceil(log2 k)
    # 3c_7r, values only, f32
    bsz, lens = 1 << 20, (7, 7, 7)
    x = torch.cat(sorted_lists(bsz, lens, torch.float32, dev, 51), dim=1)
    sched = kway_schedule(lens)
    ms = graph_ms(lambda: kway_merge(x, sched, key_dtype=torch.float32), 20)
    plain = graph_ms(lambda: kway_merge_plain(x, sched, key_dtype=torch.float32), 3)
    lib = graph_ms(lambda: torch.sort(x, dim=-1), 20)
    entries.append(("3 x 7 f32 (1048576 rows)", ms, plain, lib, "torch.sort",
                    bsz * 21 * 8, float(bsz * 21 * lg(3))))
    # its median: the center cell only
    med, pos = median_schedule(lens)
    med = median_readout(med, pos)
    ms_m = graph_ms(lambda: kway_merge(x, med, key_dtype=torch.float32), 20)
    plain_m = graph_ms(lambda: kway_merge_plain(x, med, key_dtype=torch.float32), 3)
    lib_m = graph_ms(lambda: torch.kthvalue(x, 11, dim=-1), 20)
    entries.append(("3 x 7 f32 median (1048576 rows)", ms_m, plain_m, lib_m,
                    "torch.kthvalue", bsz * 21 * 4 + bsz * 4, float(bsz * 21 * lg(3))))
    # four 64-lists, bf16, descending, int32 token ids
    bsz, lens = 65_536, (64,) * 4
    xb = torch.cat(sorted_lists(bsz, lens, torch.bfloat16, dev, 52, descending=True), dim=1)
    ids = torch.arange(bsz * 256, dtype=torch.int32, device=dev).reshape(bsz, 256)
    sb = kway_schedule(lens)
    kw = dict(lens=lens, key_dtype=torch.bfloat16, descending=True)
    ms_b = graph_ms(lambda: kway_merge(xb, sb, (ids,), **kw), 20)
    plain_b = graph_ms(lambda: kway_merge_plain(xb, sb, (ids,), **kw), 2)

    def lib_b():
        v, i = torch.sort(xb, dim=-1, descending=True, stable=True)
        return v, torch.gather(ids, 1, i)

    entries.append(("4 x 64 bf16 desc + int32 ids (65536 rows)", ms_b, plain_b,
                    graph_ms(lib_b, 20), "torch.sort + gather", bsz * 256 * (2 + 4) * 2,
                    float(bsz * 256 * lg(4))))
    # eight 128-lists of int32 keys: merge_k at 16,384 rows, and the 65,536
    # segment rows of chunked_merge_k of 8 x 2^20 (the same device; its
    # plain version is timed at the first shape only)
    s8 = kway_schedule((128,) * 8)
    plain_8 = None
    for bsz in (16_384, 65_536):
        x8 = torch.cat(sorted_lists(bsz, (128,) * 8, torch.int32, dev, 53), dim=1)
        ms_8 = graph_ms(lambda: kway_merge(x8, s8), 20)
        if plain_8 is None:
            plain_8 = graph_ms(lambda: kway_merge_plain(x8, s8), 1)
        name = ("8 x 128 int32 (16384 rows)" if bsz == 16_384 else
                "8 x 128 int32 (65536 rows: the chunked_merge_k segments)")
        entries.append((name, ms_8, plain_8 if bsz == 16_384 else float("nan"),
                        graph_ms(lambda: torch.sort(x8, dim=-1), 20), "torch.sort",
                        bsz * 1024 * 4 * 2, float(bsz * 1024 * lg(8))))
        del x8
    name, ms, plain, lib, _, nbytes, comps = entries[0]
    b_ms, b_by = bound_ms(nbytes, comps, ops_per_s)
    rows.append(dict(name="kway_merge", route="cuda", source=KWAY_SOURCE,
                     replaces="src/repro/kernels/kway.py:70", launches=launches["kway_merge"],
                     max_abs_err=err["kway_merge"], ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    for name, ms, plain, lib, lib_name, nbytes, comps in entries:
        b_ms, b_by = bound_ms(nbytes, comps, ops_per_s)
        log(f"  kway_merge {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
            f"{plain:.4f} ms, {lib_name} {lib:.4f} ms; {card}")
    return rows


def profile_serve(dev, params, cfg, card) -> None:
    """Where a decode step's time goes: torch.profiler over four sampled
    decode steps of the main path (B=4 after a 128-token prompt), device
    time by kernel, against the host's wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache, prefill
    from repro_torch.serving import make_serve_step

    bsz, plen, steps = 4, 128, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    step = make_serve_step(cfg, top_k=64, temperature=0.8)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        cache = init_cache(cfg, bsz, plen + steps + 1, dev)
        logits, cache = prefill(params, {"tokens": torch.from_numpy(toks).to(dev)}, cache, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def pos(i):
            return torch.full((bsz, 1), plen + i, dtype=torch.int32, device=dev)

        tok, cache = step(params, tok, cache, pos(0), gen)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, steps + 1):
                tok, cache = step(params, tok, cache, pos(i), gen)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator's row repeats the time of its kernels
    dev_us, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        dev_us[ev.key] = dev_us.get(ev.key, 0) + t
        launches += ev.count
    total = sum(dev_us.values())
    if total <= 0:
        log("  profiler saw no device time")
        return
    topk_us = sum(t for n, t in dev_us.items() if "vocab_" in n or "router_topk" in n)
    log(f"  decode step profile (B={bsz}, {steps} steps, profiler on): per step "
        f"{launches / steps:.0f} kernels, device busy {total / steps / 1e3:.3f} ms of "
        f"{wall_us / steps / 1e3:.3f} ms wall (idle share {1 - total / wall_us:.3f}); "
        f"top-k kernels {topk_us / steps / 1e3:.4f} ms per step; {card}")
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t / steps / 1e3:8.4f} ms/step  {name[:90]}")


def main() -> int:
    import torch

    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: src/repro_torch is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import segmented as SK
    from repro_torch.kernels import topk as K
    from repro_torch.networks import capable_families

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    ops_per_s = int32_ops_per_s()
    log("phase 1: environment and build")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} card(s); {card}")
    log(f"  peak int32 rate {ops_per_s:.4e}/s ({INT32_PER_CLOCK_PER_SM} lanes x "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x top SM clock); "
        f"memory {HBM_BYTES_PER_S:.3e} B/s")
    build.build_all()
    log(f"  nvcc built {build.BUILD_INFO['built']} in {build.BUILD_INFO['seconds']:.1f} s")
    for src in ("topk", "segmented", "merge", "sort", "grid_merge", "kway"):
        for line in str(build.BUILD_INFO.get(f"ptxas_{src}", "")).splitlines():
            if "registers" in line or "spill" in line:
                log(f"   {src}: " + line.strip())

    log("phase 2: kernels against their plain versions")
    err = phase_kernels(dev, K, topk_block)
    err.update(phase_seg_kernels(dev, SK, capable_families))
    err.update(phase_merge_sort_kernels(dev, capable_families))
    err.update(phase_kway_kernels(dev))
    for name, e in phase_rawfloat_kernels(dev).items():
        err[name] = max(err[name], e)

    log("phase 3a: serve Qwen3-8B at full width")
    params, logits, smoke_logits, launches = phase_serve(dev, K)
    log("phase 3b: the request scheduler at full width")
    runs = [launches, phase_engine(dev, K, params, card)]
    phase_invariance(dev, params, get_config("qwen3-8b"), card)
    log("phase 3c: --engine at smoke width")
    got, tick_rows, tick_k = phase_engine_smoke(dev, K, SK, 4, 32, 16, 64, 0.8)
    runs.append(got)
    log("phase 3d: the segmented library calls")
    runs.append(phase_seg_library(dev, K, SK))
    log("phase 3e: the library's merge and sort")
    runs.append(phase_library_merge_sort(dev))
    log("phase 3f: the k-way merge and the median")
    runs.append(phase_library_kway(dev))
    launches = {n: sum(r[n] for r in runs) for n in K.LAUNCHES}
    log(f"  launches over all the main paths: {launches}")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")

    log("phase 4: times")
    rows = phase_times(dev, K, logits, smoke_logits, launches, err, card, ops_per_s)
    rows += phase_seg_times(dev, SK, tick_rows, tick_k, launches, err, card, ops_per_s)
    rows += phase_merge_sort_times(dev, launches, err, card, ops_per_s)
    rows += phase_kway_times(dev, launches, err, card, ops_per_s)
    profile_serve(dev, params, get_config("qwen3-8b"), card)
    decode_tile_cost(dev, params, get_config("qwen3-8b"), card)
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
