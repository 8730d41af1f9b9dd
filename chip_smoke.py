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
   rows (several CTAs a row); the row-merge executor of the 2-way merge's
   shared-memory rows and of the class merge (loms, s2ms) at the plan's
   threads a row and at 4, 8, 32, 64 and 256 (128 too for the 2-way
   merge), at C = 1, 2, 3, 4, 8 and 16, at phase 3d's classes, the 3e
   spill's, (256, 512 + 512) and (64, 1024 + 1024), with int32 keys that
   tie the class merge's sentinel, full and ragged rows, each call one
   launch; the router top-k (row 3) at T = 1, 4, 8 and 4096 in bf16, f32
   and f16, at list counts that are not powers of two (5, 6, 20) and a
   block of 15, and vocab phase 1 (row 4) called
   directly at blocks of 256, 1024 and 100, each call one launch; the
   vocab merge tree (row 5) at B = 1, 4
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
   and NaN; and rows 3-7 under ``nan_policy="unsafe"`` (-0.0 given
   +0.0's key: ``zero_ties``) on rows that are mostly zeros of both
   signs;
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
      merge a level, 7), and ``chunked_merge(mode="loop")`` of (8, 2^16 +
      2^16) f32 at the planner's tile (one 2-way merge a tile, 256); each
      checked bit-equal to the CPU's plain versions, the loop to
      ``mode="grid"``, or for the largest values-only rows to torch.sort
      of the keys, decoded;
   f. the k-way merge and the median at their users' sizes (kernel row
      8): the paper's 3 x 7 device (``merge_k`` and ``median_of_lists``)
      over 1,048,576 rows, four vocab shards' kept top-64 lists merged
      descending with their token ids (65,536 rows, bf16), 8 x 128 int32
      over 16,384 rows (the six-stage device at 1,024), (100, 50, 25)
      f32 over 65,536 rows, the median of 5 x 7 over 1,048,576 rows, and
      ``chunked_merge_k`` of 8 runs of 2^20 (an external sort's merge
      phase: 65,536 segment rows in one launch); each checked bit-equal
      to the plain version run in chunks, or to torch.sort of the keys;
   g. the schedule executor and the backends (routes with no kernel of
      their own, and the backends' explicit asks): qwen3-moe-30b-a3b's
      router, ``topk(backend="schedule", block=32)`` of (4096, 128) f32
      logits, indices bit-equal to the CPU's and values to torch.topk;
      its expert grouping, the schedule sort of 32,768 unique keys
      ``expert * n + arrival`` with an iota payload, bit-equal to a
      stable torch.sort; ``sort(stable=True)`` of (16,384, 1024) bf16
      with an int32 payload (auto: the executor), bit-equal to a stable
      torch.sort of the keys; the exact nucleus ``sample_topp(k_max=None)``
      on phase 3a's (4, 151,936) logits (its ranking equal to torch.sort
      of the keys and a permutation, each token inside its nucleus, the
      peak memory logged); ``merge`` of 32 + 32 over 65,536 rows with
      ``backend="cuda" / "schedule" / "streaming" / "lax"`` (values
      bit-equal; cuda and schedule also one permutation, the keys being
      distinct); the ragged 7 + 5 merge, bit-equal to the CPU; ``topk``
      at the vocab width with ``axis=0``, ``payload=``,
      ``with_indices=False``, int32, uint32 and int16 keys (the vocab
      kernels, rows 4 and 5: bit-equal to their plain version on the CPU)
      and ``descending=False``; ``autotune_merge2`` /
      ``autotune_sort`` / ``autotune_topk`` at phase 3e's shapes into a
      temporary cache, then the auto call at each shape bit-equal to the
      winner's plain version; the calls without a kernel timed beside one
      torch.sort / torch.topk (the "routes without a kernel" line); then
      Qwen3-8B's decode profile (torch.profiler) and the cost of the
      padded decode rows, the last use of its weights;
   h. qwen3-moe-30b-a3b at its published width and depth (30.53 B
      parameters, random bf16 weights from seed 0, 61 GB: the Qwen3-8B
      weights are freed first) through ``generate`` on 3a's prompts:
      sampled and ragged (rows 4 and 5 a token), greedy (no launch),
      greedy with ``dispatch="sorted"`` (row 6 once a MoE layer a decode
      step; its tokens, prefill and first decode logits bit-equal to the
      scatter run's), a decode step at B = 3 and B = 4 from one cache
      (rows 0-2 bit-equal), and the decode profile with the router's
      executor calls and the expert products as profiler ranges, beside
      the step's weight-read floor;
   t. (inside 3h's window, on its weights) MoE through the request
      scheduler at full width: (a) four greedy 128-token requests at tick
      0 on four slots (``max_prefill_batch`` 4, pages of 16, 9 a slot),
      the engine's tokens bit-equal to greedy ``generate`` on the same
      (4, 128) batch with ``lengths`` and ``cache_len`` 144 (the same
      prefill batch and decode rows); (b) 3b's six staggered requests on
      four slots at ``max_prefill_batch`` 2: every request DONE, nothing
      left allocated, a second drain bit-equal, the per-tick decode walls
      and tokens/s; each drain's launches (rows 4 and 5 for the sampled
      first tokens and the sampling ticks; the router runs on the
      schedule executor) against their expected counts;
   v. (inside 3h's window, after 3t, on its weights; ``phase_switches``)
      the escape hatches and the family registry: with the fused rungs
      off, the sampler's top-k on the unfused rung (rows 4 and 5, indices
      bit-equal to the fused call's), a sort and a merge with a payload on
      the executor (no launch; bit-equal to the CPU's), a values-only
      merge still on row 1; with the segmented switch off, 3d's segment
      sort and top-k on the per-segment plain version (no class launch)
      and a prefill and four greedy decode steps of the sorted dispatch
      with no class sort, logits and tokens bit-equal to the switch on;
      ``register_family``: loms's programs under a new name on rows 2 and
      1, then bitonic's under the same name, each bit-equal to the
      family's own; the phase's seconds (at most 30);
   i. deepseek-v2-lite-16b (MLA) at its published width and depth (15.71
      B parameters, 31.4 GB of random bf16 weights from seed 0, after
      3h's are freed), the runs and checks of 3h (rows 4 and 5 a sampled
      token, row 6 once a MoE layer a decode step with the sorted
      dispatch, B = 3 against B = 4), the latent cache (576 elements a
      token a layer) and its bytes, the absorbed decode against a prefill
      of prompt + token on the first layer in float32 (within
      ``MLA_ERR_FACTOR`` times the same comparison on Qwen3-8B's GQA
      layer, made before its weights are freed), and the decode profile
      with the attention as a range too;
   j. mamba2-780m (the SSM family: 48 Mamba2 layers, d_model 1536,
      d_state 128, vocab 50,280, tied; 0.78 B parameters) at its published
      width and depth after 3i's weights are freed, through ``generate`` on
      3a's prompts: sampled (rows 4 and 5 a token), greedy (no launch),
      ragged (refused); a decode step at B = 3 and B = 4 from one cache
      (rows 0-2 bit-equal); the recurrent decode against the chunked dual
      form with the inter-chunk carry on the first layer in float32 (128
      teacher-forced decode steps after a 128-token prefill against one
      256-token prefill, within ``SSM_ERR_FACTOR`` times the GQA decode's
      error); the smoke config in float32 on the card against the CPU;
      the SSM state's bytes and the decode profile with the mixer as a
      range, beside the step's floor (the weights and the state);
   k. zamba2-2.7b (the hybrid: 54 Mamba2 layers of d_model 2560 and one
      shared attention + MLP block after every 6; 2.42 B parameters, vocab
      32,000) after 3j's weights are freed: 3j's runs and checks, the
      recurrent check also on the shared block, and its attention as a
      profiler range too;
   l. internvl2-26b (the vlm frontend: 48 layers of d_model 6144, 48/8
      heads, d_ff 16,384, vocab 92,553; 256 patches of 3200 a row through
      ``patch_proj`` in front of the text; about 19.9 B parameters, 39.8
      GB) at published width and depth after 3k's weights are freed,
      through ``generate`` on 3a's prompts with the launcher's patches:
      sampled (rows 4 and 5 a token at the odd vocab 92,553), greedy,
      ragged (refused); the first step's candidates and token against the
      plain top-k; B = 3 against B = 4 at the position after the patches;
      the smoke config in float32 on the card against the CPU; the
      prefill of 4 x 384 positions profiled beside its tensor-core floor
      and the decode profile beside the step's weight-read floor;
   m. hubert-xlarge (the audio encoder: 48 non-causal layers of d_model
      1280, gelu MLP, 504 classes; 0.945 B parameters) at published width
      and depth: ``forward`` and ``loss_fn`` (with and without a mask) on
      4 x 1,000 frames of 512, logits finite; the first layer in float32
      against bf16; the smoke config on the card against the CPU; the
      forward profiled beside its floor; ``init_cache``, ``generate`` and
      the launcher refuse it. No LOMS kernel runs (its counts stay 0);
   n. the telemetry layer (``repro_torch.obs``) on: the smoke launcher,
      the ``--engine`` drain, ``segment_topk`` at 3d's re-rank shape, 3e's
      sort spill and ``autotune_topk`` into a temporary cache; the spans
      they must record, ``serve.tokens``, ``sched.completed``,
      ``segmented.class_launches`` and ``grid_merge.launches`` against
      the launch counts; a valid Chrome trace, a Prometheus file and a
      recorder dump holding the tournament; a profiled ``generate`` with
      the ``serve.decode`` range; then obs off: an empty snapshot and the
      same launches and results. Every other phase runs with obs off;
   o. the three dense configs that 3a's recipe had not served, each at
      its published width and depth with random bf16 weights from seed 0
      after the previous model's weights are freed: qwen1.5-32b (35.195 B
      parameters, 70.39 GB, 40 KV heads and QKV biases), deepseek-coder-33b
      (33.342 B, 66.68 GB) and chatglm3-6b (6.243 B, half-width RoPE),
      each through ``generate`` on 3a's prompts sampled (rows 4 and 5 a
      token at vocabularies 152,064, 32,256 and 65,024) and greedy; the
      first step's candidates against the plain top-k; B = 3 against B =
      4 (rows 0-2 bit-equal); parameters, bytes, KV cache a token, peak
      memory and the weight-read floor beside the decode profile;
   p. the resilience layer (``repro_torch.resilience``) at full width on
      chatglm3-6b, obs on: 3b's six staggered requests through
      ``ScheduledEngine`` with ``sched.*`` failpoints armed once each, at
      a seeded ``p:0.2:7``, and a persistent ``sched.decode`` (streams
      bit-equal to the fault-free drain, ``sched.retries`` counting the
      fires, nothing leaked); ``generate`` with the fused top-k failing
      (the unfused rung answers, three fallbacks open its breaker) and with
      every kernel top-k failing (the plan reroutes to the schedule
      executor, ``source="breaker"``); 3e's merge and sort with the kernel
      seams failing (the values the healthy call's, the tie order the
      answering rung's) and armed ``off`` (the same results and launches);
      a real (not injected) error of the fused sort on the card
      propagating; the tie-order table of ``tests/test_torch_resilience.py``
      on the card against the CPU. Its launches, made with failpoints
      armed, are logged apart and not counted on the main paths;
   q. the trainer (``repro_torch.runtime``, ``optim``, ``data``,
      ``checkpoint``) at full width, float32 master weights. First the
      gradients on the card against the CPU: ``loss_fn``'s at smoke width
      in float32 (qwen3-8b, and qwen3-moe-30b-a3b with its router), and
      ``topk``'s through the fused rung at (4, 151936) and (4096, 128),
      bit-equal (their launches logged apart, not counted on the main
      paths). Then Qwen3-8B cut to 4 layers, six steps of the trainer's
      step (batch 4 x 512, every update lowering its own batch's loss):
      step times (CUDA events, wall, and AdamW's share), tokens/s and peak
      memory beside the step's floor, and ``remat`` none / full / dots
      from the sixth step's state (the loss bit-equal, the grad norm
      within 1e-3, the memory held after the forward full < dots < none).
      Then Qwen3-8B cut to 1 layer through ``train_with_retries`` (6
      steps, a checkpoint every 3 in a temporary directory, a fault at
      step 4: fired once, step 3's loss after the resume bit-equal, the
      resume's restore in place within one leaf of the resident state,
      step 6's checkpoint restored bit-equal): each save's and the
      restore's seconds, bytes and memory. Then qwen3-moe-30b-a3b cut to
      2 layers, three steps (a finite nonzero router gradient each, the
      router's forward and backward as profiler ranges). No LOMS kernel
      runs on the training paths (their counts stay 0); the storage
      bytes the whole script wrote are logged at its end;
   r. distribution (``repro_torch.parallel``, ``par=``) on NCCL, one
      spawned rank a card (``phase_dist``): the library's sort, merges,
      median and top-k, the sampler, qwen3-moe-30b-a3b's MoE layer in
      both expert-parallel modes, ``pipeline_apply`` and
      ``compressed_psum``, each call's launches, device time, exchange
      bytes and result against the single-device call on the same card.
      At one card the TP axis is 1, so every ``par`` call plans the
      single-device route and the distributed functions are called
      directly; on four cards the sharded routes run;
   s. sharded parameters through the model (``phase_sharded``; the
      model's ``par=``, on NCCL, one spawned rank a card): at one card a
      (1, 1) mesh, Qwen3-8B's ``generate(par=par)`` at full width and
      depth bit-equal to ``generate()`` (tokens, the first step's logits,
      rows 4 and 5's launches) and one step of 3q's 4-layer trainer with
      ``par`` bit-equal to one without; on four cards TP serving, FSDP
      training at full depth and the FSDP and FSDP + TP steps against the
      one-card step;
   u. the four examples (``examples/torch_*.py``) through their
      ``main`` with ``--device cuda``: the quickstart's and the stream
      walkthrough's checks (merges and sorts equal to ``torch.sort``'s,
      the median, ``tree_topk``'s values equal to ``torch.topk``'s, the
      autotune cache hit in a temporary file), ``serve_topk``'s tokens in
      the vocabulary, ``train_tiny_moe`` at 40 steps with finite losses
      and its checkpoint in a temporary directory deleted after; each
      one's wall time;
4. times (CUDA events) of every kernel beside its bound, its plain
   version and one PyTorch call on the same input (``torch.topk``,
   ``torch.sort``, ``torch.kthvalue``: a yardstick the port never calls),
   row 8 also at 8 x 128 int32 and at the chunked_merge_k segments, row
   9 also the whole values-only sort spill of phase 3e, row 1 also in
   bf16, int32 and at 64 + 8, row 7 also at phase 3d's seven classes, the
   3e spill's and the widest; rows 1 and 3-7 also as a graph of 20 calls
   over the calls (``amortised_ms`` in the kernels line), beside the
   floor (one one-element ``torch.add``) timed both ways.

Every phase runs with the degradation ladder on and no failpoint armed
(the script refuses to start with ``REPRO_FAILPOINTS`` set or
``REPRO_RESILIENCE=0``) and ends with an empty breaker registry. On the
card only an injected fault degrades a call (a kernel's real error
raises), and a rung that failed and was answered by a slower one would
have made a breaker, so no fallback hides a kernel. Phase 3p arms faults
and resets the breakers and failpoints before it ends.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Needs one card.
"""
from __future__ import annotations

import dataclasses
import gc
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


#: calls captured in one CUDA graph for an amortised time
AMORTISED_CALLS = 20


def graph_ms(fn, iters: int, calls: int = 1) -> float:
    """Device time of one call: ``calls`` calls of ``fn`` captured in one
    CUDA graph, replayed ``iters`` times between two events, over the
    calls; so the host's launch cost (Python, ctypes, allocation) stays
    out of the window, and with ``calls`` > 1 the cost of starting a
    graph replay is shared by the calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters) / calls


def topk_comparisons(n: int, k: int) -> int:
    """The least comparisons any method needs to find the top k of n and
    put them in order: log2 of the n! / (n - k)! ordered choices, rounded
    up (a full sort at k = n)."""
    import math

    k = min(k, n)
    return math.ceil((math.lgamma(n + 1) - math.lgamma(n - k + 1)) / math.log(2))


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


class row_threads:
    """Force the threads a row of the row-merge executor (rows 1 and 7)."""

    def __init__(self, threads: int):
        self.threads = threads

    def __enter__(self):
        from repro_torch.kernels import launch

        self.old, launch.MERGE_ROW_THREADS = launch.MERGE_ROW_THREADS, self.threads

    def __exit__(self, *exc):
        from repro_torch.kernels import launch

        launch.MERGE_ROW_THREADS = self.old


#: threads a row of the row-merge executor in phase 2 (0: the plan's)
ROW_THREADS = (0, 4, 8, 32, 64, 256)


def one_launch(name, fn):
    """fn() with the launch counts zeroed before it: exactly one launch,
    of kernel ``name``."""
    from repro_torch.kernels import topk as K

    K.reset_launch_counts()
    got = fn()
    if K.LAUNCHES[name] != 1 or sum(K.LAUNCHES.values()) != 1:
        raise AssertionError(f"{name}: launches {dict(K.LAUNCHES)} in one call, not one")
    return got


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


#: the models phase 3 serves at full width with the vocab kernels (3a-3b, 3h-3k, 3o)
SERVED_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "mamba2-780m",
                "zamba2-2.7b", "qwen1.5-32b", "chatglm3-6b", "deepseek-coder-33b")


def phase_kernels(dev, K, topk_block) -> dict:
    """Phase 2: every kernel bit-equal to its plain version on the card."""
    import torch

    from repro_torch.configs import get_config

    err = {"router_topk": 0.0, "vocab_phase1": 0.0, "vocab_merge_level": 0.0}
    # the sampler's shape of every model phase 3 serves (rows 4 and 5 at B = 4, k 64)
    served_vocabs = sorted({get_config(a).vocab_size for a in SERVED_ARCHS})

    def one_launch(name, fn):
        K.reset_launch_counts()
        out = fn()
        if K.LAUNCHES[name] != 1:
            raise AssertionError(f"{name}: {K.LAUNCHES[name]} launches in one call, not 1")
        return out

    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        # the MoE-router shapes, the smoke-width serve's (4, 256) k=64 and
        # one row of it, (8, 512); list counts that are not powers of two
        # (5, 6 at block 64, 20 at block 15), k not a power of two
        for t, e, k, blk in ((4096, 256, 16, None), (4096, 128, 8, None), (4, 256, 64, None),
                             (1, 256, 64, None), (8, 512, 64, None), (5, 320, 40, 64),
                             (6, 384, 5, 64), (7, 300, 8, 15)):
            x = special_logits(t, e, dtype, dev, seed=e + k)
            blk = blk or topk_block(e, k)
            got = one_launch("router_topk", lambda: K.router_topk(x, k, block=blk))
            err["router_topk"] = max(err["router_topk"], require_equal(
                f"router T={t} E={e} k={k} {dtype}", got, K.router_topk_plain(x, k, blk)))
            log(f"  router_topk T={t} E={e} k={k} block={blk} {dtype}: bit-equal, one launch")
        # phase 1 called directly at the shared-memory widths (256, 1024), a
        # block that is not a power of two and k not a power of two
        for b, v, k, blk in ((2, 20_000, 64, 256), (2, 20_000, 64, 1024), (3, 3000, 8, 100),
                             (2, 5000, 40, 64)):
            x = special_logits(b, v, dtype, dev, seed=v + blk)
            got = one_launch("vocab_phase1", lambda: K.vocab_phase1(x, k, blk))
            err["vocab_phase1"] = max(err["vocab_phase1"], require_equal(
                f"phase1 B={b} V={v} k={k} block={blk} {dtype}", got,
                K.vocab_phase1_plain(x, k, blk)))
            log(f"  vocab_phase1 B={b} V={v} k={k} block={blk} {dtype}: bit-equal, one launch")
    for dtype in (torch.bfloat16, torch.float32):
        # the serving shapes (k 64, 16, 256 at their planner's block), B = 1, 4
        # and 8, k 64 at block 16 (lists that grow 16 -> 32 -> 64), and a
        # vocab of 3000 (one launch); the tree at its plan and at forced
        # subtrees of 2, 4 and 32 lists
        for b, v, k, blk in ((8, 151_936, 64, None), (8, 151_936, 16, None),
                             (8, 151_936, 256, None), (1, 151_936, 64, None),
                             *((4, sv, 64, None) for sv in served_vocabs),
                             (4, 151_936, 64, 16), (3, 3000, 64, 16)):
            x = special_logits(b, v, dtype, dev, seed=k + b)
            blk = blk or topk_block(v, k)
            keys, idx = one_launch("vocab_phase1", lambda: K.vocab_phase1(x, k, blk))
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
    # raw int32 keys (the reference's integer mode): INT32_MIN ties the pads
    for t, e, k, blk in ((4096, 128, 8, None), (4, 256, 64, None), (8, 48, 40, 16),
                         (4, 512, 300, 256)):
        x = int32_rows(t, e, dev, seed=e + k)
        blk = blk or topk_block(e, k)
        got = one_launch("router_topk", lambda: K.router_topk(x, k, block=blk))
        err["router_topk"] = max(err["router_topk"], require_equal(
            f"router int32 T={t} E={e} k={k}", got, K.router_topk_plain(x, k, blk)))
    for b, v, k, blk in (*((4, sv, 64, None) for sv in served_vocabs), (8, 530, 530, 16),
                         (4, 700, 1000, 128), (2, 20_000, 64, 1024)):
        x = int32_rows(b, v, dev, seed=v + k)
        blk = blk or topk_block(v, k)
        keys, idx = one_launch("vocab_phase1", lambda: K.vocab_phase1(x, k, blk))
        pk, pi = K.vocab_phase1_plain(x, k, blk)
        err["vocab_phase1"] = max(err["vocab_phase1"], require_equal(
            f"phase1 int32 B={b} V={v} k={k}", (keys, idx), (pk, pi)))
        if keys.shape[1] > 1:
            err["vocab_merge_level"] = max(err["vocab_merge_level"], require_equal(
                f"merge tree int32 B={b} V={v} k={k}", K.vocab_merge_tree(keys, idx, k),
                K.vocab_merge_tree_plain(pk, pi, k)))
    log("  int32 keys (INT32_MIN tying the pads): router T=4096/4/8/4 (blocks 16-256), "
        f"phase 1 and the merge tree at (4, {served_vocabs}) k 64, (8, 530) k 530, "
        "(4, 700) k 1000, "
        "(2, 20,000) block 1024: bit-equal, one launch a call")
    torch.cuda.synchronize()
    return err


def int32_rows(rows, n, device, seed):
    """int32 rows heavy in INT32_MIN (which ties the top-k pads), with
    INT32_MAX and ties."""
    import numpy as np
    import torch

    vals = np.array([-2 ** 31, -2 ** 31, -2 ** 31 + 1, -5, 0, 3, 3, 2 ** 31 - 1], np.int64)
    x = np.random.default_rng(seed).choice(vals, (rows, n)).astype(np.int32)
    return torch.from_numpy(x).to(device)


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
    # the row-merge executor (loms, s2ms) at phase 3d's classes, the 3e
    # spill's, the table's and the widest, at every threads a row, one launch
    # a call: int32 rows whose keys tie the sentinel (INT32_MAX ascending,
    # INT32_MIN descending), all rows full and lengths 0..W, k_out below
    # and at the width, two payload lanes
    for s_, wa, wb, dt in ((13, 64, 1, torch.float32), (15, 64, 2, torch.int32),
                           (25, 64, 4, torch.float16), (75, 64, 8, torch.bfloat16),
                           (136, 64, 16, torch.float32), (292, 64, 32, torch.int32),
                           (500, 64, 64, torch.float32), (256, 512, 512, torch.int32),
                           (64, 1024, 1024, torch.bfloat16)):
        for full in (False, True):
            la = seg_lens(s_, wa, dev, seed=wa + s_, full=full)
            lb = seg_lens(s_, wb, dev, seed=wb + s_, full=full)
            pay = (torch.arange(s_ * (wa + wb) * 2, dtype=torch.int32, device=dev)
                   .reshape(s_, wa + wb, 2), seg_tile(s_, wa + wb, torch.bfloat16, dev, seed=3))
            for flip in (False, True):
                a = SK.segment_class_sort_plain(seg_tile(s_, wa, dt, dev, seed=5), la,
                                                flip=flip)[0]
                b = SK.segment_class_sort_plain(seg_tile(s_, wb, dt, dev, seed=6), lb,
                                                flip=flip)[0]
                for fam in ("loms", "s2ms"):
                    for k_out in (wa + wb, max(1, (wa + wb) // 3)):
                        kw = dict(k_out=k_out, network=fam, flip=flip, want_perm=True)
                        want = SK.segment_class_merge_plain(a, b, la, lb, pay, **kw)
                        for threads in ROW_THREADS:
                            with row_threads(threads):
                                got = one_launch("seg_merge", lambda: SK.segment_class_merge(
                                    a, b, la, lb, pay, **kw))
                            err["seg_merge"] = max(err["seg_merge"], require_same_class(
                                f"class merge rows ({s_}, {wa} + {wb}) {dt} {fam} flip={flip} "
                                f"full={full} k_out={k_out} threads={threads}", got, want))
        log(f"  seg_merge rows ({s_}, {wa} + {wb}) {dt}: loms/s2ms x both orders x full and "
            f"ragged x k_out {wa + wb}, {max(1, (wa + wb) // 3)} x threads a row {ROW_THREADS}: "
            "bit-equal, one launch a call")
    torch.cuda.synchronize()
    return err


def signed_zero_rows(rows, n, dtype, device, seed, sort=False):
    """Finite rows that are mostly zeros of both signs (what
    ``nan_policy="unsafe"`` admits); ``sort``: ascending as raw floats (a
    stable sort keeps each zero where it was)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.5, -0.5, -0.0, 0.0, 0.5, 1.5], np.float32), size=(rows, n),
                   p=[0.1, 0.15, 0.3, 0.3, 0.1, 0.05])
    if sort:
        x = np.sort(x, -1, kind="stable")
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def phase_signed_zero_kernels(dev, K, SK, topk_block, capable_families) -> dict:
    """Phase 2, ``nan_policy="unsafe"``: rows 3-7 with -0.0 given +0.0's key
    (``zero_ties``) on rows that are mostly zeros of both signs, bit-equal
    to their plain versions (values as bits, so every zero's sign),
    indices, permutations and payload lanes; one launch a call."""
    import torch

    err = {n: 0.0 for n in ("router_topk", "vocab_phase1", "vocab_merge_level",
                            "seg_sort", "seg_merge")}
    for dtype in (torch.bfloat16, torch.float32):
        for t, e, k, blk in ((4096, 128, 8, 32), (4, 256, 64, None), (7, 300, 8, 15)):
            x = signed_zero_rows(t, e, dtype, dev, seed=e + k)
            blk = blk or topk_block(e, k)
            got = one_launch("router_topk", lambda: K.router_topk(x, k, block=blk,
                                                                  zero_ties=True))
            err["router_topk"] = max(err["router_topk"], require_equal(
                f"signed zeros: router T={t} E={e} k={k} {dtype}", got,
                K.router_topk_plain(x, k, blk, zero_ties=True)))
        for b, v, k, blk in ((4, 151_936, 64, None), (2, 20_000, 64, 1024)):
            x = signed_zero_rows(b, v, dtype, dev, seed=v + k)
            blk = blk or topk_block(v, k)
            keys, idx = one_launch("vocab_phase1", lambda: K.vocab_phase1(x, k, blk,
                                                                          zero_ties=True))
            pk, pi = K.vocab_phase1_plain(x, k, blk, zero_ties=True)
            err["vocab_phase1"] = max(err["vocab_phase1"], require_equal(
                f"signed zeros: phase 1 B={b} V={v} k={k} {dtype}", (keys, idx), (pk, pi)))
            err["vocab_merge_level"] = max(err["vocab_merge_level"], require_equal(
                f"signed zeros: merge tree B={b} V={v} k={k} {dtype}",
                K.vocab_merge_tree(keys, idx, k, dtype),
                K.vocab_merge_tree_plain(pk, pi, k, dtype)))
        for w in (64, 1024):
            x = signed_zero_rows(64, w, dtype, dev, seed=w)
            lens = seg_lens(64, w, dev, seed=w + 1)
            pay = torch.arange(64 * w, dtype=torch.int32, device=dev).reshape(64, w)
            for flip in (False, True):
                kw = dict(k_out=max(1, w // 3), flip=flip, want_perm=True, zero_ties=True)
                want = plain_in_chunks(lambda r: SK.segment_class_sort_plain(
                    x[r], lens[r], (pay[r],), **kw), 64)
                got = one_launch("seg_sort", lambda: SK.segment_class_sort(x, lens, (pay,),
                                                                           **kw))
                err["seg_sort"] = max(err["seg_sort"], require_same_class(
                    f"signed zeros: class sort W={w} {dtype} flip={flip}", got, want))
        for s_, wa, wb in ((75, 64, 8), (64, 256, 256)):
            la, lb = seg_lens(s_, wa, dev, seed=wa), seg_lens(s_, wb, dev, seed=wb + 1)
            pay = torch.arange(s_ * (wa + wb), dtype=torch.int32,
                               device=dev).reshape(s_, wa + wb)
            for flip in (False, True):
                a = signed_zero_rows(s_, wa, dtype, dev, seed=wa + 2, sort=True)
                b = signed_zero_rows(s_, wb, dtype, dev, seed=wb + 3, sort=True)
                if flip:
                    a, b = a.flip(-1).contiguous(), b.flip(-1).contiguous()
                for fam in capable_families("merge2", (wa, wb)):
                    kw = dict(network=fam, flip=flip, want_perm=True, zero_ties=True)
                    got = one_launch("seg_merge", lambda: SK.segment_class_merge(
                        a, b, la, lb, (pay,), **kw))
                    err["seg_merge"] = max(err["seg_merge"], require_same_class(
                        f"signed zeros: class merge ({s_}, {wa} + {wb}) {dtype} {fam} "
                        f"flip={flip}", got,
                        SK.segment_class_merge_plain(a, b, la, lb, (pay,), **kw)))
        log(f"  signed zeros (nan_policy='unsafe') {dtype}: router T=4096/4/7, phase 1 and "
            "the merge tree at (4, 151,936) and (2, 20,000), the class sort W=64/1024 and "
            "the class merge 64 + 8 and 256 + 256 (every capable family), both orders: "
            "bit-equal, one launch a call")
        # rows whose values all have the sign bit set, at blocks and k where
        # the reference's one-hot permute keeps -0.0 (signed_zero_rule)
        negz = 0
        for t, e, k, blk in ((9, 6, 3, 6), (4096, 16, 3, 4), (9, 24, 1, 3), (9, 8, 4, 4)):
            x = negative_rows(t, e, dtype, dev, seed=e * k)
            got = one_launch("router_topk", lambda: K.router_topk(x, k, block=blk,
                                                                  zero_ties=True))
            err["router_topk"] = max(err["router_topk"], require_equal(
                f"negative zeros: router T={t} E={e} k={k} {dtype}", got,
                K.router_topk_plain(x, k, blk, zero_ties=True)))
            negz += int((torch.signbit(got[0]) & (got[0] == 0)).sum())
        for b, v, k, blk in ((9, 600, 2, 4), (9, 520, 1, 3), (9, 6, 3, 6)):
            x = negative_rows(b, v, dtype, dev, seed=v + k)
            got = K.vocab_topk(x, k, block=blk, zero_ties=True)
            err["vocab_merge_level"] = max(err["vocab_merge_level"], require_equal(
                f"negative zeros: vocab B={b} V={v} k={k} block={blk} {dtype}", got,
                K.vocab_topk_plain(x, k, blk, zero_ties=True)))
            negz += int((torch.signbit(got[0]) & (got[0] == 0)).sum())
        if not negz:
            raise AssertionError("negative zeros: no -0.0 came out where the rule keeps it")
        log(f"  negative zeros {dtype}: router (blocks 6, 4, 3), vocab (blocks 4, 3, one "
            f"block of 6): bit-equal, {negz} zeros kept as -0.0")
    torch.cuda.synchronize()
    return err


def negative_rows(rows, n, dtype, device, seed):
    """Rows of -1.5, -0.5 and -0.0 (every value's sign bit set), every
    third row with +0.0 and 0.5 as well."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.5, -0.5, -0.0], np.float32), size=(rows, n))
    x[::3] = rng.choice(np.array([-1.5, -0.5, -0.0, 0.0, 0.5], np.float32),
                        size=x[::3].shape)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


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
    got, want = dict(K.LAUNCHES), engine_launches(K, eng, levels)
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


def engine_launches(K, eng, levels) -> dict:
    """The launches a drain of ``eng`` must make: one vocab top-k (phase
    1 and its merge-tree levels) for each sampled first token and for
    each decode tick with a sampling slot (the stable top-k of
    ``segment_topk``'s spill)."""
    want = {n: 0 for n in K.LAUNCHES}
    for r in eng.requests.values():
        if not r.params.greedy:
            want["vocab_phase1"] += 1
            want["vocab_merge_level"] += levels(r.params.k)
    for _, _, ks in eng.tick_log:
        if ks:
            want["vocab_phase1"] += 1
            want["vocab_merge_level"] += levels(max(ks))
    return want


def phase_moe_engine(dev, K, params, cfg, card) -> dict:
    """Phase 3t: MoE through ``ScheduledEngine`` at full width, on 3h's
    qwen3-moe-30b-a3b weights. A MoE request's tokens are those of the
    reference engine's batch composition (capacity couples a batch's
    rows), so (a) holds four requests that form one prefill batch and one
    decode batch against ``generate`` on that batch, and (b) drains 3b's
    staggered requests twice, bit for bit, with nothing left allocated."""
    import numpy as np
    import torch

    from repro_torch.api import topk_block
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.scheduler import SamplingParams, ScheduledEngine, SchedulerConfig

    vocab = cfg.vocab_size

    def levels(k):  # merge-tree launches of one vocab top-k call
        return K.vocab_merge_launches(vocab, topk_block(vocab, k), k)

    def drain(sched, reqs):
        eng = ScheduledEngine(params, cfg, sched, device=dev)
        rids = [eng.submit(p, sp, arrival=a) for p, sp, a in reqs]
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = dict(K.LAUNCHES), engine_launches(K, eng, levels)
        if got != want:
            raise AssertionError(f"MoE engine drain: launch counts {got} != {want}")
        drain_invariants(eng, "MoE engine drain")
        states = {rid: r.state.value for rid, r in eng.requests.items()}
        if set(states.values()) != {"done"}:
            raise AssertionError(f"MoE engine drain: requests not all DONE: {states}")
        return eng, [out[r] for r in rids], wall, got

    # (a) one prefill batch of four 128-token prompts, then 4-row decode steps
    new, plen = 16, 128
    tokens = np.random.default_rng(3).integers(0, vocab, (4, plen)).astype(np.int32)
    sched = SchedulerConfig(n_slots=4, max_prefill_batch=4, page_size=16, pages_per_slot=9)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=new)
    eng, got, wall, launches = drain(sched, [(t, greedy, 0) for t in tokens])
    want = generate(params, {"tokens": tokens, "lengths": np.full(4, plen, np.int32)}, cfg,
                    ServeConfig(max_new_tokens=new, temperature=0.0,
                                cache_len=sched.slot_capacity), device=dev)["tokens"]
    if not np.array_equal(np.stack(got), want):
        raise AssertionError(f"MoE engine: tokens {np.stack(got)[:, :6].tolist()} != greedy "
                             f"generate's on the same batch {want[:, :6].tolist()}")
    if [n for _, n, _ in eng.tick_log] != [4] * (new - 1):
        raise AssertionError(f"MoE engine: decode ticks {eng.tick_log}, not 4 rows each")
    log(f"  (a) 4 x {plen} greedy through the engine (one prefill batch, {new - 1} decode "
        f"ticks of 4 rows): bit-equal to generate on the (4, {plen}) batch; {wall:.3f} s "
        f"wall, launches { {n: c for n, c in launches.items() if c} }; {card}")

    # (b) 3b's six staggered requests, prefill batches of at most 2
    plens, arrivals = (128, 77, 128, 33, 100, 5), (0, 0, 1, 2, 4, 6)
    sps = [SamplingParams(k=64, temperature=0.8, seed=11),
           SamplingParams(k=16, temperature=1.0, seed=12),
           SamplingParams(k=256, temperature=0.7, top_p=0.9, seed=13),
           SamplingParams(temperature=0.0, seed=14),
           SamplingParams(k=64, temperature=0.8, top_p=0.95, max_new_tokens=1, seed=15),
           SamplingParams(k=64, temperature=0.8, max_new_tokens=8, seed=16)]
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, vocab, n).astype(np.int32), sp, a)
            for n, sp, a in zip(plens, sps, arrivals)]
    sched = dataclasses.replace(sched, max_prefill_batch=2)
    runs = [drain(sched, reqs) for _ in range(2)]
    for rid, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        if not np.array_equal(a, b):
            raise AssertionError(f"MoE engine: request {rid} differs between two drains: "
                                 f"{a.tolist()} != {b.tolist()}")
    for i, (eng, out, wall, got) in enumerate(runs):
        for n, c in got.items():
            launches[n] += c
        n_tok = sum(len(t) for t in out)
        ticks = np.asarray(eng.tick_s) * 1e3
        log(f"  (b) drain {i + 1}: {len(out)} requests, {n_tok} tokens in {wall:.3f} s wall, "
            f"{eng.t} ticks ({len(ticks)} decode ticks of {[n for _, n, _ in eng.tick_log]} "
            f"rows), {n_tok / wall:.1f} tok/s, decode tick p50 {np.percentile(ticks, 50):.3f} "
            f"ms (max {ticks.max():.3f} ms); launches "
            f"{ {n: c for n, c in got.items() if c} }; {card}")
        log(f"      decode tick walls (ms): {[round(float(t), 3) for t in ticks]}")
    log("  (b) every request DONE, nothing left allocated, the second drain bit-equal")
    return launches


def phase_examples(dev, K, card) -> dict:
    """Phase 3u: the four examples through their ``main`` on the card,
    each with its own checks; their launches summed."""
    import importlib.util
    import math
    import shutil
    import tempfile

    import torch

    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    ckpt = os.path.join(tmp, "ckpt")
    launches = {n: 0 for n in K.LAUNCHES}
    try:
        for name, argv in (
                ("torch_quickstart", []),
                ("torch_serve_topk", []),
                ("torch_stream_merge", ["--cache", os.path.join(tmp, "autotune.json")]),
                ("torch_train_tiny_moe", ["--steps", "40", "--ckpt-dir", ckpt])):
            argv = ["--device", "cuda"] + argv
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = example(name).main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(K.LAUNCHES)
            if "checks" in out and not (out["checks"] and all(out["checks"].values())):
                raise AssertionError(f"{name}: checks failed: {out['checks']}")
            if name == "torch_serve_topk":
                t = out["tokens"]
                if t.shape != (4, 12) or t.min() < 0 or t.max() >= 256:
                    raise AssertionError(f"{name}: tokens of shape {t.shape} outside the vocab")
            if name == "torch_train_tiny_moe":
                if len(out["losses"]) != 40 or not all(map(math.isfinite, out["losses"])):
                    raise AssertionError(f"{name}: losses {out['losses']}")
                if not os.listdir(ckpt):
                    raise AssertionError(f"{name}: no checkpoint written")
            for n, c in got.items():
                launches[n] += c
            log(f"  {name} {' '.join(argv)}: {wall:.2f} s wall, its checks passed, launches "
                f"{ {n: c for n, c in got.items() if c} }; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


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
    amortised = {"router_topk": graph_ms(lambda: K.router_topk(xr, k, block=rb), 20,
                                         AMORTISED_CALLS)}
    plain = graph_ms(lambda: K.router_topk_plain(xr, k, rb), 20)
    lib = graph_ms(lambda: torch.topk(xr, k, dim=-1), 200)
    # the input read once and the (T, k) values and indices written once,
    # or the least comparisons that find and order a row's top k
    b_ms, b_by = bound_ms(bsz * e * xr.element_size() + bsz * k * (xr.element_size() + 4),
                          bsz * topk_comparisons(e, k), ops_per_s)
    rows.append(dict(name="router_topk", route="cuda", source=SOURCE,
                     replaces="src/repro/kernels/topk.py:60",
                     launches=launches["router_topk"], max_abs_err=err["router_topk"],
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    # vocab phase 1: the full-width prefill logits (bf16), k = 64
    vb = topk_block(vocab, k)
    nblk, kk = K.vocab_blocks(vocab, vb), min(k, vb)
    eager["vocab_phase1"] = cuda_ms(lambda: K.vocab_phase1(logits, k, vb), 100)
    ms = graph_ms(lambda: K.vocab_phase1(logits, k, vb), 100)
    amortised["vocab_phase1"] = graph_ms(lambda: K.vocab_phase1(logits, k, vb), 20,
                                         AMORTISED_CALLS)
    plain = graph_ms(lambda: K.vocab_phase1_plain(logits, k, vb), 5)
    padded = torch.cat([logits, logits.new_full((bsz, nblk * vb - vocab), float("-inf"))], 1)
    per_block = padded.view(bsz, nblk, vb)
    lib = graph_ms(lambda: torch.topk(per_block, kk, dim=-1), 100)
    # the input read once, the (B, nblk, kk) int32 keys and indices written
    # once; or the least comparisons that find and order each real
    # block's top kk
    real_blocks = -(-vocab // vb)
    b_ms, b_by = bound_ms(bsz * vocab * logits.element_size() + bsz * nblk * kk * 8,
                          bsz * real_blocks * topk_comparisons(vb, kk), ops_per_s)
    rows.append(dict(name="vocab_phase1", route="cuda", source=SOURCE,
                     replaces="src/repro/kernels/topk.py:122",
                     launches=launches["vocab_phase1"], max_abs_err=err["vocab_phase1"],
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    # the merge tree of one sampled token, on phase 1's lists (its launches)
    keys, idx = K.vocab_phase1(logits, k, vb)
    eager["vocab_merge_level"] = cuda_ms(
        lambda: K.vocab_merge_tree(keys, idx, k, logits.dtype), 100)
    ms = graph_ms(lambda: K.vocab_merge_tree(keys, idx, k, logits.dtype), 100)
    amortised["vocab_merge_level"] = graph_ms(
        lambda: K.vocab_merge_tree(keys, idx, k, logits.dtype), 20, AMORTISED_CALLS)
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
    log("  device time per call (a CUDA graph of one call, replayed; amortised: a graph "
        f"of {AMORTISED_CALLS} calls, over the calls); eager = the same call launched from "
        "Python, host launch cost included")
    y = torch.zeros(1, device=dev)
    log(f"  the floor, one one-element torch.add: {graph_ms(lambda: torch.add(y, 1), 200):.5f} "
        f"ms (amortised {graph_ms(lambda: torch.add(y, 1), 20, AMORTISED_CALLS):.5f} ms); "
        f"{card}")
    for r in rows:
        r["amortised_ms"] = amortised[r["name"]]
        log(f"  {r['name']}: {r['ms']:.5f} ms (amortised {amortised[r['name']]:.5f} ms; bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}; eager {eager[r['name']]:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, torch.topk {r['library_ms']:.5f} ms; {card}")
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
        f"{graph_ms(lambda: K.router_topk(xm, 16, block=rb16), 100):.5f} ms (amortised "
        f"{graph_ms(lambda: K.router_topk(xm, 16, block=rb16), 20, AMORTISED_CALLS):.5f} ms), "
        f"torch.topk {graph_ms(lambda: torch.topk(xm, 16, dim=-1), 100):.5f} ms; {card}")
    return rows


def phase_seg_times(dev, SK, rows, k_out, launches, err, card, ops_per_s) -> list:
    """Phase 4, segmented: the class sort at the engine's decode tile (the
    first tick's logits at smoke width), the class merge at
    ``SEG_MERGE_SHAPES``, each beside its bound and one torch.sort call;
    the plain version at the first shape of each."""
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
    # the class merge at the table's shape (the kernels line's), phase 3d's
    # classes, the 3e spill's class and the widest class
    for i, (name, s_, wa, wb, dt, flip, n_pay, full_a) in enumerate(SEG_MERGE_SHAPES):
        dt = getattr(torch, dt)
        la = (torch.full((s_, 1), wa, dtype=torch.int32, device=dev) if full_a
              else seg_lens(s_, wa, dev, seed=1))
        lb = seg_lens(s_, wb, dev, seed=2)
        a = SK.segment_class_sort_plain(seg_tile(s_, wa, dt, dev, seed=3), la, flip=flip)[0]
        b = SK.segment_class_sort_plain(seg_tile(s_, wb, dt, dev, seed=4), lb, flip=flip)[0]
        ids = torch.arange(s_ * (wa + wb), dtype=torch.int32, device=dev).reshape(s_, wa + wb)
        pay = (ids, ids.long())[:n_pay]
        call = lambda: SK.segment_class_merge(a, b, la, lb, pay, flip=flip,  # noqa: E731
                                              want_perm=True)
        ms, eager = graph_ms(call, 200), cuda_ms(call, 200)
        amortised = graph_ms(call, 20, AMORTISED_CALLS)
        cat = torch.cat([a, b], dim=1)

        def lib_call():
            v, order = torch.sort(cat, dim=-1, descending=flip, stable=True)
            return (v,) + tuple(torch.gather(p, 1, order) for p in pay)

        lib = graph_ms(lib_call, 200)
        isz = a.element_size()
        pay_bytes = sum(p.element_size() for p in pay)
        nbytes = (s_ * (wa + wb) * (isz + pay_bytes) + s_ * 8
                  + s_ * (wa + wb) * (isz + 4 + pay_bytes))
        # a merge needs one comparison per valid output lane
        b_ms, b_by = bound_ms(nbytes, float((la + lb).sum()), ops_per_s)
        pl_txt = ""
        if i == 0:
            pl_ms = graph_ms(lambda: SK.segment_class_merge_plain(a, b, la, lb, pay,
                                                                  want_perm=True), 5)
            out.append(dict(name="seg_merge", route="cuda", source=SEG_SOURCE,
                            replaces="src/repro/kernels/segmented.py:115",
                            launches=launches["seg_merge"], max_abs_err=err["seg_merge"],
                            ms=ms, amortised_ms=amortised, plain_ms=pl_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib))
            pl_txt = f", plain {pl_ms:.4f} ms"
        log(f"  seg_merge {name}: {ms:.5f} ms (amortised {amortised:.5f} ms; bound "
            f"{b_ms:.6f} ms by {b_by}; eager {eager:.4f} ms){pl_txt}, torch.sort of the pair"
            f"{' + gather' if pay else ''} {lib:.5f} ms; {card}")
    return out


#: row 7's shapes in phase 4: the table's (the kernels line's), phase 3d's
#: classes (1,024 kept lists of 64 merged descending with 1..64 new ones,
#: as its bucketer groups them), the 3e spill's class and the widest
#: (name, rows, wa, wb, dtype, descending, payload lanes, a full)
SEG_MERGE_SHAPES = (
    ("(256, 512 + 512) f32 + int32 payload", 256, 512, 512, "float32", False, 1, False),
    ("3d (13, 64 + 1) f32 desc, 2 payload lanes", 13, 64, 1, "float32", True, 2, True),
    ("3d (15, 64 + 2) f32 desc, 2 payload lanes", 15, 64, 2, "float32", True, 2, True),
    ("3d (25, 64 + 4) f32 desc, 2 payload lanes", 25, 64, 4, "float32", True, 2, True),
    ("3d (75, 64 + 8) f32 desc, 2 payload lanes", 75, 64, 8, "float32", True, 2, True),
    ("3d (136, 64 + 16) f32 desc, 2 payload lanes", 136, 64, 16, "float32", True, 2, True),
    ("3d (260, 64 + 32) f32 desc, 2 payload lanes", 260, 64, 32, "float32", True, 2, True),
    ("3d (500, 64 + 64) f32 desc, 2 payload lanes", 500, 64, 64, "float32", True, 2, True),
    ("3e spill (32, 64 + 32) f32, values only", 32, 64, 32, "float32", False, 0, False),
    ("(4096, 1024 + 1024) bf16 + int32 payload", 4096, 1024, 1024, "bfloat16", False, 1,
     False),
)


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


#: row 1's shapes in phases 2 and 4: the three merges of phase 3e (the
#: first is the kernels line's), the other dtypes of the first, and a
#: merge of C = 2 (name, rows, m, n, dtype, descending, int32 ids)
MERGE_SHAPES = (
    ("(65536, 32 + 32) f32", 65_536, 32, 32, "float32", False, False),
    ("(4096, 512 + 512) f32 desc + int32 ids", 4096, 512, 512, "float32", True, True),
    ("(64, 65536 + 32) f32 (tiled)", 64, 65_536, 32, "float32", False, False),
    ("(65536, 32 + 32) bf16", 65_536, 32, 32, "bfloat16", False, False),
    ("(65536, 32 + 32) int32", 65_536, 32, 32, "int32", False, False),
    ("(16384, 64 + 8) f32", 16_384, 64, 8, "float32", False, False),
)


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

    def merge_case(name, a, b, pay, fam, desc, chunk=512, threads=(0,)):
        kw = dict(network=fam, n_cols=pick_merge_cols(a.shape[1], b.shape[1]),
                  key_dtype=key(a.dtype), descending=desc, want_perm=True)
        want = plain_in_chunks(lambda r: loms_merge2_plain(
            a[r], b[r], tuple(p[r] for p in pay), **kw), a.shape[0], chunk)
        for t in threads:
            with row_threads(t):
                got = one_launch("loms_merge2", lambda: loms_merge2(a, b, pay, **kw))
            err["loms_merge2"] = max(err["loms_merge2"], require_same_class(
                f"{name} threads={t}", got, want))

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
    # the row-merge executor of row 1's shared-memory rows at every threads a
    # row: C = 1, 2, 3, 4, 16, every dtype, both orders, one launch a call
    for m, n, fam, cols in ((32, 32, "loms", 4), (64, 8, "loms", 2), (5, 3, "s2ms", 1),
                            (64, 64, "loms", 16), (48, 24, "loms", 3), (512, 512, "loms", 16),
                            (1000, 24, "loms", 8), (64, 1, "loms", 1)):
        for dt in dtypes + (torch.float16,):
            for desc in (False, True):
                a = total_order_sorted(seg_tile(40, m, dt, dev, seed=m + 9), desc)
                b = total_order_sorted(seg_tile(40, n, dt, dev, seed=n + 10), desc)
                pay = lanes(40, m + n, m + 11)
                kw = dict(network=fam, n_cols=cols, key_dtype=key(dt), descending=desc,
                          want_perm=True)
                want = loms_merge2_plain(a, b, pay, **kw)
                for threads in ROW_THREADS + (128,):
                    with row_threads(threads):
                        got = one_launch("loms_merge2", lambda: loms_merge2(a, b, pay, **kw))
                    err["loms_merge2"] = max(err["loms_merge2"], require_same_class(
                        f"merge rows ({m}, {n}) C={cols} {dt} desc={desc} threads={threads}",
                        got, want))
        log(f"  loms_merge2 rows ({m}, {n}) {fam} C={cols}: bf16/f32/int32/f16 x both "
            f"orders x threads a row {ROW_THREADS + (128,)}, payload lanes: bit-equal, one "
            "launch a call")
    # the shapes of phase 3e and of the timing table
    ids = lambda rows, w: (torch.arange(rows * w, dtype=torch.int32,  # noqa: E731
                                        device=dev).reshape(rows, w),)
    for name, rows, m, n, dt, desc, pay in MERGE_SHAPES:
        dt = getattr(torch, dt)
        a = total_order_sorted(seg_tile(rows, m, dt, dev, seed=rows + m), desc)
        b = total_order_sorted(seg_tile(rows, n, dt, dev, seed=rows + n + 1), desc)
        threads = (0,) if m + n > 2048 else ROW_THREADS  # the tiled route has none
        merge_case(f"merge {name}", a, b, ids(rows, m + n) if pay else (), "loms", desc,
                   chunk=8192 if m + n <= 96 else 512, threads=threads)
        log(f"  loms_merge2 {name}: bit-equal at threads a row {threads}, one launch a call")
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
    from repro_torch.streaming.planner import plan_chunked

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
    # the one-launch-a-tile loop: finite rows without -0.0 (its raw-float
    # merges tie -0.0 and +0.0; the grid merge orders keys)
    gen10 = torch.Generator(device=dev).manual_seed(10)
    a10, b10 = (torch.sort(torch.randn((8, 1 << 16), generator=gen10, device=dev))[0]
                for _ in range(2))
    tiles10 = -(-(2 << 16) // plan_chunked(1 << 16, 1 << 16, batch=8).tile)

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
        ("chunked_merge(mode='loop') (8, 2^16) + (8, 2^16) f32 at the planner's tile, "
         "against mode='grid'",
         lambda: repro_torch.chunked_merge(a10, b10, mode="loop"),
         lambda: repro_torch.chunked_merge(a10, b10), one(loms_merge2=tiles10)),
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

    # row 1 at the three merges of 3e and the other shapes of phase 2; the
    # first is the kernels line's
    merges = []
    for name, bsz, m, n, dt, desc, pay in MERGE_SHAPES:
        dt = getattr(torch, dt)
        a = total_order_sorted(seg_tile(bsz, m, dt, dev, seed=m), desc)
        b = total_order_sorted(seg_tile(bsz, n, dt, dev, seed=n), desc)
        lanes = ((torch.arange(bsz * (m + n), dtype=torch.int32, device=dev)
                  .reshape(bsz, m + n),) if pay else ())
        kw = dict(n_cols=pick_merge_cols(m, n), key_dtype=dt if dt.is_floating_point else None,
                  descending=desc)
        ms = graph_ms(lambda: loms_merge2(a, b, lanes, **kw), 50)
        amortised = graph_ms(lambda: loms_merge2(a, b, lanes, **kw), 5, AMORTISED_CALLS)
        plain = graph_ms(lambda: loms_merge2_plain(a, b, lanes, **kw), 3) if not merges else None
        cat = torch.cat([a, b], dim=1)
        if pay:
            def lib_call():
                v, i = torch.sort(cat, dim=-1, descending=desc, stable=True)
                return v, torch.gather(lanes[0], 1, i)
        else:
            def lib_call():
                return torch.sort(cat, dim=-1, descending=desc)
        lib = graph_ms(lib_call, 50)
        nbytes = bsz * (m + n) * (a.element_size() + (4 if pay else 0)) * 2
        merges.append((name, ms, amortised, plain, lib, nbytes, bsz * (m + n), pay))
    name, ms, amortised, plain, lib, nbytes, comps, _ = merges[0]
    row("loms_merge2", MERGE_SOURCE, "src/repro/kernels/loms_merge.py:49", ms, plain,
        nbytes, comps, lib)
    rows[-1]["amortised_ms"] = amortised
    for name, ms, amortised, plain, lib, nbytes, comps, pay in merges:
        b_ms, b_by = bound_ms(nbytes, comps, ops_per_s)
        pl_txt = "" if plain is None else f", plain {plain:.4f} ms"
        log(f"  loms_merge2 {name}: {ms:.5f} ms (amortised {amortised:.5f} ms; bound "
            f"{b_ms:.6f} ms by {b_by}){pl_txt}, torch.sort{' + gather' if pay else ''} "
            f"{lib:.5f} ms; {card}")
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


# ---------------------------------------------------------------------------
# the schedule executor and the backends (no kernel of their own)
# ---------------------------------------------------------------------------


def distinct_sorted_pair(rows, m, n, device, seed):
    """Two ascending f32 runs a row whose m + n values are all distinct,
    so that any merge network gives one permutation."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = np.argsort(rng.random((rows, m + n)), axis=1).astype(np.float32) - (m + n) / 2
    a = torch.sort(torch.from_numpy(x[:, :m]))[0]
    b = torch.sort(torch.from_numpy(x[:, m:]))[0]
    return a.to(device), b.to(device)


def phase_schedule_backends(dev, logits, card) -> tuple:
    """Phase 3g: the schedule executor and the backends at their users'
    sizes, each call with its launch counts zeroed before and read after.
    Returns the launch totals and the timing rows of the calls that run
    no kernel (device ms beside one torch.sort / torch.topk)."""
    import tempfile

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import topk as K
    from repro_torch.kernels.common import decode_key_values, encode_key_values, take_along
    from repro_torch.kernels.loms_merge import loms_merge2
    from repro_torch.kernels.sort import loms_sort
    from repro_torch.serving import sample as S
    from repro_torch.streaming import cache as C
    from repro_torch.streaming import planner as P

    total = {n: 0 for n in K.LAUNCHES}
    rows = []

    def as_bits(t):
        t = t.cpu()
        if t.dtype == torch.uint32:
            return t.view(torch.int32)
        return bits(t) if t.dtype.is_floating_point else t

    def eq(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs, not {len(want)}")
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(as_bits(g),
                                                                           as_bits(w)):
                raise AssertionError(f"{name}: differs")

    def run(name, call, kernels=None):
        """One call with its launch counts; ``kernels``: the kernels it
        must launch (None: none at all, the executor's calls)."""
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: c for n, c in K.LAUNCHES.items() if c}
        for n, c in K.LAUNCHES.items():
            total[n] += c
        if kernels is None and counts:
            raise AssertionError(f"{name}: launched {counts}, the executor launches none")
        if kernels is not None and set(counts) != set(kernels):
            raise AssertionError(f"{name}: launched {counts}, not {kernels}")
        log(f"  {name}: {wall:.1f} ms eager (first call); launches {counts}")
        return got

    def timed(name, call, yardstick, iters=3):
        ms = cuda_ms(call, iters, warm=1)
        ref_ms = cuda_ms(yardstick, iters, warm=1)
        rows.append({"name": name, "ms": round(ms, 4), "torch_ms": round(ref_ms, 4)})
        log(f"  time {name}: {ms:.4f} ms; one torch call {ref_ms:.4f} ms ({card})")

    rng = np.random.default_rng(21)
    # qwen3-moe-30b-a3b's router: 128 experts, top 8, a 4096-token prefill chunk
    lr = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dev)
    rv, ri = run("router topk (4096, 128) k 8 block 32, backend=schedule",
                 lambda: repro_torch.topk(lr, 8, block=32, backend="schedule"))
    cv, ci = repro_torch.topk(lr.cpu(), 8, block=32, backend="schedule")
    eq("router indices vs the CPU", ri, ci)
    eq("router values vs torch.topk", rv, torch.topk(lr, 8)[0])
    timed("router topk (4096, 128) k 8, schedule",
          lambda: repro_torch.topk(lr, 8, block=32, backend="schedule"),
          lambda: torch.topk(lr, 8))
    # its expert grouping: 4096 tokens x 8 unique keys expert * n + arrival
    n = ri.numel()
    keys = (ri.reshape(1, -1) * n + torch.arange(n, device=dev, dtype=torch.int32))
    iota = torch.arange(n, device=dev, dtype=torch.int32).reshape(1, -1)
    gv, gp = run("expert grouping sort (1, 32768) int32 + iota, backend=schedule",
                 lambda: repro_torch.sort(keys, payload=iota, backend="schedule"))
    wv, wp = torch.sort(keys, stable=True)
    eq("grouping vs torch.sort(stable)", (gv, gp), (wv, wp.to(torch.int32)))
    timed("expert grouping sort (1, 32768) int32 + payload, schedule",
          lambda: repro_torch.sort(keys, payload=iota, backend="schedule"),
          lambda: torch.sort(keys, stable=True))
    # a stable sort on the auto route: the executor
    x4 = seg_tile(16_384, 1024, torch.bfloat16, dev, seed=7)
    p4 = torch.arange(16_384 * 1024, dtype=torch.int32, device=dev).reshape(16_384, 1024)
    sv, sp = run("sort (16384, 1024) bf16 stable + int32 payload (auto: schedule)",
                 lambda: repro_torch.sort(x4, stable=True, payload=p4))
    order = torch.sort(encode_key_values(x4), dim=-1, stable=True)[1]
    eq("stable sort vs torch.sort(stable) of the keys",
       (sv, sp), (take_along(x4, 1, order), take_along(p4, 1, order)))
    timed("sort (16384, 1024) bf16 stable + payload, schedule",
          lambda: repro_torch.sort(x4, stable=True, payload=p4),
          lambda: (torch.sort(encode_key_values(x4), dim=-1, stable=True)))
    # the exact nucleus on phase 3a's logits
    v = logits.shape[-1]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(3)
    tok = run(f"sample_topp(k_max=None) {tuple(logits.shape)} {logits.dtype}",
              lambda: S.sample_topp(logits, p=0.9, k_max=None, temperature=0.8,
                                    generator=gen))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    iota_v = torch.arange(v, dtype=torch.int32, device=dev).expand(logits.shape)
    nv, ni = run("sort(descending, payload=iota) of the logits (the nucleus's ranking)",
                 lambda: repro_torch.sort(logits, descending=True, payload=iota_v))
    want = decode_key_values(torch.sort(encode_key_values(logits), dim=-1,
                                        descending=True)[0], logits.dtype)
    eq("nucleus values vs torch.sort of the keys", nv, want)
    if not torch.equal(torch.sort(ni, dim=-1)[0], iota_v):
        raise AssertionError("the nucleus's ranking is not a permutation")
    eq("the ranking gathers the values", take_along(logits, 1, ni), nv)
    probs = torch.softmax(nv.float() / 0.8, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < 0.9], -1)
    where = (ni == tok[:, None].to(ni.dtype)).int().argmax(dim=-1)
    if not bool(keep.gather(1, where[:, None]).all()):
        raise AssertionError("a sampled token lies outside its nucleus")
    log(f"  exact nucleus: tokens {tok.tolist()}, nucleus sizes {keep.sum(-1).tolist()}; "
        f"peak memory above the logits {peak:.3f} GiB")
    timed(f"sort desc + payload {tuple(logits.shape)} bf16 (exact nucleus), schedule",
          lambda: repro_torch.sort(logits, descending=True, payload=iota_v),
          lambda: torch.sort(logits, dim=-1, descending=True))
    # explicit asks at phase 3e's 32 + 32 over 65,536 rows
    a1, b1 = distinct_sorted_pair(65_536, 32, 32, dev, seed=1)
    ids = torch.arange(65_536 * 64, dtype=torch.int32, device=dev).reshape(65_536, 64)
    pay = (ids[:, :32], ids[:, 32:])
    kern = {"cuda": {"loms_merge2"}, "schedule": None, "streaming": {"grid_merge2"},
            "lax": None}
    outs = {}
    for be, kn in kern.items():
        outs[be] = run(f"merge (65536, 32 + 32) f32, backend={be}",
                       lambda: repro_torch.merge(a1, b1, backend=be), kn)
    for be in ("schedule", "streaming", "lax"):
        eq(f"merge backend={be} vs cuda", outs[be], outs["cuda"])
    pc = run("merge + ids, backend=cuda", lambda: repro_torch.merge(
        a1, b1, payload=pay, backend="cuda"), {"loms_merge2"})
    ps = run("merge + ids, backend=schedule", lambda: repro_torch.merge(
        a1, b1, payload=pay, backend="schedule"))
    eq("merge + ids: cuda vs schedule (one permutation)", pc, ps)
    timed("merge (65536, 32 + 32) f32 + ids, schedule",
          lambda: repro_torch.merge(a1, b1, payload=pay, backend="schedule"),
          lambda: torch.sort(torch.cat([a1, b1], 1), dim=-1, stable=True))
    # the ragged merge 7 + 5
    a7 = total_order_sorted(seg_tile(65_536, 7, torch.float32, dev, seed=2))
    b5 = total_order_sorted(seg_tile(65_536, 5, torch.float32, dev, seed=3))
    rg = run("merge (65536, 7 + 5) f32 + ids (ragged: schedule)",
             lambda: repro_torch.merge(a7, b5, payload=(ids[:, :7], ids[:, 7:12])))
    eq("ragged merge vs the CPU", rg, repro_torch.merge(
        a7.cpu(), b5.cpu(), payload=(ids[:, :7].cpu(), ids[:, 7:12].cpu())))
    timed("merge (65536, 7 + 5) f32 + ids, schedule",
          lambda: repro_torch.merge(a7, b5, payload=(ids[:, :7], ids[:, 7:12])),
          lambda: torch.sort(torch.cat([a7, b5], 1), dim=-1, stable=True))
    # topk's new arguments at the vocab width
    vocab = {"vocab_phase1", "vocab_merge_level"}
    k = 64
    t0v, t0i = run("topk axis=0 of the transposed logits",
                   lambda: repro_torch.topk(logits.T, k, axis=0), vocab)
    eq("topk axis=0 vs the CPU", (t0v, t0i), repro_torch.topk(logits.T.cpu(), k, axis=0))
    tv, ti, tp = run("topk with payload=iota",
                     lambda: repro_torch.topk(logits, k, payload=iota_v), vocab)
    eq("topk payload is the indices", tp, ti)
    eq("topk axis=0 is the transpose", (t0v.T, t0i.T), (tv, ti))
    eq("with_indices=False", run("topk with_indices=False", lambda: repro_torch.topk(
        logits, k, with_indices=False), vocab), tv)
    # integer keys run the vocab kernels on raw int32 (uint32 and int16 as
    # order-preserving int32 keys), bit-equal to the kernels' plain version
    from repro_torch.api import topk_block

    blk = topk_block(logits.shape[1], k, batch=logits.shape[0], dtype=torch.int32)
    xi = torch.from_numpy(rng.integers(-50, 50, logits.shape).astype(np.int32)).to(dev)
    iv, ii = run("topk int32 keys (the vocab kernels)", lambda: repro_torch.topk(xi, k), vocab)
    eq("int32 topk vs the kernels' plain version", (iv, ii),
       K.vocab_topk_plain(xi.cpu(), k, blk))
    xu = rng.integers(0, 2 ** 32, logits.shape, dtype=np.uint64).astype(np.uint32)
    xu[:, :2] = (0, 2 ** 32 - 1)
    xu = torch.from_numpy(xu).to(dev)
    uv, ui = run("topk uint32 keys (the vocab kernels)", lambda: repro_torch.topk(xu, k), vocab)
    eq("uint32 topk vs the CPU", (uv, ui), repro_torch.topk(xu.cpu(), k))
    xs = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, logits.shape).astype(np.int16)).to(dev)
    sv, si = run("topk int16 keys (the vocab kernels)", lambda: repro_torch.topk(xs, k), vocab)
    eq("int16 topk vs the CPU", (sv, si), repro_torch.topk(xs.cpu(), k))
    ms = cuda_ms(lambda: repro_torch.topk(xi, k), 3, 1)
    log(f"  topk int32 {tuple(xi.shape)} k {k}: {ms:.4f} ms; one torch.topk "
        f"{cuda_ms(lambda: torch.topk(xi, k), 3, 1):.4f} ms ({card})")
    av, ai = run("topk descending=False stable=True (schedule)",
                 lambda: repro_torch.topk(logits, k, descending=False, stable=True))
    order = torch.sort(encode_key_values(logits), dim=-1, stable=True)[1][:, :k]
    eq("ascending topk values vs torch.sort of the keys", av, take_along(logits, 1, order))
    eq("ascending topk indices gather its values", take_along(logits, 1, ai), av)
    tie = encode_key_values(av[:, 1:]) == encode_key_values(av[:, :-1])
    if bool((tie & (ai[:, 1:] <= ai[:, :-1])).any()) or any(
            len(set(r)) != k for r in ai.tolist()):
        raise AssertionError("ascending stable topk: indices repeat or ties out of order")
    # the autotune tournament, into a cache in a temporary directory
    tmp = tempfile.TemporaryDirectory(prefix="autotune_")
    prev = C.set_default_cache(C.AutotuneCache(os.path.join(tmp.name, "autotune.json")))
    try:
        w1 = run("autotune_merge2(32, 32) at 65,536 rows", lambda: P.autotune_merge2(
            32, 32, device=dev, batch=65_536), {"loms_merge2"})
        w2 = run("autotune_sort(1024) bf16 at 16,384 rows", lambda: P.autotune_sort(
            1024, device=dev, batch=16_384, dtype=torch.bfloat16), {"loms_sort"})
        w3 = run("autotune_topk(256, 16) at 4096 rows", lambda: P.autotune_topk(
            256, 16, device=dev, batch=4096), {"router_topk"})
        for name, w in (("merge2", w1), ("sort", w2), ("topk", w3)):
            log(f"  autotune {name}: winner {w.network} n_cols {w.n_cols} block {w.block} "
                f"at {w.us:.2f} us ({card})")
        s1 = total_order_sorted(seg_tile(65_536, 32, torch.float32, dev, 4))
        s2 = total_order_sorted(seg_tile(65_536, 32, torch.float32, dev, 5))
        spec = repro_torch.SortSpec(op="merge", lengths=(32, 32), batch=65_536,
                                    has_payload=True)
        if repro_torch.plan(spec).network != w1.network:
            raise AssertionError("the auto merge does not plan the tuned family")
        got = run("merge + ids at the tuned shape", lambda: repro_torch.merge(
            s1, s2, payload=pay), {"loms_merge2"})
        want = loms_merge2(s1[:2048].cpu(), s2[:2048].cpu(), (ids[:2048].cpu(),),
                           network=w1.network, n_cols=w1.n_cols, key_dtype=torch.float32)
        eq("tuned merge vs its plain version", (got[0][:2048], got[1][:2048]),
           (want[0], want[2][0]))
        got = run("sort + payload at the tuned shape", lambda: repro_torch.sort(
            x4, payload=p4), {"loms_sort"})
        want = loms_sort(x4[:256].cpu(), (p4[:256].cpu(),), network=w2.network,
                         key_dtype=torch.bfloat16)
        eq("tuned sort vs its plain version", (got[0][:256], got[1][:256]),
           (want[0], want[2][0]))
        xr = seg_tile(4096, 256, torch.float32, dev, 6)
        got = run("topk k 16 at the tuned shape", lambda: repro_torch.topk(xr, 16),
                  {"router_topk"})
        eq("tuned topk vs its plain version", got,
           K.router_topk(xr.cpu(), 16, block=K.topk_tiles(4096, 256, block=w3.block)[0]))
    finally:
        C.set_default_cache(prev)
        tmp.cleanup()
    return total, rows


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


def _rows_of(cache, rows):
    """A copy of a cache's first ``rows`` rows (decode writes in place): any
    layer dict (GQA's ``k`` / ``v``, MLA's ``ckv`` / ``kpe``), its ``pos``
    a scalar or one a row."""
    return {part: [{name: t.clone() if t.ndim == 0 else t[:rows].clone()
                    for name, t in lc.items()} for lc in layers]
            for part, layers in cache.items()}


def first_layer_f32(params, cfg):
    """The model cut to its first layer (the leading dense block of a MoE
    stack: no router), a float32 copy: (params, cfg)."""
    import torch

    def f32(t):
        return t.to(torch.float32)

    part = "head" if "head" in params["stack"] else "body"
    p = {k: _map(v, f32) for k, v in params.items() if k != "stack"}
    p["stack"] = {part: [_map(params["stack"][part][0], f32)]}
    if part == "head":
        p["stack"]["body"] = []
    return p, dataclasses.replace(cfg, n_layers=1, dtype="float32")


def decode_vs_prefill(dev, params, cfg, card) -> float:
    """The first decode step's logits against the last-position logits of
    a prefill of the prompt and that token, on the model's first layer in
    float32 (no router, so no expert can flip): the largest difference
    over the largest logit. For GQA the two differ only in the order of
    their sums; MLA's decode also runs the absorbed form (the query folded
    through ``wuk``) where the prefill expands the latent."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    p1, c1 = first_layer_f32(params, cfg)
    bsz, plen = 4, 128
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, plen)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        lg, cache = prefill(p1, {"tokens": toks}, init_cache(c1, bsz, plen + 1, dev), c1)
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        dl, _ = decode_step(p1, nxt, cache, c1,
                            positions=torch.full((bsz, 1), plen, dtype=torch.int32, device=dev))
        full, _ = prefill(p1, {"tokens": torch.cat([toks, nxt], 1)},
                          init_cache(c1, bsz, plen + 1, dev), c1)
    err = float((dl - full).abs().max() / full.abs().max())
    log(f"  {cfg.name} first layer, float32: decode step vs a prefill of prompt + token, "
        f"largest difference / largest logit {err:.3e}; {card}")
    del p1
    return err


#: the absorbed MLA decode's error may be this many times the GQA decode's
#: (the same comparison): two more products (the query's latent, 512 wide,
#: and the latent context) and the score split into two sums. Measured on
#: an H100 80GB HBM3 at 700 W: 2.009e-06 against GQA's 2.347e-06 (0.86x),
#: so 4 leaves more than 4x of headroom
MLA_ERR_FACTOR = 4


#: the name phase 3v registers a family under (removed again after)
TWIN_FAMILY = "loms_twin"


def phase_switches(dev, K, params, cfg, card) -> dict:
    """Phase 3v (inside 3h's window, on its qwen3-moe-30b-a3b weights):
    the escape hatches and the family registry on the card, every call
    with its launch counts zeroed before and read after.

    Fused switch off (``set_fused_enabled(False)``): ``topk`` on the
    sampler's (4, 151,936) bf16 logits, k 64, plans ``vocab_topk`` on
    ``cuda`` and runs the unfused rung, rows 4 and 5 as often as fused;
    indices bit-equal to the fused call, values too but in NaN lanes (the
    unfused rung returns the input's own NaN, the fused one decodes a
    canonical NaN: the reference's two rungs do the same). A sort of
    (512, 1024) bf16 with an int32 payload plans ``loms_merge_tree`` and
    launches nothing (the executor), a merge of (512, 512 + 512) f32 with
    a payload plans ``payload`` and launches nothing; their values are
    bit-equal to the fused calls' but in NaN lanes (the executor returns
    the input's values at its permutation), values and payload to the
    same calls on a CPU copy (the sort's first 128 rows). A values-only merge at row 1's shape, (65,536, 32 +
    32) f32, stays on ``cuda``: row 1 once, bit-equal to the fused call.

    Segmented switch off: ``segment_sort`` and ``segment_topk`` at phase
    3d's classes (1024 expert ids with their token ids; 4096 x 1024 bf16
    scores, top-64) plan ``reference`` and launch nothing; the values are
    bit-equal to ``backend="segmented"`` (which launches its class
    kernels), the payload and indices to the same calls on the CPU (the
    per-segment stable argsort: at width 1024 the class network's tie
    order is its own). Then a prefill of 3h's batch and four greedy
    decode steps with ``dispatch="sorted"``: switch on, row 6 once a MoE
    layer a step; off, never; tokens and logits bit-equal.

    ``register_family``: loms's generators under a new name run rows 2
    and 1 (the program executor) bit-equal to ``network="loms"`` (values
    and permutations, on rows with ties); re-registered with bitonic's,
    the next calls equal ``network="bitonic"``'s (the programs kept on the
    card by name were dropped). Both switches and the registry are
    restored however the phase ends. Returns the phase's launches."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.api import SortSpec, plan, set_fused_enabled, topk_block
    from repro_torch.kernels.launch import forget_family
    from repro_torch.kernels.loms_merge import loms_merge2
    from repro_torch.kernels.sort import loms_sort
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.networks import NetworkFamily, register_family, registry
    from repro_torch.networks.families import BUILTIN_FAMILIES
    from repro_torch.segmented import bucket_segments, set_segmented_enabled

    t0 = time.perf_counter()
    total = {n: 0 for n in K.LAUNCHES}

    def counted(name, fn, want):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got, want = dict(K.LAUNCHES), {**{n: 0 for n in K.LAUNCHES}, **want}
        log(f"  launches, {name}: { {n: c for n, c in got.items() if c} }")
        if got != want:
            raise AssertionError(f"3v {name}: launch counts {got} != {want}")
        for n, c in got.items():
            total[n] += c
        return out

    def detail(**spec):
        d = plan(SortSpec(**spec))
        return d.backend, d.detail

    def same(name, got, want, nan_lanes=False):
        """Bit-equal; with ``nan_lanes`` a NaN lane needs a NaN only (a
        route that returns the input's own value keeps its NaN bits, a
        decoded key a canonical NaN)."""
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            nan = torch.isnan(w) if nan_lanes and w.dtype.is_floating_point else None
            if nan is not None and not torch.equal(nan, torch.isnan(g)):
                raise AssertionError(f"3v {name}: NaN lanes differ")
            if nan is not None:
                g, w = g[~nan], w[~nan]
            if g.shape != w.shape or not torch.equal(
                    bits(g) if g.dtype.is_floating_point else g,
                    bits(w) if w.dtype.is_floating_point else w):
                raise AssertionError(f"3v {name}: not bit-equal")

    prev = set_fused_enabled(True), set_segmented_enabled(True)
    try:
        # -- the fused switch --------------------------------------------------
        V, k = cfg.vocab_size, 64
        logits = special_logits(4, V, torch.bfloat16, dev, seed=31)
        tree = K.vocab_merge_launches(V, topk_block(V, k, batch=4, dtype=torch.bfloat16), k)
        rows45 = {"vocab_phase1": 1, "vocab_merge_level": tree}
        fv, fi = counted("top-k, fused", lambda: repro_torch.topk(logits, k), rows45)
        x = seg_tile(512, 1024, torch.bfloat16, dev, seed=32)
        pay = torch.arange(512 * 1024, dtype=torch.int32, device=dev).reshape(512, 1024)
        f_sort = counted("sort with a payload, fused",
                         lambda: repro_torch.sort(x, payload=pay), {"loms_sort": 1})
        a = total_order_sorted(seg_tile(512, 512, torch.float32, dev, seed=33))
        b = total_order_sorted(seg_tile(512, 512, torch.float32, dev, seed=34))
        pa = torch.arange(512 * 512, dtype=torch.int32, device=dev).reshape(512, 512)
        pb = pa + 512 * 512
        f_merge = counted("merge with a payload, fused",
                          lambda: repro_torch.merge(a, b, payload=(pa, pb)),
                          {"loms_merge2": 1})
        va = total_order_sorted(seg_tile(65_536, 32, torch.float32, dev, seed=35))
        vb = total_order_sorted(seg_tile(65_536, 32, torch.float32, dev, seed=36))
        f_vmerge = counted("values-only merge, fused", lambda: repro_torch.merge(va, vb),
                           {"loms_merge2": 1})
        set_fused_enabled(False)
        routes = (detail(op="topk", lengths=(V,), k=k, batch=4, dtype="bfloat16"),
                  detail(op="sort", lengths=(1024,), batch=512, dtype="bfloat16",
                         has_payload=True),
                  detail(op="merge", lengths=(512, 512), batch=512, has_payload=True),
                  detail(op="merge", lengths=(32, 32), batch=65_536))
        want_routes = (("cuda", "vocab_topk"), ("schedule", "loms_merge_tree"),
                       ("schedule", "payload"), ("cuda", "loms_merge2"))
        log(f"  fused off, routes: {routes}")
        if routes != want_routes:
            raise AssertionError(f"3v fused off: routes {routes} != {want_routes}")
        uv, ui = counted("top-k, fused off", lambda: repro_torch.topk(logits, k), rows45)
        same("top-k, fused off: against fused", (uv, ui), (fv, fi), nan_lanes=True)
        log(f"  top-k fused off: indices bit-equal to fused, values too but in "
            f"{int(torch.isnan(fv).sum())} NaN lanes (NaN in both)")
        u_sort = counted("sort with a payload, fused off",
                         lambda: repro_torch.sort(x, payload=pay), {})
        u_merge = counted("merge with a payload, fused off",
                          lambda: repro_torch.merge(a, b, payload=(pa, pb)), {})
        u_vmerge = counted("values-only merge, fused off", lambda: repro_torch.merge(va, vb),
                           {"loms_merge2": 1})
        same("sort, fused off: values against fused", u_sort[:1], f_sort[:1], nan_lanes=True)
        same("merge, fused off: values against fused", u_merge[:1], f_merge[:1],
             nan_lanes=True)
        same("values-only merge, fused off", (u_vmerge,), (f_vmerge,))
        cpu_rows = 128  # rows sort on their own; the CPU's executor takes 8 s for all 512
        same("sort, fused off: against the CPU", (t[:cpu_rows] for t in u_sort),
             repro_torch.sort(x[:cpu_rows].cpu(), payload=pay[:cpu_rows].cpu()))
        same("merge, fused off: against the CPU", u_merge,
             repro_torch.merge(a.cpu(), b.cpu(), payload=(pa.cpu(), pb.cpu())))
        log(f"  fused off: sort and merge with a payload on the executor, values bit-equal "
            f"to the fused calls' but in NaN lanes ({int(torch.isnan(x).sum())} in the "
            f"sort), values and payload to the CPU's; the values-only merge on row 1, "
            f"bit-equal")
        set_fused_enabled(True)

        # -- the segmented switch ----------------------------------------------
        rng = np.random.default_rng(3)  # phase 3d's inputs
        experts = torch.from_numpy(rng.integers(0, 64, 1024).astype(np.int32)).to(dev)
        tok_ids = torch.arange(1024, dtype=torch.int32, device=dev)
        nq, nc, kq = 4096, 1024, 64
        scores = seg_tile(nq, nc, torch.bfloat16, dev, seed=9).reshape(-1)
        q_offs = tuple(range(0, (nq + 1) * nc, nc))
        classes = {"seg_sort": sum(c.width > 1 for lens in ([1024], np.diff(q_offs))
                                   for c in bucket_segments(lens, 1024)[0])}

        def seg_calls(backend):
            return (repro_torch.segment_sort(experts, (0, 1024), payload=tok_ids,
                                             backend=backend),
                    repro_torch.segment_topk(scores, q_offs, kq, backend=backend)[:2])

        kern = counted("segment_sort / segment_topk, backend='segmented'",
                       lambda: seg_calls("segmented"), classes)
        set_segmented_enabled(False)
        route = detail(op="sort", lengths=(1024,), segment_offsets=((0, 1024),))
        if route != ("segmented", "reference"):
            raise AssertionError(f"3v segmented off: route {route}")
        auto = counted("segment_sort / segment_topk, segmented off",
                       lambda: seg_calls("auto"), {})
        same("segment_sort / segment_topk, segmented off: values against the kernels",
             (auto[0][0], auto[1][0]), (kern[0][0], kern[1][0]))
        cpu = (repro_torch.segment_sort(experts.cpu(), (0, 1024), payload=tok_ids.cpu()),
               repro_torch.segment_topk(scores.cpu(), q_offs, kq)[:2])
        same("segment_sort / segment_topk, segmented off: against the CPU",
             auto[0] + auto[1], cpu[0] + cpu[1])
        log("  segmented off: the per-segment plain version, no class launch; values "
            "bit-equal to the class kernels', payload and indices to the CPU's")

        srt = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="sorted"))
        bsz, plen, steps = 4, 128, 4
        toks = torch.from_numpy(np.random.default_rng(0).integers(  # 3h's prompts
            0, cfg.vocab_size, (bsz, plen)).astype(np.int32)).to(dev)
        moe_layers = cfg.n_layers - cfg.moe.first_dense_layers

        def greedy_steps():
            with torch.inference_mode():
                lg, cache = prefill(params, {"tokens": toks},
                                    init_cache(srt, bsz, plen + steps, dev), srt)
                outs, nxt = [lg], torch.argmax(lg, -1).to(torch.int32)[:, None]
                tokens = [nxt]
                for i in range(steps):
                    pos = torch.full((bsz, 1), plen + i, dtype=torch.int32, device=dev)
                    lg, cache = decode_step(params, nxt, cache, srt, positions=pos)
                    nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
                    outs.append(lg)
                    tokens.append(nxt)
                return outs, torch.cat(tokens, 1)

        set_segmented_enabled(True)
        on = counted("MoE prefill + 4 greedy decode steps, sorted dispatch",
                     greedy_steps, {"seg_sort": moe_layers * steps})
        set_segmented_enabled(False)
        off = counted("the same steps, segmented off", greedy_steps, {})
        same("MoE steps, segmented off: logits", off[0], on[0])
        same("MoE steps, segmented off: tokens", (off[1],), (on[1],))
        log(f"  MoE segmented off: the dispatch sort on the executor; prefill and {steps} "
            f"decode steps' logits and tokens bit-equal ({moe_layers * steps} class sorts "
            "with the switch on)")
        set_segmented_enabled(True)

        # -- register_family ---------------------------------------------------
        xs = seg_tile(512, 1024, torch.bfloat16, dev, seed=37)
        ma = total_order_sorted(seg_tile(512, 512, torch.float32, dev, seed=38))
        mb = total_order_sorted(seg_tile(512, 512, torch.float32, dev, seed=39))
        n_cols = BUILTIN_FAMILIES["loms"][0](512, 512).n_cols  # the family's own columns

        def rows12(family, cols=None):
            s = loms_sort(xs, network=family, key_dtype=torch.bfloat16, want_perm=True)
            m = loms_merge2(ma, mb, network=family, n_cols=cols or 2,
                            key_dtype=torch.float32, want_perm=True)
            return s[:2] + m[:2]

        one_each = {"loms_sort": 1, "loms_merge2": 1}
        register_family(NetworkFamily(TWIN_FAMILY, *BUILTIN_FAMILIES["loms"]))
        twin = counted(f"rows 2 and 1, network={TWIN_FAMILY!r} (loms)",
                       lambda: rows12(TWIN_FAMILY), one_each)
        loms = counted("rows 2 and 1, network='loms'", lambda: rows12("loms", n_cols),
                       one_each)
        same(f"{TWIN_FAMILY} as loms", twin, loms)
        register_family(NetworkFamily(TWIN_FAMILY, *BUILTIN_FAMILIES["bitonic"]))
        twin = counted(f"rows 2 and 1, network={TWIN_FAMILY!r} (bitonic)",
                       lambda: rows12(TWIN_FAMILY), one_each)
        bitonic = counted("rows 2 and 1, network='bitonic'", lambda: rows12("bitonic"),
                          one_each)
        same(f"{TWIN_FAMILY} as bitonic", twin, bitonic)
        if torch.equal(bitonic[1], loms[1]) or torch.equal(bitonic[3], loms[3]):
            raise AssertionError("3v: loms and bitonic permutations agree; the "
                                 "re-registration check shows nothing")
        log(f"  register_family: {TWIN_FAMILY} ran loms's programs, then bitonic's, each "
            "bit-equal (values and permutations) to the family's own name")
    finally:
        set_fused_enabled(prev[0])
        set_segmented_enabled(prev[1])
        registry._REGISTRY.pop(TWIN_FAMILY, None)
        forget_family(TWIN_FAMILY)
    log(f"  phase 3v {time.perf_counter() - t0:.1f} s; launches {total}; {card}")
    return total


def phase_moe(dev, K, card, arch: str = "qwen3-moe-30b-a3b", gqa_err=None,
              then=None) -> dict:
    """Phases 3h and 3i: a MoE model at its published width and depth
    (qwen3-moe-30b-a3b: 48 layers, d_model 2048, 128 experts top-8,
    d_expert 768, vocab 151,936; deepseek-v2-lite-16b: 27 layers, MLA,
    64 experts top-6 of d_expert 1408, 2 shared experts, one leading dense
    layer, vocab 102,400; random bf16 weights from seed 0) through
    ``generate`` on 3a's prompts, each run with its launch counts zeroed
    before and read after: sampled and ragged (rows 4 and 5 a token),
    greedy (nothing), greedy with the sorted dispatch (row 6 once a MoE
    layer a decode step; tokens, prefill and first decode logits
    bit-equal to the scatter run's); a decode step at B = 3 and B = 4 from
    one cache (rows 0-2 bit-equal: the capacity counts the real rows); the
    decode profile with the attention, the router's executor calls and the
    expert products as ranges, beside the weight-read floor of a step. For
    MLA also the latent cache's size, and the absorbed decode against the
    expanded form (:func:`decode_vs_prefill`) within ``MLA_ERR_FACTOR``
    times the GQA path's ``gqa_err``. ``then(params, cfg)``, if given,
    runs last, on the model's weights."""
    import numpy as np
    import torch

    import repro_torch.models.moe as MOE
    import repro_torch.models.transformer as TR
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate

    cfg = get_config(arch)
    torch.cuda.synchronize()
    log(f"  before init: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    emb = params["embed"]["emb"]
    expert_bytes = sum(lay["ffn"][w]["w"].numel() * lay["ffn"][w]["w"].element_size()
                       for lay in params["stack"]["body"] for w in ("wi", "wg", "wo"))
    step_bytes = nbytes - emb.numel() * emb.element_size()  # the embedding: B rows
    attn = (f"MLA of {cfg.n_heads} heads (kv_lora {cfg.mla.kv_lora_rank}, rope "
            f"{cfg.mla.qk_rope_head_dim})" if cfg.mla is not None else
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}")
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {attn}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_expert {cfg.moe.d_expert} "
        f"({cfg.moe.n_shared_experts} shared, {cfg.moe.first_dense_layers} dense first), "
        f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B parameters, {nbytes / 1e9:.2f} GB of "
        f"weights, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"init {time.perf_counter() - t0:.1f} s; {card}")
    log(f"  weight-read floor of a decode step (every expert's buffer computed): "
        f"{step_bytes / 1e9:.2f} GB = {step_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, experts {expert_bytes / 1e9:.2f} GB = "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms")

    rng = np.random.default_rng(0)  # phase 3a's prompts
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    lens = rng.integers(1, plen + 1, bsz).astype(np.int32)
    ragged = tokens.copy()
    for r, n in enumerate(lens):
        ragged[r, n:] = 0
    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0, time_steps=True)
    greedy = dataclasses.replace(sc, temperature=0.0)
    srt = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="sorted"))
    tree = K.vocab_merge_launches(cfg.vocab_size, topk_block(cfg.vocab_size, k), k)
    sampled = {"vocab_phase1": new, "vocab_merge_level": new * tree}
    moe_layers = cfg.n_layers - cfg.moe.first_dense_layers
    runs = (
        ("sampled", lambda: generate(params, {"tokens": tokens}, cfg, sc, device=dev), sampled),
        ("greedy", lambda: generate(params, {"tokens": tokens}, cfg, greedy, device=dev), {}),
        ("ragged", lambda: generate(params, {"tokens": ragged, "lengths": lens}, cfg, sc,
                                    device=dev), sampled),
        ("greedy, sorted dispatch",
         lambda: generate(params, {"tokens": tokens}, srt, greedy, device=dev),
         {"seg_sort": moe_layers * (new - 1)}),
    )
    outs, launches = {}, {n: 0 for n in K.LAUNCHES}
    for name, run, want in runs:
        want = {**{n: 0 for n in K.LAUNCHES}, **want}
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  launches, {name} run: { {n: c for n, c in got.items() if c} } "
            f"(expected { {n: c for n, c in want.items() if c} })")
        if got != want:
            raise AssertionError(f"MoE {name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
        o = outs[name]
        t = o["tokens"]
        if t.shape != (bsz, new) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"MoE {name} run gave tokens {t.shape} outside the vocab")
        log(f"  {name}: prefill {o['prefill_s'] * 1e3:.2f} ms, decode step p50 "
            f"{o['decode_step_p50_us'] / 1e3:.3f} ms p99 {o['decode_step_p99_us'] / 1e3:.3f} ms, "
            f"{o['tok_per_s']:.2f} tok/s; first tokens {t[0, :6].tolist()}; {card}")
    if not np.array_equal(outs["greedy, sorted dispatch"]["tokens"], outs["greedy"]["tokens"]):
        raise AssertionError("MoE greedy tokens differ between the sorted and scatter dispatch")

    with torch.inference_mode():
        toks = torch.from_numpy(tokens).to(dev)
        pos = torch.full((bsz, 1), plen, dtype=torch.int32, device=dev)
        first = {}
        for name, c in (("scatter", cfg), ("sorted", srt)):
            lg, cache = prefill(params, {"tokens": toks}, init_cache(c, bsz, plen + 1, dev), c)
            if lg.shape != (bsz, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"MoE {name}: prefill logits not finite of shape (B, V)")
            nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
            if not np.array_equal(nxt[:, 0].cpu().numpy(), outs["greedy"]["tokens"][:, 0]):
                raise AssertionError(f"MoE {name}: first token is not the greedy run's")
            K.reset_launch_counts()
            dl, _ = decode_step(params, nxt, _rows_of(cache, bsz), c, positions=pos)
            torch.cuda.synchronize()
            want_sorts = moe_layers if name == "sorted" else 0
            if K.LAUNCHES["seg_sort"] != want_sorts:
                raise AssertionError(f"MoE {name} decode step: {K.LAUNCHES['seg_sort']} class "
                                     f"sorts, not {want_sorts}")
            first[name] = (lg, dl, cache, nxt)
        for i, what in ((0, "prefill"), (1, "first decode")):
            if not torch.equal(bits(first["scatter"][i]), bits(first["sorted"][i])):
                raise AssertionError(f"MoE {what} logits differ between the sorted and "
                                     "scatter dispatch")
        log(f"  sorted dispatch: tokens, prefill and first decode logits bit-equal to the "
            f"scatter run's; {moe_layers} class sorts a decode step")
        lg, dl4, cache, nxt = first["scatter"]
        dl3, _ = decode_step(params, nxt[:3], _rows_of(cache, 3), cfg, positions=pos[:3])
        if not torch.equal(bits(dl3), bits(dl4[:3])):
            raise AssertionError("MoE decode at B = 3 and B = 4: rows 0-2 differ")
        log("  decode step at B = 3 and B = 4 from one cache: rows 0-2 bit-equal")
        if cfg.mla is not None:  # the latent cache: 576 elements a token a layer
            lc = cache["body"][0]
            per = lc["ckv"].shape[1] + lc["kpe"].shape[1]
            if per != cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim or set(lc) != {
                    "ckv", "kpe", "pos"}:
                raise AssertionError(f"MLA cache holds {set(lc)}, {per} elements a token")
            cbytes = sum(t.numel() * t.element_size() for part in cache.values()
                         for c in part for n, t in c.items() if n != "pos")
            gqa = 2 * cfg.n_heads * cfg.mla.v_head_dim
            log(f"  latent cache: {per} elements a token a layer (GQA at {cfg.n_heads} kv-heads "
                f"of {cfg.mla.v_head_dim}: {gqa}, {gqa / per:.1f}x); {cbytes / 1e6:.2f} MB for "
                f"B={bsz} x {plen + 1} tokens x {cfg.n_layers} layers "
                f"({cbytes / (bsz * (plen + 1) * cfg.n_layers):.0f} bytes a token a layer)")
        del first, lg, dl4, cache, dl3
    if cfg.mla is not None:
        err = decode_vs_prefill(dev, params, cfg, card)
        tol = MLA_ERR_FACTOR * gqa_err
        log(f"  absorbed MLA decode vs the expanded form: {err:.3e}; tolerance {tol:.3e} = "
            f"{MLA_ERR_FACTOR} x the GQA path's {gqa_err:.3e} (Qwen3-8B, this run)")
        if not err <= tol:
            raise AssertionError(f"absorbed MLA decode differs from the expanded form by "
                                 f"{err:.3e} > {tol:.3e}")

    attention = (TR, "mla_apply", "mla.attention") if cfg.mla is not None else (
        TR, "attn_apply", "attention")
    ranges = profile_serve(dev, params, cfg, card, spans=(
        attention, (MOE, "router_topk", "moe.router_topk"),
        (MOE, "_expert_ffn", "moe.expert_ffn")))
    for label, (calls, dev_ms, host_ms) in sorted(ranges.items()):
        log(f"    {label}: {calls:.0f} calls a step, device {dev_ms:.3f} ms, host "
            f"{host_ms:.3f} ms a step; {card}")
    if "moe.expert_ffn" in ranges:
        log(f"    expert products {ranges['moe.expert_ffn'][1]:.3f} ms a step against their "
            f"floor {expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms (the step's "
            f"{step_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms); {card}")
    if then is not None:  # a later phase on these weights before they are freed
        then(params, cfg)
    return launches


#: the recurrent SSM decode's error against the chunked dual form (the
#: last of 128 teacher-forced decode steps after a 128-token prefill,
#: against one prefill of all 256 tokens, on one layer in float32) may be
#: this many times the GQA decode's (:func:`decode_vs_prefill`): the
#: recurrence rounds its state 128 times where the dual form sums a chunk
#: in one product. Measured on an H100 80GB HBM3 at 700 W against GQA's
#: 2.347e-06: mamba2-780m's first layer 2.148e-06 (0.92x), zamba2-2.7b's
#: 1.305e-06 (0.56x) and its shared block 6.270e-07 (0.27x), so 4 leaves
#: more than 4x of headroom
SSM_ERR_FACTOR = 4


def recurrent_vs_dual(dev, mixer, cfg, card, gqa_err, shared=None) -> float:
    """The SSM mixer's recurrent form against its dual form, with the
    inter-chunk carry, on one layer's full-width weights in float32: a
    prefill of 256 tokens (two chunks of 128) against a prefill of the
    first 128 and 128 decode steps, teacher-forced on the same inputs.
    ``shared`` (zamba2's attention + MLP block) gets the same comparison
    through ``block_apply``. Returns the largest error of the last
    position's output over its largest value; raises past
    ``SSM_ERR_FACTOR`` x ``gqa_err``."""
    import numpy as np
    import torch

    from repro_torch.models.attention import attn_cache_init
    from repro_torch.models.ssm import ssm_apply, ssm_cache_init
    from repro_torch.models.transformer import block_apply

    c32 = dataclasses.replace(cfg, dtype="float32")
    bsz, half = 4, cfg.ssm.chunk
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (bsz, 2 * half, cfg.d_model)).astype(np.float32)).to(dev)

    def ssm_run(p, xs, mode, cache, t):
        return ssm_apply(p, xs, c32, cache=cache, mode=mode)

    def attn_run(p, xs, mode, cache, t):
        pos = None if mode == "prefill" else torch.full((bsz, 1), t, dtype=torch.int32,
                                                          device=dev)
        return block_apply(p, xs, c32, mode=mode, cache=cache, positions=pos)

    checks = [("SSM mixer", _map(mixer, lambda t: t.float()), ssm_run,
               lambda: ssm_cache_init(c32, bsz, torch.float32, dev))]
    if shared is not None:
        checks.append(("shared attention + MLP block", _map(shared, lambda t: t.float()),
                       attn_run, lambda: attn_cache_init(c32, bsz, 2 * half, torch.float32,
                                                         dev)))
    worst = 0.0
    with torch.inference_mode():
        for name, p, run, cache_init in checks:
            full, _ = run(p, x, "prefill", cache_init(), 0)
            _, cache = run(p, x[:, :half], "prefill", cache_init(), 0)
            steps = []
            for t in range(half, 2 * half):
                y, cache = run(p, x[:, t:t + 1], "decode", cache, t)
                steps.append(y)
            rec = torch.cat(steps, dim=1)
            ref = full[:, half:]
            last = float((rec[:, -1] - ref[:, -1]).abs().max() / ref[:, -1].abs().max())
            every = float((rec - ref).abs().max() / ref.abs().max())
            if not bool(torch.isfinite(rec).all()):
                raise AssertionError(f"{cfg.name} {name}: recurrent outputs not finite")
            log(f"  {cfg.name} {name}, float32: {half} decode steps after a {half}-token "
                f"prefill vs one {2 * half}-token prefill: last position {last:.3e}, every "
                f"position {every:.3e} (largest difference / largest value); GQA's "
                f"decode_vs_prefill {gqa_err:.3e} (ratio {last / gqa_err:.2f}); {card}")
            worst = max(worst, last)
            del p, full, cache, steps, rec, ref
    tol = SSM_ERR_FACTOR * gqa_err
    if not worst <= tol:
        raise AssertionError(f"{cfg.name}: recurrent decode differs from the dual form by "
                             f"{worst:.3e} > {tol:.3e} = {SSM_ERR_FACTOR} x GQA's {gqa_err:.3e}")
    log(f"  {cfg.name}: recurrent against dual within {tol:.3e} = {SSM_ERR_FACTOR} x GQA's")
    return worst


def phase_ssm(dev, K, card, arch: str, gqa_err: float) -> dict:
    """Phases 3j and 3k: the SSM family (mamba2-780m: 48 Mamba2 layers,
    d_model 1536, d_state 128, head_dim 64, chunk 128, vocab 50,280, tied
    embeddings) and the hybrid (zamba2-2.7b: 54 Mamba2 layers of d_model
    2560, d_state 64, and one shared attention + MLP block after every 6 of
    them, 32 heads of 80, d_ff 10,240, vocab 32,000) at their published
    width and depth, random bf16 weights from seed 0, through ``generate``
    on 3a's prompts, each run with its launch counts zeroed before and read
    after: sampled (rows 4 and 5 a token), greedy (nothing), ragged
    (refused); a decode step at B = 3 and B = 4 from one cache (rows 0-2
    bit-equal); the recurrent decode against the chunked dual form
    (:func:`recurrent_vs_dual`); the smoke config in float32 on the card
    against the CPU; the decode profile with the mixer (and the shared
    block's attention) as ranges, beside the step's floor: the weights a
    step reads and the SSM state read and written."""
    import numpy as np
    import torch

    import repro_torch.models.transformer as TR
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import decode_step, init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate

    cfg = get_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    n_params = sum(t.numel() for t in _leaves(params))
    total = nbytes(params)
    step_bytes = total  # the tied embedding is read at the logits
    if not cfg.tie_embeddings:  # the embedding: B rows
        step_bytes -= nbytes(params["embed"])
    n_groups = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    if n_groups:  # the shared block is read once a group
        step_bytes += (n_groups - 1) * nbytes(params["stack"]["shared"])
    s = cfg.ssm
    shape = (f", shared attention + MLP after every {cfg.attn_every} ({n_groups} calls: "
             f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff})" if n_groups else "")
    log(f"  {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, d_state "
        f"{s.d_state}, head_dim {s.head_dim}, chunk {s.chunk}{shape}, vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f} B parameters, {total / 1e9:.2f} GB of weights, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, init "
        f"{time.perf_counter() - t0:.1f} s; {card}")

    rng = np.random.default_rng(0)  # phase 3a's prompts
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    lens = rng.integers(1, plen + 1, bsz).astype(np.int32)
    state = init_cache(cfg, bsz, plen + new, dev)
    ssm_bytes = sum(nbytes(lc) for lc in state["body"])
    kv_bytes = sum(nbytes(lc) for lc in state.get("shared", []))
    del state
    floor_ms = (step_bytes + 2 * ssm_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"  SSM state at B={bsz}: {ssm_bytes / 1e6:.1f} MB ({cfg.n_layers} layers of float32 "
        f"(B, H, P, N) and the conv window), read and written every step"
        + (f"; the shared block's KV caches {kv_bytes / 1e6:.1f} MB at {plen + new} tokens"
           if n_groups else ""))
    log(f"  floor of a decode step: weights read {step_bytes / 1e9:.2f} GB + state "
        f"2 x {ssm_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor_ms:.3f} ms")

    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0, time_steps=True)
    tree = K.vocab_merge_launches(cfg.vocab_size, topk_block(cfg.vocab_size, k), k)
    runs = (
        ("sampled", lambda: generate(params, {"tokens": tokens}, cfg, sc, device=dev),
         {"vocab_phase1": new, "vocab_merge_level": new * tree}),
        ("greedy", lambda: generate(params, {"tokens": tokens}, cfg,
                                    dataclasses.replace(sc, temperature=0.0), device=dev), {}),
    )
    outs, launches = {}, {n: 0 for n in K.LAUNCHES}
    for name, run, want in runs:
        want = {**{n: 0 for n in K.LAUNCHES}, **want}
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  launches, {name} run: { {n: c for n, c in got.items() if c} } "
            f"(expected { {n: c for n, c in want.items() if c} })")
        if got != want:
            raise AssertionError(f"{cfg.name} {name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
        o = outs[name]
        t = o["tokens"]
        if t.shape != (bsz, new) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name} {name} run gave tokens {t.shape} outside the "
                                 "vocab")
        log(f"  {name}: prefill {o['prefill_s'] * 1e3:.2f} ms, decode step p50 "
            f"{o['decode_step_p50_us'] / 1e3:.3f} ms p99 {o['decode_step_p99_us'] / 1e3:.3f} ms, "
            f"{o['tok_per_s']:.2f} tok/s (floor {floor_ms:.3f} ms); first tokens "
            f"{t[0, :6].tolist()}; {card}")
    ragged = tokens.copy()
    for r, n in enumerate(lens):
        ragged[r, n:] = 0
    K.reset_launch_counts()
    try:
        generate(params, {"tokens": ragged, "lengths": lens}, cfg, sc, device=dev)
    except ValueError as exc:
        log(f"  ragged prompts refused: {exc}")
    else:
        raise AssertionError(f"{cfg.name}: ragged prompts were served")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"{cfg.name}: the refused ragged run launched {dict(K.LAUNCHES)}")

    with torch.inference_mode():
        toks = torch.from_numpy(tokens).to(dev)
        pos = torch.full((bsz, 1), plen, dtype=torch.int32, device=dev)
        lg, cache = prefill(params, {"tokens": toks}, init_cache(cfg, bsz, plen + 1, dev), cfg)
        if lg.shape != (bsz, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{cfg.name}: prefill logits not finite of shape (B, V)")
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        if not np.array_equal(nxt[:, 0].cpu().numpy(), outs["greedy"]["tokens"][:, 0]):
            raise AssertionError(f"{cfg.name}: first token is not the greedy run's")
        dl4, _ = decode_step(params, nxt, _rows_of(cache, bsz), cfg, positions=pos)
        dl3, _ = decode_step(params, nxt[:3], _rows_of(cache, 3), cfg, positions=pos[:3])
        if not bool(torch.isfinite(dl4).all()):
            raise AssertionError(f"{cfg.name}: decode logits not finite")
        if not torch.equal(bits(dl3), bits(dl4[:3])):
            raise AssertionError(f"{cfg.name} decode at B = 3 and B = 4: rows 0-2 differ")
        log("  decode step at B = 3 and B = 4 from one cache: rows 0-2 bit-equal")
        del lg, cache, dl3, dl4

    stack = params["stack"]
    recurrent_vs_dual(dev, stack["body"][0]["mixer"], cfg, card, gqa_err,
                      shared=stack.get("shared"))

    # a small input against the CPU: the smoke config in float32
    small = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_gpu = model_init(torch.Generator(device=dev).manual_seed(1), small, dev)
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    stoks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 32)).astype(np.int32))
    nxt = stoks[:, :1]
    p1 = torch.full((2, 1), 32, dtype=torch.int32)
    with torch.inference_mode():
        lg, c = prefill(p_gpu, {"tokens": stoks.to(dev)}, init_cache(small, 2, 33, dev), small)
        dg, _ = decode_step(p_gpu, nxt.to(dev), c, small, positions=p1.to(dev))
        lc, c = prefill(p_cpu, {"tokens": stoks}, init_cache(small, 2, 33, "cpu"), small)
        dc, _ = decode_step(p_cpu, nxt, c, small, positions=p1)
    diff = max(float((lg.cpu() - lc).abs().max()), float((dg.cpu() - dc).abs().max()))
    if not diff <= 1e-4:
        raise AssertionError(f"{small.name}: logits on the card differ from the CPU by {diff}")
    log(f"  {small.name} f32: card vs CPU prefill and decode logits max |diff| {diff:.2e} "
        "(<= 1e-4)")

    spans = [(TR, "ssm_apply", "ssm.mixer")]
    if n_groups:
        spans.append((TR, "attn_apply", "attention"))
    ranges = profile_serve(dev, params, cfg, card, spans=tuple(spans))
    for label, (calls, dev_ms, host_ms) in sorted(ranges.items()):
        log(f"    {label}: {calls:.0f} calls a step, device {dev_ms:.3f} ms, host "
            f"{host_ms:.3f} ms a step; {card}")
    log(f"    the step's floor {floor_ms:.3f} ms (weights {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms, state {2 * ssm_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); {card}")
    return launches


#: bf16 dense tensor-core peak of an H100 SXM (NVIDIA's data sheet, no
#: sparsity), the rate a model's products are floored at
BF16_FLOP_PER_S = 989e12


def device_busy(fn, steps: int = 1):
    """torch.profiler over ``fn`` (run once, warm): (kernels, device busy
    ms, wall ms), each over ``steps``; device busy is the sum of the
    kernels' own times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, kernels = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        busy += t
        kernels += ev.count
    return kernels / steps, busy / steps / 1e3, wall_us / steps / 1e3


def phase_vlm(dev, K, card) -> dict:
    """Phase 3l: internvl2-26b (the vlm frontend: 48 layers, d_model 6144,
    48/8 heads of 128, d_ff 16,384, vocab 92,553; 256 patches of 3200 a
    row projected by ``patch_proj`` in front of the text) at its published
    width and depth, random bf16 weights from seed 0, through ``generate``
    on 3a's prompts with the launcher's patches (drawn after the tokens
    from the same generator), each run with its launch counts zeroed
    before and read after: sampled (rows 4 and 5 a token at vocab 92,553,
    an odd width whose last block is padded), greedy (nothing), ragged
    (refused); the first step's candidates and token against the plain
    top-k; a decode step at B = 3 and B = 4 from one cache (rows 0-2
    bit-equal); the smoke config in float32 on the card against the CPU;
    the prefill of 4 x 384 positions beside its tensor-core floor and the
    decode profile beside the step's weight-read floor."""
    import numpy as np
    import torch

    import repro_torch.models.transformer as TR
    from repro_torch import topk
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import decode_step, init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.sample import canonical_token, categorical, gumbel_noise

    cfg = get_config("internvl2-26b")
    torch.cuda.synchronize()
    log(f"  before init: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    emb = params["embed"]["emb"]
    emb_bytes = emb.numel() * emb.element_size()
    pw = params["patch_proj"]["w"]
    step_bytes = nbytes - emb_bytes - pw.numel() * pw.element_size()  # B rows, no patches
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.frontend_len} patches of {cfg.frontend_dim}: {n_params / 1e9:.3f} B parameters, "
        f"{nbytes / 1e9:.2f} GB of weights, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, init {time.perf_counter() - t0:.1f} s; {card}")
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  weight-read floor of a decode step (no embedding table, no patch_proj): "
        f"{step_bytes / 1e9:.2f} GB = {floor_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    rng = np.random.default_rng(0)  # phase 3a's prompts, then the launcher's patches
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    patches = rng.standard_normal((bsz, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    lens = np.random.default_rng(1).integers(1, plen + 1, bsz).astype(np.int32)
    off = cfg.frontend_len
    # the prefill's products: every non-embedding weight once a position
    # (the patch projection on the patches, the head on the last position)
    # and the causal attention's two products, at the bf16 peak
    s_all = off + plen
    head = params["lm_head"]["w"].numel()
    stack = n_params - emb.numel() - head - params["patch_proj"]["w"].numel()
    pf_flop = (2 * stack * bsz * s_all + 2 * params["patch_proj"]["w"].numel() * bsz * off
               + 2 * head * bsz + cfg.n_layers * bsz * 2 * s_all * s_all * cfg.n_heads
               * cfg.head_dim)
    log(f"  prefill of {bsz} x {s_all} positions: {pf_flop / 1e12:.2f} TFLOP, floor "
        f"{pf_flop / BF16_FLOP_PER_S * 1e3:.2f} ms at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s")

    batch = {"tokens": tokens, "patches": patches}
    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0, time_steps=True)
    blk = topk_block(cfg.vocab_size, k)
    tree = K.vocab_merge_launches(cfg.vocab_size, blk, k)
    runs = (
        ("sampled", lambda: generate(params, batch, cfg, sc, device=dev),
         {"vocab_phase1": new, "vocab_merge_level": new * tree}),
        ("greedy", lambda: generate(params, batch, cfg, dataclasses.replace(sc, temperature=0.0),
                                    device=dev), {}),
    )
    outs, launches = {}, {n: 0 for n in K.LAUNCHES}
    for name, run, want in runs:
        want = {**{n: 0 for n in K.LAUNCHES}, **want}
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  launches, {name} run: { {n: c for n, c in got.items() if c} } "
            f"(expected { {n: c for n, c in want.items() if c} })")
        if got != want:
            raise AssertionError(f"{cfg.name} {name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
        o = outs[name]
        t = o["tokens"]
        if t.shape != (bsz, new) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name} {name} run gave tokens {t.shape} outside the "
                                 "vocab")
        log(f"  {name}: prefill {o['prefill_s'] * 1e3:.2f} ms (floor "
            f"{pf_flop / BF16_FLOP_PER_S * 1e3:.2f}), decode step p50 "
            f"{o['decode_step_p50_us'] / 1e3:.3f} ms p99 {o['decode_step_p99_us'] / 1e3:.3f} ms "
            f"(floor {floor_ms:.3f}), {o['tok_per_s']:.2f} tok/s; first tokens "
            f"{t[0, :6].tolist()}; {card}")
    ragged = tokens.copy()
    for r, n in enumerate(lens):
        ragged[r, n:] = 0
    K.reset_launch_counts()
    try:
        generate(params, {**batch, "tokens": ragged, "lengths": lens}, cfg, sc, device=dev)
    except ValueError as exc:
        log(f"  ragged prompts refused: {exc}")
    else:
        raise AssertionError(f"{cfg.name}: ragged prompts were served")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"{cfg.name}: the refused ragged run launched {dict(K.LAUNCHES)}")

    pt = torch.from_numpy(patches).to(dev)
    with torch.inference_mode():
        toks = torch.from_numpy(tokens).to(dev)
        lg, cache = prefill(params, {"tokens": toks, "patches": pt},
                            init_cache(cfg, bsz, s_all + 1, dev), cfg)
        if lg.shape != (bsz, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{cfg.name}: prefill logits not finite of shape (B, V)")
        got = topk(lg, k)
        want_tk = K.vocab_topk_plain(lg, k, blk)
        require_equal(f"{cfg.name}: first-step candidates at vocab {cfg.vocab_size}", got,
                      want_tk)
        noise = gumbel_noise((bsz, k), generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        tok_k = canonical_token(lg, got[0], categorical(got[0].float() / temp, gumbel=noise))
        tok_p = canonical_token(lg, want_tk[0],
                                categorical(want_tk[0].float() / temp, gumbel=noise))
        if not torch.equal(tok_k, tok_p) or not np.array_equal(
                tok_k.cpu().numpy(), outs["sampled"]["tokens"][:, 0]):
            raise AssertionError(f"{cfg.name}: first token differs between the kernel, the "
                                 "plain top-k and the sampled run")
        log(f"  first step: candidates bit-equal to the plain top-k (block {blk}, "
            f"{K.vocab_levels(cfg.vocab_size, blk)} merge levels in {tree} launches), token "
            f"{tok_k.tolist()} the sampled run's")
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        if not np.array_equal(nxt[:, 0].cpu().numpy(), outs["greedy"]["tokens"][:, 0]):
            raise AssertionError(f"{cfg.name}: first token is not the greedy run's")
        pos = torch.full((bsz, 1), s_all, dtype=torch.int32, device=dev)
        dl4, _ = decode_step(params, nxt, _rows_of(cache, bsz), cfg, positions=pos)
        dl3, _ = decode_step(params, nxt[:3], _rows_of(cache, 3), cfg, positions=pos[:3])
        if not bool(torch.isfinite(dl4).all()):
            raise AssertionError(f"{cfg.name}: decode logits not finite")
        if not torch.equal(bits(dl3), bits(dl4[:3])):
            raise AssertionError(f"{cfg.name} decode at B = 3 and B = 4: rows 0-2 differ")
        # the greedy run's second token is the argmax of this step
        if not np.array_equal(torch.argmax(dl4, -1).cpu().numpy(),
                              outs["greedy"]["tokens"][:, 1]):
            raise AssertionError(f"{cfg.name}: the decode step at position {s_all} is not the "
                                 "greedy run's second step")
        log(f"  decode step at position {s_all} (after the patches): its argmax the greedy "
            "run's second tokens; B = 3 and B = 4 from one cache: rows 0-2 bit-equal")
        del lg, cache, dl3, dl4

    with torch.inference_mode():
        kernels, busy, wall = device_busy(lambda: prefill(
            params, {"tokens": toks, "patches": pt}, init_cache(cfg, bsz, s_all, dev), cfg))
    log(f"  prefill {bsz} x {s_all} profiled: {kernels:.0f} kernels, device busy {busy:.3f} ms "
        f"of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f}), floor "
        f"{pf_flop / BF16_FLOP_PER_S * 1e3:.2f} ms ({busy / (pf_flop / BF16_FLOP_PER_S * 1e3):.2f}"
        f"x); {card}")

    # a small input against the CPU: the smoke config in float32
    small = dataclasses.replace(get_smoke_config("internvl2-26b"), dtype="float32")
    p_gpu = model_init(torch.Generator(device=dev).manual_seed(1), small, dev)
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    stoks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 24)).astype(np.int32))
    spt = torch.from_numpy(rng.standard_normal((2, small.frontend_len, small.frontend_dim))
                           .astype(np.float32))
    n = small.frontend_len + 24
    p1 = torch.full((2, 1), n, dtype=torch.int32)
    with torch.inference_mode():
        lg, c = prefill(p_gpu, {"tokens": stoks.to(dev), "patches": spt.to(dev)},
                        init_cache(small, 2, n + 1, dev), small)
        dg, _ = decode_step(p_gpu, stoks[:, :1].to(dev), c, small, positions=p1.to(dev))
        lc, c = prefill(p_cpu, {"tokens": stoks, "patches": spt}, init_cache(small, 2, n + 1,
                                                                            "cpu"), small)
        dc, _ = decode_step(p_cpu, stoks[:, :1], c, small, positions=p1)
    diff = max(float((lg.cpu() - lc).abs().max()), float((dg.cpu() - dc).abs().max()))
    if not diff <= 1e-4:
        raise AssertionError(f"{small.name}: logits on the card differ from the CPU by {diff}")
    log(f"  {small.name} f32: card vs CPU prefill (with patches) and decode logits max |diff| "
        f"{diff:.2e} (<= 1e-4)")

    ranges = profile_serve(dev, params, cfg, card, spans=((TR, "attn_apply", "attention"),),
                           patches=pt)
    for label, (calls, dev_ms, host_ms) in sorted(ranges.items()):
        log(f"    {label}: {calls:.0f} calls a step, device {dev_ms:.3f} ms, host "
            f"{host_ms:.3f} ms a step; {card}")
    log(f"    the step's weight-read floor {floor_ms:.3f} ms; {card}")
    return launches


def phase_audio(dev, K, card) -> None:
    """Phase 3m: hubert-xlarge (the audio encoder: 48 non-causal layers,
    d_model 1280, 16 heads of 80, a gelu MLP of 5120, 504 classes; frames
    of 512 through ``frontend``) at its published width and depth, random
    bf16 weights from seed 0: ``forward`` and ``loss_fn`` on 4 x 1,000
    frames (20 s of audio at 50 frames a second), logits finite of shape
    (4, 1000, 504); the first layer in float32 against its bf16 run; the
    smoke config in float32 on the card against the CPU; the forward's
    device time beside its floor; ``generate``, ``init_cache`` and the
    launcher refuse it. No LOMS kernel runs here (no sampler: the counts
    must stay 0)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import forward, init_cache, loss_fn, model_init
    from repro_torch.serving import ServeConfig, generate

    cfg = get_config("hubert-xlarge")
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers (causal={cfg.causal}), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.mlp_act} d_ff {cfg.d_ff}, "
        f"{cfg.vocab_size} classes, frames of {cfg.frontend_dim}: {n_params / 1e9:.3f} B "
        f"parameters, {nbytes / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s; {card}")
    rng = np.random.default_rng(0)
    bsz, frames = 4, 1000
    x = torch.from_numpy(rng.standard_normal((bsz, frames, cfg.frontend_dim))
                         .astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (bsz, frames)).astype(np.int32)
                           ).to(dev)
    mask = torch.from_numpy((rng.random((bsz, frames)) < 0.8).astype(np.float32)).to(dev)
    flop = 2 * n_params * bsz * frames + cfg.n_layers * bsz * 4 * frames * frames * cfg.d_model
    floor = flop / BF16_FLOP_PER_S * 1e3
    K.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = forward(params, {"frames": x}, cfg)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if logits.shape != (bsz, frames, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)} not finite of shape "
                                 f"({bsz}, {frames}, {cfg.vocab_size})")
        loss = float(loss_fn(params, {"frames": x, "targets": tgt}, cfg))
        mloss = float(loss_fn(params, {"frames": x, "targets": tgt, "mask": mask}, cfg))
    torch.cuda.synchronize()
    if not (np.isfinite(loss) and np.isfinite(mloss)) or abs(loss - np.log(cfg.vocab_size)) > 3:
        raise AssertionError(f"{cfg.name}: loss {loss}, masked {mloss}: not finite near "
                             f"log(V) = {np.log(cfg.vocab_size):.3f}")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"{cfg.name}: the encoder launched {dict(K.LAUNCHES)}")
    log(f"  forward {bsz} x {frames} frames: logits {tuple(logits.shape)} finite, {t_fwd * 1e3:.2f}"
        f" ms wall (first call); loss {loss:.4f}, masked {mloss:.4f} (log V "
        f"{np.log(cfg.vocab_size):.4f}); no LOMS kernel launched (an encoder samples nothing)")
    with torch.inference_mode():
        kernels, busy, wall = device_busy(lambda: forward(params, {"frames": x}, cfg))
    log(f"  forward profiled: {kernels:.0f} kernels, device busy {busy:.3f} ms of {wall:.3f} ms "
        f"wall (idle share {1 - busy / wall:.3f}); floor {flop / 1e12:.2f} TFLOP = {floor:.2f} ms "
        f"at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s ({busy / floor:.2f}x); {card}")

    # the first layer in float32 against the same layer in bf16
    p1, c1 = first_layer_f32(params, cfg)
    pb = {k: v for k, v in params.items() if k != "stack"}
    pb["stack"] = {"body": params["stack"]["body"][:1]}
    with torch.inference_mode():
        lf = forward(p1, {"frames": x}, c1)
        lb = forward(pb, {"frames": x}, dataclasses.replace(cfg, n_layers=1)).float()
    rel = float((lf - lb).abs().max() / lf.abs().max())
    if not rel <= 0.05:
        raise AssertionError(f"{cfg.name} first layer: bf16 differs from float32 by {rel:.3e} "
                             "of the largest logit")
    log(f"  first layer, bf16 vs float32 logits: largest difference / largest logit {rel:.3e} "
        f"(<= 0.05); {card}")
    del lf, lb, p1, pb, logits

    small = dataclasses.replace(get_smoke_config("hubert-xlarge"), dtype="float32")
    p_gpu = model_init(torch.Generator(device=dev).manual_seed(1), small, dev)
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    sx = torch.from_numpy(rng.standard_normal((2, 64, small.frontend_dim)).astype(np.float32))
    st = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 64)).astype(np.int32))
    with torch.inference_mode():
        g = forward(p_gpu, {"frames": sx.to(dev)}, small)
        c = forward(p_cpu, {"frames": sx}, small)
        gl = float(loss_fn(p_gpu, {"frames": sx.to(dev), "targets": st.to(dev)}, small))
        cl = float(loss_fn(p_cpu, {"frames": sx, "targets": st}, small))
    diff = max(float((g.cpu() - c).abs().max()), abs(gl - cl))
    if not diff <= 1e-4:
        raise AssertionError(f"{small.name}: the card differs from the CPU by {diff}")
    log(f"  {small.name} f32: card vs CPU forward logits and loss max |diff| {diff:.2e} "
        "(<= 1e-4)")

    refused = []
    for what, fn, exc in (
            ("init_cache", lambda: init_cache(cfg, bsz, 8, dev), ValueError),
            ("generate", lambda: generate(params, {"tokens": np.zeros((bsz, 4), np.int32)},
                                          cfg, ServeConfig(), device=dev), ValueError),
            ("the launcher", lambda: launcher.main(["--arch", cfg.name, "--device", str(dev)]),
             AssertionError)):
        try:
            fn()
        except exc as e:
            refused.append(f"{what} ({e})")
        else:
            raise AssertionError(f"{cfg.name}: {what} did not refuse an encoder")
    log("  refused: " + "; ".join(refused))
    del params


def phase_obs(dev, K) -> dict:
    """Phase 3n: the telemetry layer (``repro_torch.obs``) on the card. With
    obs on: the launcher at smoke width (sampled: the router kernel, row
    3), the ``--engine`` smoke drain (row 6 a tick), ``segment_topk`` at
    3d's re-rank shape (row 6), the values-only sort spill of 3e (rows 6
    and 9) and ``autotune_topk`` into a temporary cache (row 3), each
    launch counted; the spans each must record, ``serve.tokens`` and
    ``sched.completed``, ``segmented.class_launches`` and
    ``grid_merge.launches`` equal to the port's own launch counts over the
    same calls; a Chrome trace (valid), a Prometheus file and a recorder
    dump (holding the tournament) written to a temporary directory; one
    profiled ``generate`` showing the ``serve.decode`` range. Then obs off
    and cleared: one call again, the snapshot empty and the launches and
    results those of the obs-on call."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    import repro_torch.obs as obs
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.streaming import cache as C
    from repro_torch.streaming import planner as P

    bsz, plen, new, k, temp = 4, 32, 16, 64, 0.8
    smoke = ["--arch", "qwen3-8b", "--smoke", "--batch", str(bsz), "--prompt-len", str(plen),
             "--new-tokens", str(new), "--top-k", str(k), "--temperature", str(temp),
             "--device", str(dev)]
    nq, nc, kq = 4096, 1024, 64
    scores = seg_tile(nq, nc, torch.bfloat16, dev, seed=9).reshape(-1)
    q_offs = tuple(range(0, (nq + 1) * nc, nc))
    n_seg, seg_len = 16, 65_536
    v8 = seg_tile(1, n_seg * seg_len, torch.float32, dev, seed=11).reshape(-1)
    offs8 = tuple(range(0, n_seg * seg_len + 1, seg_len))

    def seg_call():
        return repro_torch.segment_topk(scores, q_offs, kq)

    def clear():
        obs.trace.clear()
        obs.metrics.reset()
        obs.recorder.clear()

    tmp = tempfile.TemporaryDirectory(prefix="obs_")
    prev_cache = C.set_default_cache(C.AutotuneCache(os.path.join(tmp.name, "autotune.json")))
    prev = obs.set_enabled(True)
    clear()
    try:
        K.reset_launch_counts()
        served = launcher.main(smoke)
        drained = launcher.main(smoke + ["--engine"])
        seg_on = seg_call()
        repro_torch.segment_sort(v8, offs8)
        tuned = P.autotune_topk(256, 16, device=dev, batch=4096)
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        snap = obs.snapshot()
        names = {sp["name"] for sp in snap["spans"]}
        need = {"serve.prefill", "serve.decode", "sched.prefill", "sched.decode", "plan",
                "plan_op", "autotune.topk", "request", "req.queue_wait", "req.prefill",
                "req.insert", "req.decode"}
        if need - names:
            raise AssertionError(f"obs: spans missing: {sorted(need - names)}")
        m = obs.metrics
        checks = {
            "serve.tokens": (m.counter("serve.tokens").total(), bsz * new),
            "sched.completed": (m.counter("sched.completed").total(), len(drained["tokens"])),
            "segmented.class_launches": (m.counter("segmented.class_launches").total(),
                                         got["seg_sort"] + got["seg_merge"]),
            "grid_merge.launches": (m.counter("grid_merge.launches").total(),
                                    got["grid_merge2"]),
        }
        log(f"  launches with obs on: { {n: c for n, c in got.items() if c} }")
        for name, (have, want) in checks.items():
            log(f"  {name} = {have:.0f} (want {want})")
            if have != want:
                raise AssertionError(f"obs: {name} = {have}, not {want}")
        if not got["router_topk"] or not got["seg_sort"] or not got["grid_merge2"]:
            raise AssertionError(f"obs: a kernel of the path did not launch: {got}")
        if served["tokens"].shape != (bsz, new):
            raise AssertionError("obs: the launcher's tokens are not (B, new)")
        falls = obs.request_waterfalls(snap)
        if len(falls) != len(drained["tokens"]) or any(w["unaccounted_ns"] < 0 for w in falls):
            raise AssertionError(f"obs: request waterfalls {len(falls)} do not reconcile")
        paths = {n: os.path.join(tmp.name, n) for n in ("trace.json", "metrics.prom",
                                                        "flight.jsonl")}
        obs.write_chrome_trace(paths["trace.json"], snap)
        obs.write_prom(paths["metrics.prom"], snap)
        obs.recorder.dump(paths["flight.jsonl"])
        with open(paths["trace.json"]) as f:
            errs = obs.validate_chrome_trace(json.load(f))
        if errs:
            raise AssertionError(f"obs: the Chrome trace is invalid: {errs[:5]}")
        with open(paths["flight.jsonl"]) as f:
            events = [json.loads(ln) for ln in f]
        if not any(ev.get("kind") == "tournament" for ev in events):
            raise AssertionError("obs: the recorder dump holds no tournament event")
        prom = open(paths["metrics.prom"]).read()
        if "repro_serve_tokens_total" not in prom or "repro_sched_ttft_s_count" not in prom:
            raise AssertionError("obs: the Prometheus file lacks the serve / sched series")
        log(f"  spans {len(snap['spans'])} ({len(names)} names), metrics "
            f"{len(snap['metrics'])}, events {len(events) - 1}: Chrome trace valid "
            f"({os.path.getsize(paths['trace.json'])} bytes), Prometheus "
            f"{prom.count(chr(10))} lines, dump with the tournament "
            f"({tuned.block} won at {tuned.us:.2f} us); {len(falls)} request waterfalls "
            f"reconcile (TTFT p50 "
            f"{np.median([w['ttft_us'] for w in falls]) / 1e3:.3f} ms); meta "
            f"{ {k: snap['meta'][k] for k in ('platform', 'torch', 'cuda', 'device')} }")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            launcher.main(smoke)
            torch.cuda.synchronize()
        keys = {ev.key for ev in prof.key_averages()}
        if not {"serve.decode", "serve.prefill"} <= keys:
            raise AssertionError("obs: the profiled generate shows no serve.decode range")
        log("  profiled generate: the serve.prefill and serve.decode ranges are in the trace")

        K.reset_launch_counts()
        seg_on = seg_call()
        torch.cuda.synchronize()
        on_launches = dict(K.LAUNCHES)
        obs.set_enabled(False)
        clear()
        K.reset_launch_counts()
        seg_off = seg_call()
        torch.cuda.synchronize()
        off_launches = dict(K.LAUNCHES)
        after = obs.snapshot()
        if after["spans"] or after["events"] or any(
                mm["series"] for mm in after["metrics"].values()):
            raise AssertionError("obs off: the snapshot is not empty")
        if off_launches != on_launches:
            raise AssertionError(f"obs off: launches {off_launches} != obs on {on_launches}")
        for a, b in zip(seg_on[:2], seg_off[:2]):
            if not torch.equal(bits(a) if a.dtype.is_floating_point else a,
                               bits(b) if b.dtype.is_floating_point else b):
                raise AssertionError("obs off: segment_topk differs from the obs-on call")
        log(f"  obs off: snapshot empty, segment_topk bit-equal and its launches "
            f"{ {n: c for n, c in off_launches.items() if c} } those of the obs-on call")
    finally:
        obs.set_enabled(prev)
        clear()
        C.set_default_cache(prev_cache)
        tmp.cleanup()
    for n, c in on_launches.items():
        got[n] += c
    return got


#: phase 3o's dense configs in order; chatglm3-6b last, so that 3p reuses its weights
DENSE_ARCHS = ("qwen1.5-32b", "deepseek-coder-33b", "chatglm3-6b")


def phase_dense(dev, K, card, arch: str) -> tuple:
    """Phase 3o: one dense config at its published width and depth, random
    bf16 weights from seed 0, through 3a's recipe: ``generate`` on 3a's
    prompts sampled (rows 4 and 5 a token) and greedy (nothing), each with
    its launch counts zeroed before and read after; the first step's
    candidates against the plain top-k and the token against the sampled
    run's; a decode step at B = 3 and B = 4 from one cache (rows 0-2
    bit-equal) whose argmax is the greedy run's second token; the
    parameters, their bytes, the KV cache a token, the peak memory and the
    step's weight-read floor beside the decode profile. Returns
    ``(launches, params, cfg, sampled run)``."""
    import numpy as np
    import torch

    from repro_torch import topk
    from repro_torch.api import topk_block
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.sample import canonical_token, categorical, gumbel_noise

    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"  {cfg.name}: before init {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    emb = params["embed"]["emb"]
    step_bytes = nbytes - emb.numel() * emb.element_size()  # the table is gathered, not read
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    kv = sum(t.numel() * t.element_size() for t in _leaves(init_cache(cfg, 1, 1, dev)))
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f"{', qkv bias' if cfg.qkv_bias else ''}, rope fraction {cfg.rope_fraction}: "
        f"{n_params / 1e9:.3f} B parameters (params_billions {cfg.params_billions():.3f}), "
        f"{nbytes / 1e9:.2f} GB of weights, init {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; KV cache {kv / 1e6:.4f} MB a "
        f"token (incl. its position); {card}")
    log(f"  weight-read floor of a decode step (all but the embedding table): "
        f"{step_bytes / 1e9:.2f} GB = {floor_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    rng = np.random.default_rng(0)  # phase 3a's prompts
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0, time_steps=True)
    blk = topk_block(cfg.vocab_size, k)
    tree = K.vocab_merge_launches(cfg.vocab_size, blk, k)
    if tree > 2:
        raise AssertionError(f"{cfg.name}: the merge tree takes {tree} launches a call")
    runs = (
        ("sampled", lambda: generate(params, {"tokens": tokens}, cfg, sc, device=dev),
         {"vocab_phase1": new, "vocab_merge_level": new * tree}),
        ("greedy", lambda: generate(params, {"tokens": tokens}, cfg,
                                    dataclasses.replace(sc, temperature=0.0), device=dev), {}),
    )
    outs, launches = {}, {n: 0 for n in K.LAUNCHES}
    for name, run, want in runs:
        want = {**{n: 0 for n in K.LAUNCHES}, **want}
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        if got != want:
            raise AssertionError(f"{cfg.name} {name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
        o = outs[name]
        t = o["tokens"]
        if t.shape != (bsz, new) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name} {name} run gave tokens outside the vocab")
        log(f"  {name}: launches { {n: c for n, c in got.items() if c} }; prefill "
            f"{o['prefill_s'] * 1e3:.2f} ms, decode step p50 {o['decode_step_p50_us'] / 1e3:.3f} "
            f"ms p99 {o['decode_step_p99_us'] / 1e3:.3f} ms (floor {floor_ms:.3f}), "
            f"{o['tok_per_s']:.2f} tok/s; first tokens {t[0, :6].tolist()}; {card}")

    with torch.inference_mode():
        toks = torch.from_numpy(tokens).to(dev)
        lg, cache = prefill(params, {"tokens": toks}, init_cache(cfg, bsz, plen + 1, dev), cfg)
        if lg.shape != (bsz, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{cfg.name}: prefill logits not finite of shape (B, V)")
        got = topk(lg, k)
        want_tk = K.vocab_topk_plain(lg, k, blk)
        require_equal(f"{cfg.name}: first-step candidates at vocab {cfg.vocab_size}", got,
                      want_tk)
        noise = gumbel_noise((bsz, k), generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        tok_k = canonical_token(lg, got[0], categorical(got[0].float() / temp, gumbel=noise))
        tok_p = canonical_token(lg, want_tk[0],
                                categorical(want_tk[0].float() / temp, gumbel=noise))
        if not torch.equal(tok_k, tok_p) or not np.array_equal(
                tok_k.cpu().numpy(), outs["sampled"]["tokens"][:, 0]):
            raise AssertionError(f"{cfg.name}: first token differs between the kernel, the "
                                 "plain top-k and the sampled run")
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        if not np.array_equal(nxt[:, 0].cpu().numpy(), outs["greedy"]["tokens"][:, 0]):
            raise AssertionError(f"{cfg.name}: first token is not the greedy run's")
        pos = torch.full((bsz, 1), plen, dtype=torch.int32, device=dev)
        dl4, _ = decode_step(params, nxt, _rows_of(cache, bsz), cfg, positions=pos)
        dl3, _ = decode_step(params, nxt[:3], _rows_of(cache, 3), cfg, positions=pos[:3])
        if not bool(torch.isfinite(dl4).all()):
            raise AssertionError(f"{cfg.name}: decode logits not finite")
        if not torch.equal(bits(dl3), bits(dl4[:3])):
            raise AssertionError(f"{cfg.name} decode at B = 3 and B = 4: rows 0-2 differ")
        if not np.array_equal(torch.argmax(dl4, -1).cpu().numpy(),
                              outs["greedy"]["tokens"][:, 1]):
            raise AssertionError(f"{cfg.name}: the decode step is not the greedy run's second")
        log(f"  first step: candidates bit-equal to the plain top-k (block {blk}, "
            f"{K.vocab_levels(cfg.vocab_size, blk)} merge levels in {tree} launches), token "
            f"{tok_k.tolist()} the sampled run's; decode at B = 3 and B = 4 from one cache: "
            "rows 0-2 bit-equal, its argmax the greedy run's second tokens")
        del lg, cache, dl3, dl4
    profile_serve(dev, params, cfg, card)
    log(f"    the step's weight-read floor {floor_ms:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    return launches, params, cfg, outs["sampled"]


#: the tie-order findings of ``tests/test_torch_resilience.py`` (tied bf16
#: rows, seed 0): per op, the rung each arming makes the ladder answer
#: from, and the rungs grouped by equal tie order
_TIE_F, _TIE_K, _TIE_E = ({"fused.launch": "always"}, {"kernel.launch": "always"},
                          {"executor.run": "always"})
TIE_LADDERS = {
    "sort+payload": {"fused": {}, "schedule": _TIE_F, "lax": {**_TIE_F, **_TIE_E}},
    "topk": {"fused": {}, "cuda": _TIE_F, "schedule": {**_TIE_F, **_TIE_K},
             "lax": {**_TIE_F, **_TIE_K, **_TIE_E}},
    "merge+payload": {"fused": {}, "schedule": _TIE_F, "lax": {**_TIE_F, **_TIE_E}},
    "merge_k+payload": {"fused": {}, "schedule": _TIE_F, "lax": {**_TIE_F, **_TIE_E}},
}
TIE_GROUPS = {
    "sort+payload": [["fused", "lax"], ["schedule"]],
    "topk": [["fused", "cuda"], ["schedule"], ["lax"]],
    "merge+payload": [["fused"], ["schedule"], ["lax"]],
    "merge_k+payload": [["fused", "schedule"], ["lax"]],
}
_TIE_POOL = (-1.5, -0.0, 0.0, 0.5, 2.0, float("inf"), float("-inf"), float("nan"))
_TIE_RANK = (1, 2, 3, 4, 5, 6, 0, 7)  # each pool value's place in the key order


def tie_rows(rng, shape, sort=False):
    """The test's tied bf16 rows: eight values, ±0.0, ±inf and NaN among
    them; ``sort``: ascending in the total key order."""
    import numpy as np
    import torch

    idx = rng.integers(0, len(_TIE_POOL), shape)
    if sort:
        idx = np.take_along_axis(idx, np.argsort(np.asarray(_TIE_RANK)[idx], axis=-1,
                                                 kind="stable"), -1)
    return torch.from_numpy(np.asarray(_TIE_POOL, np.float32)[idx]).to(torch.bfloat16)


def same_values(a, b) -> bool:
    """Bit-equal, a NaN matching any NaN (its bits are the route's)."""
    import torch

    a, b = a.float().cpu(), b.float().cpu()
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                                    b[~nb].view(torch.int32)))


def tie_order_walk(device) -> dict:
    """Each op of the tie-order table on ``device``: the answer of every
    rung the ladder reaches under the table's armings, the rungs that
    failed checked from the breakers. Returns op -> rung -> (values,
    order)."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.resilience import breaker_states, failpoints, reset_breakers

    rng = np.random.default_rng(0)
    x = tie_rows(rng, (4, 64)).to(device)
    a, b, c = (tie_rows(rng, (4, 32), sort=True).to(device) for _ in range(3))
    tp = torch.arange(4 * 96, dtype=torch.int32, device=device).reshape(4, 96)
    calls = {
        "sort+payload": lambda: repro_torch.sort(x, payload=tp[:, :64]),
        "topk": lambda: repro_torch.topk(x, 16),
        "merge+payload": lambda: repro_torch.merge(a, b, payload=(tp[:, :32], tp[:, 32:64])),
        "merge_k+payload": lambda: repro_torch.merge_k(
            [a, b, c], payload=[tp[:, :32], tp[:, 32:64], tp[:, 64:]]),
    }
    out = {}
    for op, ladder in TIE_LADDERS.items():
        out[op] = {}
        order = list(ladder)
        for rung, armed in ladder.items():
            reset_breakers()
            with failpoints(armed):
                out[op][rung] = tuple(t.cpu() for t in calls[op]())
            failed = {r for _, r, _ in breaker_states()}
            if failed != set(order[:order.index(rung)]):
                raise AssertionError(f"tie order {op}: the {rung} arming failed {failed}")
        reset_breakers()
    return out


def tie_groups(answers) -> list:
    """The rungs grouped by equal tie order; raises if a value differs."""
    import torch

    first = next(iter(answers.values()))
    groups = []
    for rung, (vals, order) in answers.items():
        if not same_values(vals, first[0]):
            raise AssertionError(f"the {rung} rung's values differ from the fused rung's")
        for g in groups:
            if torch.equal(answers[g[0]][1], order):
                g.append(rung)
                break
        else:
            groups.append([rung])
    return groups


def drain_invariants(eng, name: str) -> None:
    """Every request terminal, the queue empty, no slot or page held."""
    from repro_torch.serving.scheduler import TERMINAL_STATES

    bad = {rid: r.state.value for rid, r in eng.requests.items()
           if r.state not in TERMINAL_STATES}
    if bad or len(eng.queue) or eng.active:
        raise AssertionError(f"{name}: the drain left {bad}, queue {len(eng.queue)}, "
                             f"active {list(eng.active)}")
    if (eng.slots.free_slot_count != eng.sc.n_slots
            or eng.slots.free_page_count != eng.pool.n_pages - 1):
        raise AssertionError(f"{name}: leaked slots or pages ({eng.slots.free_slot_count} of "
                             f"{eng.sc.n_slots} slots, {eng.slots.free_page_count} of "
                             f"{eng.pool.n_pages - 1} pages free)")


def phase_resilience(dev, K, card, params, cfg, sampled) -> dict:
    """Phase 3p: the resilience layer at full width on chatglm3-6b (3o's
    weights), obs on for its counters. (a) Phase 3b's six staggered
    requests drained by ``ScheduledEngine``: fault-free, then under
    ``sched.prefill`` / ``insert`` / ``decode`` armed once each and under
    a seeded ``p:0.2:7`` on ``sched`` (every stream bit-equal to the
    fault-free drain, ``sched.retries`` counting the fires), then under a
    persistent ``sched.decode`` (the decoding requests FAILED, the drain
    whole, nothing leaked). (b) ``generate`` with ``fused.launch.topk``
    armed: the unfused cuda rung answers with the same kernels, three
    fallbacks open the fused rung's breaker, the tokens are 3o's; with
    ``kernel.launch.topk`` armed too the schedule executor answers and the
    plan reroutes (``source="breaker"``), the tokens those of a
    fault-free run. (c) 3e's merge and sort at their users' sizes with
    ``kernel.launch`` and ``fused.launch`` armed: the values the healthy
    call's, the tie order the answering rung's (its explicit ask's);
    every seam armed ``off``: the same results and launches; the
    tie-order table on the card against the CPU. (d) Breakers and
    failpoints reset."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import obs
    from repro_torch.api import topk_block
    from repro_torch.obs import metrics, recorder, trace
    from repro_torch.resilience import (breaker_states, failpoints, fires, reset_breakers,
                                        reset_failpoints)
    from repro_torch.serving import ServeConfig, generate
    from repro_torch.serving.scheduler import SamplingParams, ScheduledEngine, SchedulerConfig

    launches = {n: 0 for n in K.LAUNCHES}

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        for n, c in got.items():
            launches[n] += c
        return out, got

    prev = obs.set_enabled(True)
    trace.clear()
    metrics.reset()
    recorder.clear()
    try:
        # (a) the scheduler under faults
        t_a = time.perf_counter()
        vocab = cfg.vocab_size
        plens, arrivals = (128, 77, 128, 33, 100, 5), (0, 0, 1, 2, 4, 6)
        sps = [SamplingParams(k=64, temperature=0.8, seed=11),
               SamplingParams(k=16, temperature=1.0, seed=12),
               SamplingParams(k=256, temperature=0.7, top_p=0.9, seed=13),
               SamplingParams(temperature=0.0, seed=14),
               SamplingParams(k=64, temperature=0.8, top_p=0.95, max_new_tokens=1, seed=15),
               SamplingParams(k=64, temperature=0.8, max_new_tokens=8, seed=16)]
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in plens]

        def drain(name, armed, **kw):
            sc = SchedulerConfig(n_slots=4, page_size=16, pages_per_slot=9,
                                 retry_backoff_s=0.0, **kw)
            eng = ScheduledEngine(params, cfg, sc, device=dev)
            rids = [eng.submit(p, sp, arrival=a) for p, sp, a in zip(prompts, sps, arrivals)]
            metrics.reset()
            t0 = time.perf_counter()
            with failpoints(armed):
                out, got = counted(eng.run)
                fired = {n: fires(n) for n in armed}
            wall = time.perf_counter() - t0
            drain_invariants(eng, name)
            retries = {w: int(metrics.counter("sched.retries").value(what=w))
                       for w in ("prefill", "insert", "decode")}
            states = [eng.requests[r].state.value for r in rids]
            log(f"  {name}: {wall:.3f} s, states {states}, fired {fired}, sched.retries "
                f"{retries}, launches { {n: c for n, c in got.items() if c} }")
            return [out.get(r) for r in rids], states, fired, retries

        clean, states, _, _ = drain("fault-free drain", {})
        if set(states) != {"done"}:
            raise AssertionError(f"fault-free drain: states {states}")
        out, states, fired, retries = drain(
            "sched.prefill / insert / decode once each",
            {"sched.prefill": "once", "sched.insert": "once", "sched.decode": "once"})
        if set(states) != {"done"} or any(not np.array_equal(o, c) for o, c in zip(out, clean)):
            raise AssertionError("once each: a stream differs from the fault-free drain")
        if retries != {"prefill": 1, "insert": 1, "decode": 1}:
            raise AssertionError(f"once each: sched.retries {retries}")
        out, states, fired, retries = drain("sched p:0.2:7 (max_retries 30)",
                                            {"sched": "p:0.2:7"}, max_retries=30)
        if set(states) != {"done"} or any(not np.array_equal(o, c) for o, c in zip(out, clean)):
            raise AssertionError("p:0.2:7: a stream differs from the fault-free drain")
        if not fired["sched"] or sum(retries.values()) != fired["sched"]:
            raise AssertionError(f"p:0.2:7: {fired} fires, sched.retries {retries}")
        out, states, fired, retries = drain("sched.decode always (max_retries 1)",
                                            {"sched.decode": "always"}, max_retries=1)
        if not set(states) <= {"failed", "done"} or "failed" not in states:
            raise AssertionError(f"persistent decode fault: states {states}")
        for o, c, s in zip(out, clean, states):
            if s == "done" and not np.array_equal(o, c):
                raise AssertionError("persistent decode fault: a finished stream differs")
        log(f"  (a) every faulted drain whole, no slot or page leaked, every finished stream "
            f"bit-equal to the fault-free drain: {time.perf_counter() - t_a:.1f} s")

        # (b) generate with the fused top-k failing, then every kernel rung
        t_b = time.perf_counter()
        bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
        tokens = np.random.default_rng(0).integers(0, vocab, (bsz, plen)).astype(np.int32)
        sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0)
        cls = f"{1 << (vocab - 1).bit_length()}v"
        tree = K.vocab_merge_launches(vocab, topk_block(vocab, k), k)
        metrics.reset()
        with failpoints({"fused.launch.topk": "always"}):
            out, got = counted(lambda: generate(params, {"tokens": tokens}, cfg, sc, device=dev))
        fb = metrics.counter("resilience.fallbacks").value(op="topk", rung="fused", cls=cls,
                                                           err="FailpointError")
        if fb != 3 or breaker_states() != {("topk", "fused", cls): "open"}:
            raise AssertionError(f"fused top-k failing: {fb} fallbacks, {breaker_states()}")
        if not np.array_equal(out["tokens"], sampled["tokens"]):
            raise AssertionError("fused top-k failing: the tokens differ from 3o's")
        if (got["vocab_phase1"], got["vocab_merge_level"]) != (new, new * tree):
            raise AssertionError(f"fused top-k failing: launches {got}")
        log(f"  (b) fused.launch.topk always: {int(fb)} fallbacks then the breaker "
            f"{('topk', 'fused', cls)} open; the unfused cuda rung answered {new} tokens with "
            f"the same kernels ({got['vocab_phase1']} phase 1, {got['vocab_merge_level']} "
            "tree launches), the tokens 3o's")
        reset_breakers()
        sc4 = dataclasses.replace(sc, max_new_tokens=4)
        want4, _ = counted(lambda: generate(params, {"tokens": tokens}, cfg, sc4, device=dev))
        metrics.reset()
        t0 = time.perf_counter()
        with failpoints({"fused.launch.topk": "always", "kernel.launch.topk": "always"}):
            out4, got = counted(lambda: generate(params, {"tokens": tokens}, cfg, sc4,
                                                 device=dev))
        wall = time.perf_counter() - t0
        fbs = {r: metrics.counter("resilience.fallbacks").value(
            op="topk", rung=r, cls=cls, err="FailpointError") for r in ("fused", "cuda")}
        rerouted = sum(s["value"] for s in metrics.counter("plan.decisions").series()
                       if s["labels"].get("op") == "topk"
                       and s["labels"].get("source") == "breaker"
                       and s["labels"].get("backend") == "schedule")
        if fbs != {"fused": 3, "cuda": 3} or rerouted != 1 or any(got.values()):
            raise AssertionError(f"every kernel rung failing: fallbacks {fbs}, {rerouted} "
                                 f"plans rerouted, launches {got}")
        if not np.array_equal(out4["tokens"], want4["tokens"]):
            raise AssertionError("every kernel rung failing: the tokens differ")
        log(f"  (b) fused and kernel top-k always: fallbacks {fbs}, then the plan rerouted to "
            f"the schedule executor ({int(rerouted)} plan with source=breaker), no kernel "
            f"launched, {sc4.max_new_tokens} tokens equal to a fault-free run's; {wall:.2f} s; "
            f"{time.perf_counter() - t_b:.1f} s in (b)")
        reset_breakers()

        # (c) the library's merge and sort with the kernels failing
        t_c = time.perf_counter()
        a1, b1 = (total_order_sorted(seg_tile(65_536, 32, torch.float32, dev, seed=s))
                  for s in (1, 2))
        a2, b2 = (total_order_sorted(seg_tile(4096, 512, torch.float32, dev, seed=s), True)
                  for s in (3, 4))
        id2 = torch.arange(a2.numel() * 2, dtype=torch.int32, device=dev).reshape(-1, 1024)
        x4 = seg_tile(16_384, 1024, torch.bfloat16, dev, seed=7)
        p4 = torch.arange(x4.numel(), dtype=torch.int32, device=dev).reshape(x4.shape)
        x5 = seg_tile(16, 1007, torch.float32, dev, seed=8)
        cases = (
            ("merge (65536, 32 + 32) f32", lambda **kw: repro_torch.merge(a1, b1, **kw),
             "cuda"),
            ("merge (4096, 512 + 512) f32 desc + ids", lambda **kw: repro_torch.merge(
                a2, b2, descending=True, payload=(id2[:, :512], id2[:, 512:]), **kw),
             "schedule"),
            ("sort (16384, 1024) bf16 + payload",
             lambda **kw: repro_torch.sort(x4, payload=p4, **kw), "schedule"),
            ("sort (16, 1007) f32 desc", lambda **kw: repro_torch.sort(x5, descending=True,
                                                                       **kw), "schedule"),
        )
        faults = {"kernel.launch": "always", "fused.launch": "always"}
        seams = ("kernel.launch", "fused.launch", "executor.run", "grid_merge.refill",
                 "segmented.spill", "cache")
        for name, call, rung in cases:
            healthy, want_l = counted(call)
            with failpoints({s: "off" for s in seams}):
                off, got_l = counted(call)
            h, o = ((t,) if isinstance(t, torch.Tensor) else t for t in (healthy, off))
            if got_l != want_l or any(not torch.equal(bits(p) if p.dtype.is_floating_point
                                                      else p, bits(q) if q.dtype
                                                      .is_floating_point else q)
                                      for p, q in zip(h, o)):
                raise AssertionError(f"{name}: the seams armed off changed the call")
            reset_breakers()
            t0 = time.perf_counter()
            with failpoints(faults):
                deg, deg_l = counted(call)
            ms = (time.perf_counter() - t0) * 1e3
            failed = sorted(r for _, r, _ in breaker_states())
            asked, _ = counted(lambda: call(backend=rung))
            d, w = ((t,) if isinstance(t, torch.Tensor) else t for t in (deg, asked))
            if not same_values(d[0], h[0]) or any(not torch.equal(p, q)
                                                  for p, q in zip(d[1:], w[1:])):
                raise AssertionError(f"{name}: the {rung} rung's answer is not the contract's")
            log(f"  (c) {name}: healthy launches { {n: c for n, c in want_l.items() if c} }, "
                f"the same with every seam off; kernels failing: rungs {failed} failed, "
                f"{rung} answered in {ms:.1f} ms (launches "
                f"{ {n: c for n, c in deg_l.items() if c} }), values bit-equal to the "
                f"healthy call's, tie order its explicit ask's")
        reset_breakers()
        # a real error of a kernel rung on the card propagates: no plain rung answers
        import repro_torch.api.fused as fused_mod

        real_sort = fused_mod.fused_sort

        def broken_sort(*args, **kw):
            raise RuntimeError("a kernel that fails to launch")

        fused_mod.fused_sort = broken_sort
        try:
            repro_torch.sort(x5)
            raise AssertionError("a failed fused sort on the card was answered by another rung")
        except RuntimeError as e:
            if "fails to launch" not in str(e) or breaker_states():
                raise
        finally:
            fused_mod.fused_sort = real_sort
        log("  (c) a real error of the fused sort on the card propagated, no breaker made")
        card_walk, cpu_walk = tie_order_walk(dev), tie_order_walk("cpu")
        for op, answers in card_walk.items():
            groups = tie_groups(answers)
            for rung, (vals, order) in answers.items():
                cv, co = cpu_walk[op][rung]
                if not same_values(vals, cv) or not torch.equal(order, co):
                    raise AssertionError(f"tie order {op}: the {rung} rung differs from the CPU")
            if groups != TIE_GROUPS[op]:
                raise AssertionError(f"tie order {op}: groups {groups} != {TIE_GROUPS[op]}")
            log(f"  (c) tie order {op} (tied bf16 rows with ±0.0, ±inf, NaN): values the same "
                f"on every rung, tie-order groups {groups} as on the CPU, each rung bit-equal "
                "to the CPU's")
        log(f"  (c) {time.perf_counter() - t_c:.1f} s")
    finally:
        reset_failpoints()
        reset_breakers()
        trace.clear()
        metrics.reset()
        recorder.clear()
        obs.set_enabled(prev)
    return launches


#: phase 3q: the trained configs at full width and the layers each keeps.
#: The depth is the one cut. Qwen3-8B's step is timed at 4 layers (32.3 GB
#: of training state, no checkpoint). Its checkpointed run is cut further:
#: the machine that runs this script may write 45 GiB (48.3 GB) to its
#: disk in a run, freed blocks included, and the two checkpoints (steps 3
#: and 6) write 12 bytes a parameter each: 48.4 GB at 4 layers, 43.8 GB at
#: 3, 34.5 GB at 1 (the embedding and the head are 1.244 B parameters)
TRAIN_LAYERS = {"qwen3-8b": 4, "qwen3-8b checkpointed": 1, "qwen3-moe-30b-a3b": 2}
#: the smoke-width gradients on the card against the CPU's, float32: each
#: leaf's largest difference over its largest magnitude (the tolerance the
#: CPU tests hold the port's gradients to against the JAX package)
GRAD_RTOL = 1e-4
#: AdamW's bytes a parameter: read p, g, mu, nu and write p, mu, nu, float32
ADAMW_BYTES = 28
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s


def train_floor(cfg, n_params: int, emb_params: int, tokens: int, seq: int):
    """The least time of one training step, in two phases that run one
    after the other: the products at the bf16 dense peak (6 flops a
    product parameter a token: every weight but the embedding, the head
    included; plus the causal attention's two products of 2 flops a
    multiply-add over half the S x S scores, forward once and backward
    twice) and AdamW at the memory rate (``ADAMW_BYTES`` a parameter).
    Returns (flops, bytes, products ms, AdamW ms)."""
    attn = 3 * 2 * 2 * tokens * (seq / 2) * cfg.n_heads * cfg.head_dim * cfg.n_layers
    flops = 6 * (n_params - emb_params) * tokens + attn
    nbytes = ADAMW_BYTES * n_params
    return flops, nbytes, flops / BF16_PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


class _StepRecorder:
    """Wraps ``make_train_step`` while a phase runs: every step's loss and
    grad norm, its time by CUDA events and by the host's clock (both
    synchronised), and the peak memory it reached; with ``after``, also
    the loss of the step's own batch after its update (an untimed
    forward, after the step's numbers are taken)."""

    def __init__(self, TL, after: bool = False):
        self.TL, self.real, self.steps, self.after = TL, TL.make_train_step, [], after
        self.real_update, self.update_events = TL.opt_update, None

    def __enter__(self):
        import torch

        def update(*args, **kw):  # AdamW's share of the step, by CUDA events
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = self.real_update(*args, **kw)
            e1.record()
            self.update_events = (e0, e1)
            return out

        def make(*args, **kw):
            fn = self.real(*args, **kw)

            def step(params, opt_state, batch):
                from repro_torch.models import loss_fn

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                out = fn(params, opt_state, batch)
                e1.record()
                torch.cuda.synchronize()
                self.steps.append({
                    "loss": float(out[2]["loss"]), "grad_norm": float(out[2]["grad_norm"]),
                    "ms": e0.elapsed_time(e1), "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "update_ms": self.update_events[0].elapsed_time(self.update_events[1]),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
                if self.after:
                    with torch.no_grad():
                        self.steps[-1]["after"] = float(loss_fn(params, batch, args[0]))
                return out
            return step
        self.TL.make_train_step, self.TL.opt_update = make, update
        return self

    def __exit__(self, *exc):
        self.TL.make_train_step, self.TL.opt_update = self.real, self.real_update


class _CheckpointClock:
    """Times each checkpoint save (the host snapshot, then the write that
    ends with the publish and the keep-last sweep) and restore while a
    phase runs, with the bytes each wrote or read, and each restore's
    device memory: resident at its start and its peak above that."""

    def __init__(self, CM):
        self.CM, self.saves, self.restores = CM, [], []
        self.real = (CM.save, CM._gc, CM.restore)

    def __enter__(self):
        real_save, real_gc, real_restore = self.real
        clock = self

        def save(mgr, step, state, *a, **kw):
            mgr.wait()  # the write before this one ends first, as save() has it
            rec = {"step": step, "dir": mgr.dir, "t0": time.perf_counter()}
            clock.saves.append(rec)
            real_save(mgr, step, state, *a, **kw)
            rec["snapshot_s"] = time.perf_counter() - rec["t0"]

        def gc_(mgr):  # the last act of a write
            clock.saves[-1]["write_end"] = time.perf_counter()
            real_gc(mgr)

        def restore(mgr, step, template, *a, **kw):
            import torch

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real_restore(mgr, step, template, *a, **kw)
            torch.cuda.synchronize()
            clock.restores.append({
                "step": step, "s": time.perf_counter() - t0, "bytes": _dir_bytes(mgr.dir, step),
                "in_place": kw.get("in_place", False), "resident": base,
                "above": torch.cuda.max_memory_allocated() - base})
            return out
        self.CM.save, self.CM._gc, self.CM.restore = save, gc_, restore
        return self

    def __exit__(self, *exc):
        self.CM.save, self.CM._gc, self.CM.restore = self.real


def _dir_bytes(root, step) -> int:
    d = os.path.join(root, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


#: the bytes the script's own files take on disk: 3q's checkpoints (each
#: written, then removed) and the kernel builds
DISK_BYTES = {"checkpoints": 0, "builds": 0}


def _tree_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _router_ranges(real):
    """``router_topk`` inside a profiler range, and its backward (from the
    gates' gradient to the logits') inside another, opened and closed by
    gradient hooks on the autograd thread."""
    from torch.profiler import record_function

    def wrapped(logits, k, block):
        with record_function("moe.router_topk"):
            gates, ids = real(logits, k, block)
        if gates.requires_grad:
            rf = record_function("moe.router_topk.backward")

            def opened(grad):  # the gates' gradient: the router's backward starts
                rf.__enter__()

            def closed(grad):  # the logits' gradient: it ends
                rf.__exit__(None, None, None)
            gates.register_hook(opened)
            logits.register_hook(closed)
        return gates, ids
    return wrapped


def _grads_against_cpu(dev, K, card, count) -> None:
    """3q's first part: gradients on the card against the same call on
    the CPU. ``loss_fn``'s at smoke width in float32 (qwen3-8b, and
    qwen3-moe-30b-a3b with its router on the schedule executor): the loss
    and every leaf within ``GRAD_RTOL``, the router's gradient nonzero, no
    launch. ``topk``'s through the fused rung at a vocab row (4, 151936)
    and router rows (4096, 128), k = 64: the values, indices and the
    input's gradient bit-equal to the CPU's (one scatter of the same
    cotangent), its launches logged and not counted on the main paths."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import loss_fn, model_init
    from repro_torch.optim.adamw import leaves, map_tree

    def value_and_grads(params, batch, cfg):
        ps = leaves(params)
        for t in ps:
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, batch, cfg)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for t in ps:
                t.requires_grad_(False)
        return float(loss.detach()), [torch.zeros_like(t) if g is None else g
                                      for g, t in zip(gs, ps)]

    def chain(fn):  # the autograd nodes from the values down to x
        names = []
        while fn is not None:
            names.append(type(fn).__name__)
            fn = next((f for f, _ in fn.next_functions if f is not None), None)
        return names

    K.reset_launch_counts()
    for arch in ("qwen3-8b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        host = model_init(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32)
        batch = TokenPipeline(cfg, DataConfig(seq_len=64, global_batch=4, seed=0)).get_batch(0)
        l_cpu, g_cpu = value_and_grads(
            host, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
        l_dev, g_dev = value_and_grads(
            map_tree(lambda t: t.to(dev), host),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
        rel = []
        for a, b in zip(g_dev, g_cpu):
            d, m = float((a.cpu() - b).abs().max()), float(b.abs().max())
            rel.append(d / m if m > 0 else (0.0 if d == 0 else float("inf")))
        routers = [float(g.norm()) for g, t in zip(g_cpu, leaves(host)) if any(
            t is lay["ffn"]["router"]["w"] for lay in host["stack"]["body"]
            if "router" in lay["ffn"])]
        log(f"  {cfg.name} float32 loss_fn on the card against the CPU: loss {l_dev!r} vs "
            f"{l_cpu!r}; {len(rel)} gradient leaves, largest difference over the leaf's "
            f"largest magnitude {max(rel):.3e} (limit {GRAD_RTOL:g}); router gradient norms "
            f"{routers}; {card}")
        if abs(l_dev - l_cpu) > GRAD_RTOL * abs(l_cpu) or max(rel) > GRAD_RTOL:
            raise AssertionError(f"{cfg.name}: the card's gradients are not the CPU's")
        if ("moe" in arch) != bool(routers) or not all(0 < r < float("inf") for r in routers):
            raise AssertionError(f"{cfg.name}: router gradient norms {routers}")
    count("the smoke-width gradients")

    rng = np.random.default_rng(7)
    for shape in ((4, 151936), (4096, 128)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((shape[0], 64)).astype(np.float32))
        xc = x.clone().requires_grad_(True)
        vc, ic = repro_torch.topk(xc, 64)
        (vc * w).sum().backward()
        K.reset_launch_counts()
        xd = x.to(dev).requires_grad_(True)
        vd, idd = repro_torch.topk(xd, 64)
        fn = chain(vd.grad_fn)
        (vd * w.to(dev)).sum().backward()
        torch.cuda.synchronize()
        got = {n: c for n, c in K.LAUNCHES.items() if c}
        log(f"  topk(x, 64) at {shape} float32 with a gradient on the card: autograd "
            f"{' <- '.join(fn)}, "
            f"launches {got} (not counted on the main paths); values, indices and "
            f"x's gradient bit-equal to the CPU's: "
            f"{torch.equal(xd.grad.cpu(), xc.grad)}")
        if not got or "_TopKVjpBackward" not in fn:
            raise AssertionError(f"topk at {shape}: launches {got}, autograd {fn}")
        if not (torch.equal(vd.detach().cpu(), vc.detach()) and torch.equal(idd.cpu(), ic)
                and torch.equal(xd.grad.cpu(), xc.grad)):
            raise AssertionError(f"topk at {shape}: the card's values or gradient differ")
    K.reset_launch_counts()


def phase_train(dev, K, card) -> dict:
    """Phase 3q: the trainer (``repro_torch.runtime``) at full width.

    First :func:`_grads_against_cpu`. Then Qwen3-8B cut to
    ``TRAIN_LAYERS["qwen3-8b"]`` layers: six steps of the trainer's
    ``make_train_step`` with the launcher's defaults (batch 4 x 512,
    float32 master weights, AdamW warmed up over 1 of 6 steps), every
    step's update lowering the loss of its own batch (the loss of the
    next step's new batch moves by less than the batches differ); each
    step's time (CUDA events and wall), tokens per second and peak memory
    beside the step's floor (:func:`train_floor`). From the sixth step's
    state, one forward and backward each with ``remat`` none, full and
    dots: the loss bit-equal, the grad norm within 1e-3, the memory held
    after the forward full < dots < none and the peak full <= dots <=
    none. Then Qwen3-8B cut to ``TRAIN_LAYERS["qwen3-8b checkpointed"]``
    through ``train_with_retries`` (6 steps, a checkpoint every 3, a
    fault injected at step 4): the fault fires once, the second attempt
    resumes from step 3's checkpoint, restored in place (its peak within
    one leaf of the resident state), and its step-3 loss is bit-equal to
    the first attempt's; step 6's checkpoint restored into a fresh
    template is bit-equal to the returned parameters; each save's and
    the restore's seconds and bytes, the free disk and the storage
    written. Then qwen3-moe-30b-a3b cut to its first layers, three steps
    of ``make_train_step`` at batch 4 x 128 (4,096 router choices):
    finite losses, a finite nonzero router gradient each step, the
    router's forward and backward as profiler ranges. No LOMS kernel may
    launch on the training paths; returns their launch counts (all
    zero)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.checkpoint.manager as CKM
    import repro_torch.models.moe as MOE
    import repro_torch.runtime.train_loop as TL
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import loss_fn, model_init
    from repro_torch.optim import OptConfig, global_norm, opt_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import TrainConfig, train_with_retries

    launches = {n: 0 for n in K.LAUNCHES}

    def count(what):
        torch.cuda.synchronize()
        got = {n: c for n, c in K.LAUNCHES.items() if c}
        log(f"  launches, {what}: {got}")
        if got:
            raise AssertionError(f"{what} launched LOMS kernels: {got}")

    def to_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    _grads_against_cpu(dev, K, card, count)

    # Qwen3-8B: the step's time, memory and remat
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=TRAIN_LAYERS["qwen3-8b"])
    dc = DataConfig(seq_len=512, global_batch=4, seed=0)
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    pipe = TokenPipeline(cfg, dc)
    log(f"  {cfg.name} cut to {cfg.n_layers} of 36 layers at full width (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}); "
        f"batch {dc.global_batch} x {dc.seq_len}; six steps of make_train_step")
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev, torch.float32)
    opt_state = opt_init(params)
    K.reset_launch_counts()
    with _StepRecorder(TL, after=True) as rec:
        step_fn = TL.make_train_step(cfg, oc)
        for i in range(6):
            params, opt_state, _ = step_fn(params, opt_state, to_dev(pipe.get_batch(i)))
    count(f"{cfg.name} training steps")
    steps = rec.steps
    losses, after = [s["loss"] for s in steps], [s["after"] for s in steps]
    log(f"  losses by step {[round(v, 4) for v in losses]}; each step's own batch after its "
        f"update {[round(v, 4) for v in after]}")
    if not all(np.isfinite(losses + after)):
        raise AssertionError(f"losses {losses}, {after}: not finite")
    if not all(a < s for a, s in zip(after, losses)):
        raise AssertionError("a step's update did not lower its own batch's loss")
    n_params = sum(t.numel() for t in leaves(params))
    emb = params["embed"]["emb"].numel()
    tokens = dc.global_batch * dc.seq_len
    ms = float(np.median([s["ms"] for s in steps]))
    upd_ms = float(np.median([s["update_ms"] for s in steps]))
    wall_ms = float(np.median([s["wall_ms"] for s in steps]))
    peak = max(s["peak_gb"] for s in steps)
    flops, abytes, f_ms, a_ms = train_floor(cfg, n_params, emb, tokens, dc.seq_len)
    log(f"  {n_params / 1e9:.3f} B parameters ({emb / 1e9:.3f} B embedding); training "
        f"state {16 * n_params / 1e9:.1f} GB; step p50 {ms:.2f} ms (CUDA events), "
        f"{wall_ms:.2f} ms wall, {tokens / ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak:.2f} GB; AdamW (opt_update) p50 {upd_ms:.2f} ms of the step; steps "
        f"(events ms) {[round(s['ms'], 2) for s in steps]}; {card}")
    log(f"  floor of a step: products {flops / 1e12:.2f} TFLOP = {f_ms:.2f} ms at "
        f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16, AdamW {abytes / 1e9:.1f} GB = {a_ms:.2f} ms "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: {f_ms + a_ms:.2f} ms, "
        f"{(f_ms + a_ms) / ms:.3f} of the measured step; {card}")

    # remat: one forward and backward each from the sixth step's state
    del opt_state
    gc.collect()
    torch.cuda.empty_cache()
    batch = to_dev(pipe.get_batch(6))
    ps = leaves(params)
    resident = torch.cuda.memory_allocated()
    res = {}
    K.reset_launch_counts()
    for remat in ("none", "full", "dots"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for t in ps:
            t.requires_grad_(True)
        loss = loss_fn(params, batch, cfg, remat=remat)
        torch.cuda.synchronize()
        held = (torch.cuda.memory_allocated() - resident) / 1e9  # what backward keeps
        grads = torch.autograd.grad(loss, ps)
        gn = float(global_norm(grads))
        for t in ps:
            t.requires_grad_(False)
        res[remat] = (float(loss.detach()), gn, held,
                      (torch.cuda.max_memory_allocated() - resident) / 1e9)
        del loss, grads
    count("remat")
    log("  remat from the sixth step's state (loss, grad norm; held after the forward and the "
        f"peak, above the resident weights of {resident / 1e9:.2f} GB): " + ", ".join(
            f"{r} {v[0]!r} {v[1]:.6f}, {v[2]:.3f} GB, {v[3]:.3f} GB"
            for r, v in res.items()) + f"; {card}")
    if not res["none"][0] == res["full"][0] == res["dots"][0]:
        raise AssertionError(f"remat changes the loss: {res}")
    for r in ("full", "dots"):
        if abs(res[r][1] - res["none"][1]) > 1e-3 * res["none"][1]:
            raise AssertionError(f"remat {r}: grad norm {res[r][1]} vs {res['none'][1]}")
    # the activations backward keeps fall with the remat; the step's peak
    # (set by the head and the loss at a cut depth) does not rise
    if not (res["full"][2] < res["dots"][2] < res["none"][2]
            and res["full"][3] <= res["dots"][3] <= res["none"][3]):
        raise AssertionError(f"memory not full < dots < none held, <= at the peak: {res}")
    del params, ps, batch
    gc.collect()
    torch.cuda.empty_cache()

    # Qwen3-8B through train_with_retries: the fault, the resume, the checkpoints
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS["qwen3-8b checkpointed"])
    root = tempfile.mkdtemp(prefix="repro_train_")
    tc = TrainConfig(steps=6, ckpt_every=3, log_every=1, ckpt_dir=root)
    free0 = shutil.disk_usage(root).free
    log(f"  {cfg.name} cut to {cfg.n_layers} of 36 layers through train_with_retries (batch "
        f"{dc.global_batch} x {dc.seq_len}, {tc.steps} steps, a checkpoint every "
        f"{tc.ckpt_every}, a fault at step 4); checkpoints in {root}, {free0 / 1e9:.1f} GB "
        f"free there")
    buf = io.StringIO()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with _StepRecorder(TL) as rec, \
                _CheckpointClock(CKM.CheckpointManager) as ck, \
                contextlib.redirect_stdout(buf):
            out = train_with_retries(cfg, dc, tc, oc, retries=1, fail_at_step=4, device=dev)
        wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log("   " + line)
        count(f"{cfg.name} train_with_retries")
        text = buf.getvalue()
        if text.count("injected fault at step 4") != 1 or "resumed from step 3" not in text:
            raise AssertionError("the injected fault did not fire once, or no resume from step 3")
        steps = rec.steps
        if len(steps) != 7 or out["losses"] != [s["loss"] for s in steps[4:]]:
            raise AssertionError(f"{len(steps)} steps recorded, returned losses {out['losses']}")
        losses = [s["loss"] for s in steps[:4]] + out["losses"][1:]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"losses {losses}: not finite")
        if steps[3]["loss"] != steps[4]["loss"]:
            raise AssertionError(f"step 3's loss {steps[3]['loss']!r} after the resume is not "
                                 f"the first attempt's {steps[4]['loss']!r}")
        params = out["params"]
        n_params = sum(t.numel() for t in leaves(params))
        largest = max(t.numel() for t in leaves(params)) * 4
        log(f"  losses by step {[round(v, 4) for v in losses]}; step 3 after the resume "
            f"bit-equal to the first attempt's ({steps[3]['loss']!r}); {n_params / 1e9:.3f} B "
            f"parameters, step p50 {float(np.median([s['ms'] for s in steps])):.2f} ms (CUDA "
            f"events); train_with_retries {wall:.1f} s in all; {card}")
        for sv in ck.saves:
            nb = _dir_bytes(sv["dir"], sv["step"]) if os.path.isdir(
                os.path.join(sv["dir"], f"step_{sv['step']:08d}")) else 0
            log(f"  save of step {sv['step']}: snapshot to host {sv['snapshot_s']:.2f} s, "
                f"written and published {sv['write_end'] - sv['t0']:.2f} s after the call, "
                f"{nb / 1e9:.2f} GB ({nb / (sv['write_end'] - sv['t0']) / 1e9:.2f} GB/s)")
        for rs in ck.restores:
            log(f"  restore of step {rs['step']} (the resume, in place {rs['in_place']}): "
                f"{rs['s']:.2f} s, {rs['bytes'] / 1e9:.2f} GB ({rs['bytes'] / rs['s'] / 1e9:.2f} "
                f"GB/s); device memory {rs['resident'] / 1e9:.2f} GB resident (the fresh "
                f"state it fills), peak {rs['above'] / 1e9:.3f} GB above it (the largest leaf "
                f"{largest / 1e9:.3f} GB)")
            if not rs["in_place"] or rs["above"] > largest:
                raise AssertionError(f"the resume's restore held more than one leaf: {rs}")
        DISK_BYTES["checkpoints"] += _tree_bytes(root)
        log(f"  free disk {shutil.disk_usage(root).free / 1e9:.1f} GB with both checkpoints "
            f"written (before: {free0 / 1e9:.1f} GB): {_tree_bytes(root) / 1e9:.2f} GB")

        # step 6's checkpoint into a fresh template, against the returned parameters
        t1 = time.perf_counter()
        template = model_init(None, cfg, dev, torch.float32)
        state, extra = CheckpointManager(root).restore(6, (template, opt_init(template)))
        torch.cuda.synchronize()
        rs = time.perf_counter() - t1
        del template
        got, opt_state = state
        if extra["step"] != 6 or int(opt_state["step"]) != 6 or not all(
                torch.equal(a, b) for a, b in zip(leaves(got), leaves(params))):
            raise AssertionError("step 6's checkpoint is not the returned parameters")
        log(f"  restore of step 6 into a fresh template: bit-equal to the returned "
            f"parameters ({rs:.2f} s with the template's init)")
        del out, params, state, got, opt_state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # qwen3-moe-30b-a3b: three steps, the router learning through the executor's top-k
    mcfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                               n_layers=TRAIN_LAYERS["qwen3-moe-30b-a3b"])
    params = model_init(torch.Generator(device=dev).manual_seed(0), mcfg, dev, torch.float32)
    opt_state = opt_init(params)
    n_params = sum(t.numel() for t in leaves(params))
    ps = leaves(params)
    routers = [i for i, t in enumerate(ps)
               if any(t is lay["ffn"]["router"]["w"] for lay in params["stack"]["body"])]
    mdc = DataConfig(seq_len=128, global_batch=4, seed=0)
    pipe = TokenPipeline(mcfg, mdc)
    log(f"  {mcfg.name} cut to {mcfg.n_layers} of 48 layers at full width "
        f"({mcfg.moe.n_experts} experts top-{mcfg.moe.top_k}, dispatch "
        f"{mcfg.moe.dispatch}): {n_params / 1e9:.3f} B parameters, training state "
        f"{16 * n_params / 1e9:.1f} GB; batch {mdc.global_batch} x {mdc.seq_len} = "
        f"{mdc.global_batch * mdc.seq_len * mcfg.moe.top_k} router choices")
    real_update, router_norms = TL.opt_update, []

    def update(grads, state, prm, oc_):
        router_norms.append([float(grads[i].norm()) for i in routers])
        return real_update(grads, state, prm, oc_)
    real_router = MOE.router_topk
    TL.opt_update = update
    MOE.router_topk = _router_ranges(real_router)
    K.reset_launch_counts()
    try:
        with _StepRecorder(TL) as rec:
            step_fn = TL.make_train_step(mcfg, OptConfig(lr=3e-4, warmup_steps=1,
                                                         total_steps=3))
            batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.get_batch(i).items()}
                       for i in range(3)]
            for b in batches[:2]:
                params, opt_state, _ = step_fn(params, opt_state, b)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params, opt_state, _ = step_fn(params, opt_state, batches[2])
                torch.cuda.synchronize()
    finally:
        TL.opt_update, MOE.router_topk = real_update, real_router
    count(f"{mcfg.name} training")
    losses = [s["loss"] for s in rec.steps]
    if len(losses) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"MoE training losses {losses}")
    if not all(np.isfinite(n).all() and min(n) > 0 for n in map(np.asarray, router_norms)):
        raise AssertionError(f"router gradient norms {router_norms}: not finite and nonzero")
    busy, ranges = 0.0, {}
    for ev in prof.key_averages():
        if ev.key.startswith("moe.router_topk") and ev.device_type != DeviceType.CUDA:
            t_dev = getattr(ev, "device_time_total", None)
            ranges[ev.key] = (ev.count, (t_dev if t_dev is not None
                                         else getattr(ev, "cuda_time_total", 0)) / 1e3,
                              ev.cpu_time_total / 1e3)
        elif ev.device_type == DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            busy += t if t is not None else getattr(ev, "self_cuda_time_total", 0)
    log(f"  losses {losses}; router gradient norms by step {router_norms}; step ms "
        f"(CUDA events) {[round(s['ms'], 2) for s in rec.steps]}, AdamW "
        f"{[round(s['update_ms'], 2) for s in rec.steps]}, wall "
        f"{[round(s['wall_ms'], 2) for s in rec.steps]}; peak memory "
        f"{max(s['peak_gb'] for s in rec.steps):.2f} GB; {card}")
    log(f"  profiled step 3: device busy {busy / 1e3:.2f} ms; " + ", ".join(
        f"{k}: {c} calls, device {d:.3f} ms, host {h:.3f} ms" for k, (c, d, h) in
        sorted(ranges.items())) + f"; {card}")
    if set(ranges) != {"moe.router_topk", "moe.router_topk.backward"}:
        raise AssertionError(f"router profiler ranges {sorted(ranges)}")
    del params, opt_state, batches, ps
    return launches


# ---------------------------------------------------------------------------
# phase 3r: distribution (repro_torch.parallel) on NCCL, one rank a card
# ---------------------------------------------------------------------------

def link_rate() -> tuple:
    """(bytes/s from card 0 to its peers, where the number comes from): the
    per-link speeds of ``nvidia-smi nvlink -s`` summed over card 0's
    links (a direction), else the ``nvidia-smi topo -m`` entry between
    GPU0 and GPU1 (NV<n>: n links of 25 GB/s, NVLink 4), else (None,
    what the machine said)."""
    def run(*args):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                             timeout=60)
        return out.stdout if out.returncode == 0 else ""

    speeds = []
    for ln in run("nvlink", "-s", "-i", "0").splitlines():
        parts = ln.split()
        if parts[:1] == ["Link"] and parts[-1:] == ["GB/s"]:
            speeds.append(float(parts[-2]))
    if speeds:
        return sum(speeds) * 1e9, f"nvlink -s: {len(speeds)} links"
    rows = [ln.split() for ln in run("topo", "-m").splitlines() if ln.startswith("GPU0")]
    entry = rows[0][2] if rows and len(rows[0]) > 2 else "not reported"
    if entry.startswith("NV") and entry[2:].isdigit():
        return int(entry[2:]) * 25e9, f"topo -m: {entry}"
    return None, entry


def _dist_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One NCCL rank of phase 3r on ``cuda:<rank>``: every call at full
    width with ``par``, its launches counted, its device time beside the
    single-device call's on the same card, held to it (see
    :func:`phase_dist`); writes its record to ``out_dir``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # bootstrap over loopback: one host
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    import repro_torch
    from repro_torch.api import SortSpec, plan
    from repro_torch.api.payload import stabilize_ties
    from repro_torch.configs import get_config
    from repro_torch.kernels import topk as K
    from repro_torch.models import moe as t_moe
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.parallel import (compress, compressed_psum, decompress, dist_sort_axis,
                                      init_mesh, make_parallelism, pipeline_apply,
                                      sample_merge_k, sample_sort, vocab_topk_axis)
    from repro_torch.resilience import breaker_states
    from repro_torch.serving.sample import sample_topk, sample_topp

    dev = torch.device("cuda", rank)
    par = make_parallelism(init_mesh("cuda", (1, world)))
    rec = {"rows": [], "launches": {n: 0 for n in K.LAUNCHES}, "a2a_bytes": []}

    def same(name, got, want):
        gs = got if isinstance(got, (tuple, list)) else (got,)
        ws = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(gs, ws):
            if g.shape != w.shape or not torch.equal(
                    bits(g) if g.dtype.is_floating_point else g,
                    bits(w) if w.dtype.is_floating_point else w):
                raise AssertionError(f"rank {rank}, {name}: differs from the single-device call")

    def ranks_agree(name, t):
        """Every rank holds the same ``t`` (bits)."""
        mine = t.contiguous().view(torch.uint8)  # NCCL moves no int16
        outs = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(outs, mine)
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"{name}: the ranks disagree")

    def run(name, call, single, check):
        """``call`` (the ``par`` route) with its launches counted and its
        ``dist_sort.all_to_all_bytes``; ``single`` the single-device call;
        ``check(got, want)`` holds one to the other (None: bit-equal)."""
        torch.cuda.synchronize()
        K.reset_launch_counts()
        obs_metrics.reset()
        prev = obs_trace.set_enabled(True)  # the exchange counter counts with obs on
        got = call()
        torch.cuda.synchronize()
        obs_trace.set_enabled(prev)
        counts = dict(K.LAUNCHES)
        a2a = int(obs_metrics.counter("dist_sort.all_to_all_bytes").total())
        for n, c in counts.items():
            rec["launches"][n] += c
        want = single()
        (check or (lambda g, w: same(name, g, w)))(got, want)
        ms, single_ms = cuda_ms(call, 3, warm=1), cuda_ms(single, 3, warm=1)
        rec["rows"].append((name, ms, single_ms, a2a, {n: c for n, c in counts.items() if c}))
        return got

    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    # -- the sort: (8, 2^20) float32, the decision table's row ---------------
    x = torch.randn((8, 1 << 20), generator=gen.manual_seed(1), device=dev)
    iota = torch.arange(1 << 20, dtype=torch.int32, device=dev).expand(8, 1 << 20)
    offs = tuple(range(0, 8 * (1 << 20) + 1, 1 << 20))
    flat = x.reshape(-1)
    if dist_sort_axis(par, (1 << 20,)) is None:  # one rank: the single-device route
        spec = SortSpec(op="sort", lengths=(1 << 20,), batch=8, device="cuda", sharded=False)
        rec["plan"] = [plan(spec, par).backend]
        run("sample_sort (8, 2^20) f32", lambda: sample_sort(x, mesh=par.mesh,
                                                              axis_name="model")[0],
            lambda: repro_torch.segment_sort(flat, offs).reshape(8, -1), None)

        def stable(got, want):
            v, p = stabilize_ties(*got)
            same("sample_sort positions, ties stabilised", (v, p), want)
        run("sample_sort (8, 2^20) f32 + positions",
            lambda: sample_sort(x, mesh=par.mesh, axis_name="model", pos=iota),
            lambda: tuple(t.reshape(8, -1) for t in repro_torch.segment_sort(
                flat, offs, payload=iota.reshape(-1))), stable)
    else:
        rec["plan"] = [plan(SortSpec(op="sort", lengths=(1 << 20,), batch=8, device="cuda",
                                     sharded=True), par).backend]
        run("sort (8, 2^20) f32", lambda: repro_torch.sort(x, par=par),
            lambda: repro_torch.segment_sort(flat, offs).reshape(8, -1), None)

        def gathers(got, want):
            same("sort + payload: values", got[0], want[0])
            same("sort + payload: the permutation gathers the values",
                 torch.gather(x, 1, got[1].long()), got[0])
        run("sort (8, 2^20) f32 + payload", lambda: repro_torch.sort(x, par=par, payload=iota),
            lambda: tuple(t.reshape(8, -1) for t in repro_torch.segment_sort(
                flat, offs, payload=iota.reshape(-1))), gathers)
        run("sort (8, 2^20) f32 + payload, stable",
            lambda: repro_torch.sort(x, par=par, payload=iota, stable=True),
            lambda: tuple(t.reshape(8, -1) for t in repro_torch.segment_sort(
                flat, offs, payload=iota.reshape(-1))), None)
    del x, iota, flat
    # -- the merges ------------------------------------------------------------
    lists = [torch.sort(torch.randn((1, 50_000), generator=gen.manual_seed(10 + i),
                                    device=dev))[0] for i in range(4)]
    a, b = (torch.sort(torch.randn((1, 1 << 19), generator=gen.manual_seed(20 + i),
                                   device=dev))[0] for i in range(2))
    run("merge_k 4 x 50,000 f32", lambda: repro_torch.merge_k(lists, par=par),
        lambda: repro_torch.merge_k(lists), None)
    run("merge 2 x 2^19 f32", lambda: repro_torch.merge(a, b, par=par),
        lambda: repro_torch.merge(a, b), None)
    if world == 1:
        rec["plan"].append(plan(SortSpec(op="merge_k", lengths=(50_000,) * 4, device="cuda",
                                         sharded=False), par).backend)
        run("sample_merge_k 4 x 50,000 f32",
            lambda: sample_merge_k(lists, mesh=par.mesh, axis_name="model")[0],
            lambda: repro_torch.merge_k(lists), None)
    med = [total_order_sorted(seg_tile(65_536, 7, torch.float32, dev, 40 + j))
           for j in range(3)]
    run("median_of_lists 65,536 x (7, 7, 7) f32",
        lambda: repro_torch.median_of_lists(med, par=par),
        lambda: repro_torch.median_of_lists(med), None)
    # -- top-k and sampling at Qwen3-8B's vocabulary ---------------------------
    vocab = get_config("qwen3-8b").vocab_size
    logits = (torch.randn((4, vocab), generator=gen.manual_seed(3), device=dev) * 3
              ).to(torch.bfloat16)
    rec["plan"].append(plan(SortSpec(op="topk", lengths=(vocab,), k=64, batch=4,
                                     dtype="bfloat16", device="cuda",
                                     sharded=vocab_topk_axis(par, vocab) is not None),
                            par).backend)

    def topk_check(got, want):
        same("topk values", got[0], want[0])
        same("topk indices gather the values", torch.gather(logits, 1, got[1].long()), got[0])
        ranks_agree("topk indices", got[1])
    run("topk (4, 151936) bf16, k 64", lambda: repro_torch.topk(logits, 64, par=par),
        lambda: repro_torch.topk(logits, 64), topk_check)

    def token_check(name):
        def check(got, want):  # the same drawn value; under ties, possibly another id
            same(name, torch.gather(logits, 1, got.long()[:, None]),
                 torch.gather(logits, 1, want.long()[:, None]))
            ranks_agree(name, got)
        return check

    def canonical_check(name):
        def check(got, want):  # sample_topk draws the canonical token on every mesh
            same(name, got, want)
            ranks_agree(name, got)
        return check
    for name, kw in (("sample_topk k 64", dict(k=64)),
                     ("sample_topk ragged k (64, 8, 32, 1)", dict(k=[64, 8, 32, 1]))):
        run(f"{name}, T 0.8", lambda kw=kw: sample_topk(
            logits, temperature=0.8, generator=gen.manual_seed(5), par=par, **kw),
            lambda kw=kw: sample_topk(logits, temperature=0.8, generator=gen.manual_seed(5),
                                      **kw), canonical_check(name))
    run("sample_topp p 0.9, k_max 256", lambda: sample_topp(
        logits, p=0.9, generator=gen.manual_seed(6), par=par),
        lambda: sample_topp(logits, p=0.9, generator=gen.manual_seed(6)),
        token_check("sample_topp"))
    del logits
    # -- MoE: qwen3-moe-30b-a3b's layer, float32, no drops ---------------------
    cfg = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts // cfg.moe.top_k)))
    p = t_moe.moe_init(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32, dev)
    for name, shape in (("MoE prefill 4 x 128 (all_to_all)", (4, 128, cfg.d_model)),
                        ("MoE decode 4 x 1 (psum)", (4, 1, cfg.d_model))):
        xm = torch.randn(shape, generator=gen.manual_seed(7), device=dev)

        def close(got, want, name=name):
            tol = 1e-5 * float(want.abs().max())
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"rank {rank}, {name}: {err} > {tol}")
            ranks_agree(name, got)
        run(name, lambda xm=xm: t_moe.moe_apply(p, xm, cfg, par=par),
            lambda xm=xm: t_moe.moe_apply(p, xm, cfg), close)
    del p
    # -- the pipeline: one Qwen3-8B-wide layer a stage ------------------------
    d = get_config("qwen3-8b").d_model
    stages = {"w": torch.randn((world, d, d), generator=gen.manual_seed(8), device=dev) / d**.5,
              "b": torch.randn((world, d), generator=gen.manual_seed(9), device=dev) * 0.1}
    xp = torch.randn((8, 4, d), generator=gen.manual_seed(11), device=dev)

    def stage_fn(q, h):
        return torch.tanh(h @ q["w"] + q["b"])

    def sequential():  # a microbatch at a time, as the stages take them
        out = []
        for m in range(xp.shape[0]):
            h = xp[m]
            for s in range(world):
                h = stage_fn({"w": stages["w"][s], "b": stages["b"][s]}, h)
            out.append(h)
        return torch.stack(out)
    def pipe_check(got, want):  # one card: bit-equal; stages on other cards: within 1e-6
        err = float((got - want).abs().max())
        rec["pipeline_err"] = err
        if world == 1:
            same("pipeline", got, want)
        elif not err <= 1e-6 * float(want.abs().max()):
            raise AssertionError(f"rank {rank}, pipeline: {err} from the sequential stages")
    run(f"pipeline_apply {world} stage(s) of d {d}, 8 x 4 microbatches",
        lambda: pipeline_apply(stage_fn, stages, xp, par.mesh, axis="model"), sequential,
        pipe_check)
    # -- the compressed reduction of a 64 MB gradient --------------------------
    n = 16 * 1024 * 1024

    def grad(r):
        g = torch.Generator(device=dev).manual_seed(100 + r)
        return (torch.randn((4096, n // 4096), generator=g, device=dev),
                torch.randn((4096, n // 4096), generator=g, device=dev) * 1e-3)

    g_me, e_me = grad(rank)

    def psum_plain():  # every rank's codes summed here, in rank order
        qs, ss = zip(*(compress(sum(grad(r))) for r in range(world)))
        q_sum = sum(q.to(torch.int32) for q in qs)
        s_sum = sum(ss)
        return decompress(q_sum.float() / world, s_sum / world, g_me.shape) * world

    def psum_check(got, want):
        tol = 1e-6 * float(want.abs().max())
        if world == 1:
            same("compressed_psum", got[0], want)
        elif not float((got[0] - want).abs().max()) <= tol:
            raise AssertionError(f"rank {rank}, compressed_psum beyond {tol}")
    run("compressed_psum 64 MB f32", lambda: compressed_psum(g_me, par.group("model"), e_me),
        psum_plain, psum_check)
    if breaker_states():
        raise AssertionError(f"rank {rank}: breakers {breaker_states()} after phase 3r")
    rec["seconds"] = time.perf_counter() - t0
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_dist(card) -> dict:
    """Phase 3r: distribution (``repro_torch.parallel``, ``par=`` through
    the library, the sampler and the MoE layer) on NCCL, one rank a card
    (``torch.cuda.device_count()``, start method ``spawn``, rendezvous
    through a temporary file). Each rank: ``repro_torch.sort(x, par=par)``
    of (8, 2^20) float32 (values; a payload; ``stable=True`` and a
    payload), ``merge_k`` of 4 x 50,000, ``merge`` of 2 x 2^19 and
    ``median_of_lists`` with ``par``; ``topk(logits, 64, par=par)``,
    ``sample_topk`` (k 64 and a ragged k) and ``sample_topp`` at Qwen3-8B's
    vocabulary (4, 151,936) bf16; qwen3-moe-30b-a3b's MoE layer in float32
    (128 experts, d_model 2048, top 8, seed 0, no-drop capacity) on a 4 x
    128 prefill (all_to_all) and a B = 4 decode (psum); ``pipeline_apply``
    of one stage a rank; ``compressed_psum`` of a 64 MB gradient. Each is
    held to the single-device call on the same card: values bit-equal,
    payload lanes bit-equal with ``stable=True`` (without it the
    permutation gathers the values), every rank's top-k and tokens
    bit-equal to the others', MoE within 1e-5 of the layer's largest
    magnitude. The single-device route of a (8, 2^20) sort is the schedule
    executor, whose comparison clouds are quadratic; its single-device
    call here is ``segment_sort`` over the 8 rows (the values-only spill,
    and the stable permutation). At one card the TP axis is 1, so, as the
    reference, every ``par`` call plans the single-device route (asserted)
    and the sample-sort, the sample-merge, the pipeline and the
    compressed reduction are called directly so that their collectives
    run, of one rank; everything is bit-equal there. Returns rank 0's
    launches."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    rate, entry = link_rate()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_dist_rank, args=(world, os.path.join(d, "rendezvous"), d), nprocs=world,
                 join=True, start_method="spawn")
        recs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    rec = recs[0]
    single = world == 1
    # one card: the sort's executor (over the fused budget), the k-way
    # tiles, the vocab kernels; more: the sample-sort and the device tree
    want_plan = ["schedule", "streaming", "cuda"] if single else ["sharded", "sharded"]
    if rec["plan"] != want_plan:
        raise AssertionError(f"phase 3r plans {rec['plan']}, not {want_plan}")
    log(f"  {world} NCCL rank(s), one a card; TP axis {world}; plans {rec['plan']}; "
        f"peer link: {entry} ({'no rate' if rate is None else f'{rate / 1e9:.1f} GB/s a direction'})"
        f"; {card}")
    for name, ms, single_ms, a2a, counts in rec["rows"]:
        wire = ("" if not a2a or rate is None
                else f", exchange bound {a2a * (world - 1) / world / rate * 1e3:.4f} ms")
        log(f"  {name}: {ms:.4f} ms with par (rank 0), single device {single_ms:.4f} ms; "
            f"all_to_all bytes "
            f"{a2a}{wire}; launches {counts}")
    log(f"  phase 3r {time.perf_counter() - t0:.1f} s ({max(r['seconds'] for r in recs):.1f} s "
        f"in the ranks' calls); launches (rank 0) "
        f"{ {n: c for n, c in rec['launches'].items() if c} }")
    return rec["launches"]


# ---------------------------------------------------------------------------
# phase 3s: sharded parameters through the model
# ---------------------------------------------------------------------------

#: (a)'s bounds of TP decode against one card, over 16 teacher-forced
#: steps of 4 rows: the largest logits difference (0.113 measured on the
#: H100) and the share of equal argmaxes (61 / 64 measured)
TP_LOGITS_ATOL = 0.25
TP_ARGMAX_MIN = 0.9
#: (c)'s bounds of the sharded step against the one-card step, relative:
#: the loss and grad norm (7.0e-6 and 1.5e-4 at most measured on the
#: H100: the products run in bf16 and a TP row-parallel sum or a smaller
#: batch a rank rounds its partial sums otherwise); and a checked leaf's
#: update (new - initial), mean |difference| over mean |one card's|: a
#: first AdamW step moves each element by about lr whatever the gradient's
#: size, so only elements whose tiny gradient changes sign differ, where a
#: lost shard's elements would not move at all (a quarter or more of a leaf)
SHARDED_LOSS_RTOL = 1e-4
SHARDED_GNORM_RTOL = 2e-3
SHARDED_UPDATE_RTOL = 0.1


def _sharded_one_card(dev, par, rec, say) -> None:
    """3s at one card: the (1, 1) mesh bit-equal to no mesh."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import topk as K
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache, model_init, param_specs, prefill
    from repro_torch.optim import OptConfig, opt_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import shard_params
    from repro_torch.parallel.sharding import axis_sizes
    from repro_torch.runtime import train_loop as TL
    from repro_torch.serving import ServeConfig, generate

    host = axis_sizes(make_host_mesh(device_type="cuda"))
    if tuple(host.values()) != (1, 1):
        raise AssertionError(f"make_host_mesh() on one card gives {host}, not (1, 1)")
    say(f"  make_host_mesh() on one card: {host}")
    cfg = get_config("qwen3-8b")
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    rng = np.random.default_rng(0)  # 3a's prompts and sampling
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    tokens = rng.integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
    sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0)
    tok_dev = torch.from_numpy(tokens).to(dev)
    with torch.no_grad():
        want_first, _ = prefill(params, {"tokens": tok_dev}, init_cache(cfg, bsz, plen, dev), cfg)
    K.reset_launch_counts()
    want = generate(params, {"tokens": tokens}, cfg, sc, device=dev)["tokens"]
    torch.cuda.synchronize()
    plain_launches = dict(K.LAUNCHES)
    params = shard_params(params, par, param_specs(cfg))  # in place: no copy at (1, 1)
    with torch.no_grad():
        got_first, _ = prefill(params, {"tokens": tok_dev},
                               init_cache(cfg, bsz, plen, dev, par=par), cfg, par=par)
    got_first = got_first.full_tensor()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = generate(params, {"tokens": tokens}, cfg, sc, device=dev, par=par)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    tree = K.vocab_merge_launches(cfg.vocab_size, __import__("repro_torch").api.topk_block(
        cfg.vocab_size, k), k)
    expect = {**{n: 0 for n in K.LAUNCHES}, "vocab_phase1": new, "vocab_merge_level": new * tree}
    if launches != expect or launches != plain_launches:
        raise AssertionError(f"generate(par) launched {launches}; 3a's run {plain_launches}, "
                             f"expected {expect}")
    if not np.array_equal(got["tokens"], want):
        raise AssertionError("generate(par) on a (1, 1) mesh drew other tokens")
    if not torch.equal(got_first.view(torch.int16), want_first.view(torch.int16)):
        raise AssertionError("the first step's logits under par are not bit-equal")
    rec["launches"] = launches
    say(f"  Qwen3-8B at full width (36 layers, bf16, seed 0) on a (1, 1) mesh: generate(par) "
        f"tokens bit-equal to generate() ({bsz} x {new}, k {k}, temperature {temp}), the "
        f"first step's logits bit-equal; {time.perf_counter() - t0:.1f} s; launches {launches}")
    del params, want_first, got_first
    gc.collect()
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS["qwen3-8b"])
    dc = DataConfig(seq_len=512, global_batch=4, seed=0)
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    batch = {n: torch.from_numpy(v).to(dev)
             for n, v in TokenPipeline(cfg4, dc).get_batch(0).items()}
    p0 = model_init(torch.Generator(device=dev).manual_seed(0), cfg4, dev, torch.float32)
    p0, _, m0 = TL.make_train_step(cfg4, oc)(p0, opt_init(p0), batch)
    want_leaves = [t.cpu() for t in leaves(p0)]  # the state of one: room for the other
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    p1 = model_init(torch.Generator(device=dev).manual_seed(0), cfg4, dev, torch.float32,
                    par=par)
    p1, _, m1 = TL.make_train_step(cfg4, oc, par=par)(p1, opt_init(p1), batch)
    for name in ("loss", "grad_norm"):
        if not torch.equal(m0[name], m1[name]):
            raise AssertionError(f"train step {name}: {float(m1[name])} under par, "
                                 f"{float(m0[name])} without")
    for a, b in zip(want_leaves, leaves(p1)):
        if not torch.equal(a, b.full_tensor().cpu()):
            raise AssertionError("a parameter after make_train_step(par) is not bit-equal")
    say(f"  {cfg4.name} at {cfg4.n_layers} layers, float32 masters, batch 4 x 512: one "
        f"make_train_step(par) step on (1, 1): loss {float(m1['loss']):.6f}, grad norm "
        f"{float(m1['grad_norm']):.6f} and every updated parameter bit-equal to par=None's")


def _events_ms(fn, n: int):
    """Each of ``n`` calls of ``fn`` timed by CUDA events (ms)."""
    import torch

    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _sharded_four_cards(dev, world, rec, say) -> None:
    """3s on several cards: (a) TP serving, (b) FSDP training at full
    depth, (c) FSDP and FSDP + TP steps against the one-card step."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import decode_step, init_cache, model_init, prefill
    from repro_torch.optim import OptConfig, opt_init
    from repro_torch.parallel import init_mesh, make_parallelism
    from repro_torch.runtime import train_loop as TL

    cfg = get_config("qwen3-8b")
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    # (a) TP over (1, world): teacher-forced decode against this rank's one-card run;
    # Qwen3-8B's 8 kv heads split four ways, chatglm3-6b's 2 do not (its 32 query
    # heads split, the cache over head_dim)
    par = make_parallelism(init_mesh("cuda", (1, world)))
    bsz, plen, steps = 4, 128, 16
    rec["a"] = {}
    for arch in ("qwen3-8b", "chatglm3-6b"):
        acfg = get_config(arch)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, acfg.vocab_size, (bsz, plen)).astype(np.int32)).to(dev)

        def run(p, par_, forced):
            kw = {} if par_ is None else {"par": par_}
            out, toks, ms = [], [], []
            with torch.no_grad():
                cache = init_cache(acfg, bsz, plen + steps, dev, **kw)
                lg, cache = prefill(p, {"tokens": tokens}, cache, acfg, **kw)
                for i in range(steps):
                    lg = lg.full_tensor() if par_ is not None else lg
                    out.append(lg.float())
                    tok = forced[i] if forced else lg.argmax(-1).to(torch.int32)[:, None]
                    toks.append(tok)
                    pos = torch.full((bsz, 1), plen + i, dtype=torch.int32, device=dev)
                    if i == steps - 1:
                        break
                    a, b = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    a.record()
                    lg, cache = decode_step(p, tok, cache, acfg, positions=pos, **kw)
                    b.record()
                    torch.cuda.synchronize()
                    ms.append(a.elapsed_time(b))
            return out, toks, ms

        params = model_init(torch.Generator(device=dev).manual_seed(0), acfg, dev)
        one, forced, one_ms = run(params, None, [])
        sp = model_init(torch.Generator(device=dev).manual_seed(0), acfg, dev, par=par)
        gc.collect()
        torch.cuda.empty_cache()
        tp, _, tp_ms = run(sp, par, forced)
        diff = max(float((a - b).abs().max()) for a, b in zip(one, tp))
        agree, checked = 0, 0
        for a, b in zip(one, tp):
            top2 = a.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            d = (a - b).abs().amax(dim=-1)
            same = a.argmax(-1) == b.argmax(-1)
            agree += int(same.sum())
            must = margin > 2 * d  # no difference of d can swap the top two
            checked += int(must.sum())
            if not bool(same[must].all()):
                raise AssertionError(f"(a) {arch} TP decode: a greedy token differs where the "
                                     f"one-card top-2 margin exceeds twice the logits' "
                                     f"difference")
        n = len(one) * bsz
        say(f"  (a) {arch} served with TP over (1, {world}) ({acfg.n_kv_heads} kv heads, "
            f"{acfg.n_heads} heads; bf16, each rank also holding the one-card weights): "
            f"{steps} teacher-forced steps, logits max abs difference {diff:.6g} (bound "
            f"{TP_LOGITS_ATOL}), argmax agreement {agree}/{n} (floor {TP_ARGMAX_MIN}), greedy "
            f"tokens equal at all {checked} (row, step)s whose one-card top-2 margin exceeds "
            f"twice the row's difference; decode step p50 {float(np.median(tp_ms)):.3f} ms "
            f"under TP, {float(np.median(one_ms)):.3f} ms on one card (CUDA events, rank 0)")
        rec["a"][arch] = {"diff": diff, "agree": agree, "n": n, "checked": checked,
                          "tp_ms": float(np.median(tp_ms)), "one_ms": float(np.median(one_ms))}
        if diff > TP_LOGITS_ATOL or agree < TP_ARGMAX_MIN * n:
            raise AssertionError(f"(a) {arch} TP decode: logits {diff} apart (bound "
                                 f"{TP_LOGITS_ATOL}), argmax agreement {agree}/{n} (floor "
                                 f"{TP_ARGMAX_MIN})")
        del params, sp, one, tp
        gc.collect()
        torch.cuda.empty_cache()

    # (b) FSDP over (world, 1), full depth
    dc = DataConfig(seq_len=512, global_batch=4, seed=0)
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    pipe = TokenPipeline(cfg, dc)
    batches = [{n: torch.from_numpy(v).to(dev) for n, v in pipe.get_batch(i).items()}
               for i in range(3)]
    par_f = make_parallelism(init_mesh("cuda", (world, 1)), remat="full")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev, torch.float32,
                   par=par_f)  # placed a part at a time
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    state = opt_init(p)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = TL.make_train_step(cfg, oc, par=par_f, remat="full")
    losses, ms = [], []
    box = {"p": p, "s": state}
    for b in batches:
        def one_step(b=b):
            box["p"], box["s"], m = step(box["p"], box["s"], b)
            losses.append(m["loss"])
        ms += _events_ms(one_step, 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(b) FSDP losses {losses}")
    if max(peak, init_peak) > total_mem:
        raise AssertionError(f"(b) peak {peak} (init {init_peak}) over the card's {total_mem}")
    tok = dc.global_batch * dc.seq_len
    p50 = float(np.median(ms))
    say(f"  (b) Qwen3-8B at full depth ({cfg.n_layers} layers), FSDP over ({world}, 1), "
        f"float32 masters, batch 4 x 512, remat full: model_init(par) {init_s:.1f} s, its "
        f"peak {init_peak / 1e9:.2f} GB a card; "
        f"state held {held / 1e9:.2f} GB a card; steps (CUDA events, rank 0) "
        f"{[round(v, 2) for v in ms]} ms, p50 {p50:.2f} ms, {tok / p50 * 1e3:.0f} tokens/s; "
        f"peak {peak / 1e9:.2f} GB of the card's {total_mem / 1e9:.2f} GB; losses "
        f"{[round(v, 4) for v in losses]}")
    rec["b"] = {"ms": ms, "p50": p50, "tok_s": tok / p50 * 1e3, "peak": peak,
                "init_peak": init_peak,
                "total_mem": total_mem, "held": held, "losses": losses}
    split = _profile_step(lambda: step(box["p"], box["s"], batches[-1]), TL)
    say(f"  (b) one more step under torch.profiler (rank 0): {split}")
    del p, state, box
    gc.collect()
    torch.cuda.empty_cache()

    # (c) 4 layers: (world, 1) and (2, world // 2) against one card
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS["qwen3-8b"])
    batch = {n: torch.from_numpy(v).to(dev)
             for n, v in TokenPipeline(cfg4, dc).get_batch(0).items()}
    def checked(p):  # the leaves whose update is held against one card's
        body = p["stack"]["body"]
        return {"body[0].attn.wq": body[0]["attn"]["wq"]["w"],
                "body[-1].ffn.wo": body[-1]["ffn"]["wo"]["w"],
                "final_norm": p["final_norm"]["scale"], "lm_head": p["lm_head"]["w"]}

    p0 = model_init(torch.Generator(device=dev).manual_seed(0), cfg4, dev, torch.float32)
    init = {n: t.detach().cpu().clone() for n, t in checked(p0).items()}
    _, _, m0 = TL.make_train_step(cfg4, oc)(p0, opt_init(p0), batch)
    want = (float(m0["loss"]), float(m0["grad_norm"]))
    upd = {n: t.detach().cpu() - init[n] for n, t in checked(p0).items()}
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for shape in ((world, 1), (2, world // 2)):
        par_c = make_parallelism(init_mesh("cuda", shape))
        pc = model_init(torch.Generator(device=dev).manual_seed(0), cfg4, dev, torch.float32,
                        par=par_c)
        _, _, mc = TL.make_train_step(cfg4, oc, par=par_c)(pc, opt_init(pc), batch)
        got = (float(mc["loss"]), float(mc["grad_norm"]))
        rl = abs(got[0] - want[0]) / abs(want[0])
        rg = abs(got[1] - want[1]) / abs(want[1])
        ru = {}
        for n, t in checked(pc).items():
            u = t.full_tensor().detach().cpu() - init[n]
            ru[n] = float((u - upd[n]).abs().mean() / upd[n].abs().mean())
        rows.append((shape, got, rl, rg, ru))
        say(f"  (c) {cfg4.name} at {cfg4.n_layers} layers on {shape}: loss {got[0]:.6f} "
            f"(one card {want[0]:.6f}, {rl:.3g} apart, relative), grad norm {got[1]:.6f} "
            f"(one card {want[1]:.6f}, {rg:.3g} apart); the updates' mean |difference| "
            f"over the one-card update's: {', '.join(f'{n} {v:.3g}' for n, v in ru.items())}; "
            f"bounds {SHARDED_LOSS_RTOL}, {SHARDED_GNORM_RTOL} and {SHARDED_UPDATE_RTOL}")
        if (rl > SHARDED_LOSS_RTOL or rg > SHARDED_GNORM_RTOL
                or max(ru.values()) > SHARDED_UPDATE_RTOL):
            raise AssertionError(f"(c) the step on {shape} is outside the bounds")
        del pc
        gc.collect()
        torch.cuda.empty_cache()
    rec["c"] = rows


def _profile_step(fn, TL) -> str:
    """Where a training step's device time goes: torch.profiler over one
    call, the kernels summed by kind (NCCL collectives, products, the
    rest) beside the wall, and AdamW (``opt_update``) as a range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    real = TL.opt_update
    TL.opt_update = _ranged(real, "opt_update")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        TL.opt_update = real
    kinds = {"nccl": 0.0, "products": 0.0, "other": 0.0}
    launches, adam = 0, None
    for ev in prof.key_averages():
        if ev.key == "opt_update" and ev.device_type != DeviceType.CUDA:
            adam = ev.cpu_time_total / 1e3
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        name = ev.key.lower()
        kind = ("nccl" if "nccl" in name else "products" if any(
            w in name for w in ("gemm", "nvjet", "sm90", "cutlass", "xmma", "ampere")) else "other")
        kinds[kind] += t / 1e3
        launches += ev.count
    busy = sum(kinds.values())
    if busy <= 0:
        return f"the profiler saw no device time; wall {wall:.1f} ms"
    return (f"wall {wall:.1f} ms, {launches} kernels, device busy {busy:.1f} ms (NCCL "
            f"{kinds['nccl']:.1f}, products {kinds['products']:.1f}, the rest "
            f"{kinds['other']:.1f}); opt_update {adam if adam is None else round(adam, 1)} "
            f"ms of host wall")


def _sharded_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One NCCL rank of phase 3s on ``cuda:<rank>``; writes its record
    (its log lines, its launches) to ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # bootstrap over loopback: one host
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    from repro_torch.kernels import topk as K
    from repro_torch.parallel import init_mesh, make_parallelism

    dev = torch.device("cuda", rank)
    rec = {"lines": [], "launches": {n: 0 for n in K.LAUNCHES}}
    t0 = time.perf_counter()
    try:
        if world == 1:
            par = make_parallelism(init_mesh("cuda", (1, 1)))
            _sharded_one_card(dev, par, rec, rec["lines"].append)
        else:
            _sharded_four_cards(dev, world, rec, rec["lines"].append)
        rec["seconds"] = time.perf_counter() - t0
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_sharded(card) -> dict:
    """Phase 3s: sharded parameters through the model (``par=`` through
    ``forward`` / ``loss_fn`` / ``prefill`` / ``decode_step`` /
    ``generate`` / ``make_train_step``) on NCCL, one spawned rank a card.
    At one card the mesh is (1, 1): Qwen3-8B at full
    width and depth served by ``generate(par=par)`` on 3a's prompts, its
    tokens and first step's logits bit-equal to ``generate()``'s and rows
    4 and 5 launching as in 3a; one ``make_train_step(par=par)`` step of
    3q's 4-layer float32 trainer bit-equal to ``par=None``'s (loss, grad
    norm, every updated parameter); ``make_host_mesh()`` gives (1, 1). On
    four cards (the phase alone on a host of four): (a) Qwen3-8B (kv heads
    split) and chatglm3-6b (2 kv heads: query heads split, the cache over
    head_dim) served with TP over
    (1, 4), teacher-forced decode logits against each rank's one-card run
    (max abs difference, argmax agreement, equal greedy tokens wherever
    the one-card top-2 margin exceeds twice the difference); (b) Qwen3-8B
    at full depth trained with FSDP over (4, 1), float32 masters, batch 4
    x 512, remat full, three steps: step p50 (CUDA events), tokens/s, the
    peak memory of each card beside its memory; (c) 4 layers on (4, 1)
    and (2, 2): loss and grad norm against the one-card step within
    :data:`SHARDED_LOSS_RTOL` and :data:`SHARDED_GNORM_RTOL`, four leaves'
    updates within :data:`SHARDED_UPDATE_RTOL`. (a) also holds the logits
    within :data:`TP_LOGITS_ATOL` and the argmaxes equal at
    :data:`TP_ARGMAX_MIN` of the (row, step)s at least. Returns rank 0's
    launches (the one-card run's generate)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_sharded_rank, args=(world, os.path.join(d, "rendezvous"), d), nprocs=world,
                 join=True, start_method="spawn")
        recs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    for line in recs[0]["lines"]:
        log(line)
    props = torch.cuda.get_device_properties(0)
    log(f"  the card's memory (dry-run budget): {props.total_memory} bytes; {card}")
    log(f"  phase 3s {time.perf_counter() - t0:.1f} s ({max(r['seconds'] for r in recs):.1f} s "
        f"in the ranks); {world} rank(s); {card}")
    return recs[0]["launches"]


def guard(phase: str) -> None:
    """No breaker exists and no failpoint is armed after ``phase``: every
    call was answered by its planned rung (a caught failure makes a
    breaker), so no slower rung hid a kernel."""
    from repro_torch.resilience import breaker_states
    from repro_torch.resilience.failpoints import active

    if breaker_states() or active():
        raise AssertionError(f"phase {phase}: breakers {breaker_states()}, failpoints "
                             f"{active()}: a rung failed and another answered")


def _ranged(fn, label):
    """fn inside a profiler range named ``label``."""
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return wrapped


def profile_serve(dev, params, cfg, card, spans=(), patches=None) -> dict:
    """Where a decode step's time goes: torch.profiler over four sampled
    decode steps of the main path (B=4 after a 128-token prompt, behind
    ``patches`` for a vlm), device time by kernel, against the host's wall
    time. ``spans``: (module, function name, label) triples run inside a
    profiler range while profiled; returns label -> (calls, device ms,
    host ms), each a step (device ms: the kernels launched inside the
    range)."""
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
    labels = {label for _, _, label in spans}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in spans]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    off = 0
    if patches is not None:
        batch["patches"], off = patches, cfg.frontend_len
    with torch.inference_mode():
        cache = init_cache(cfg, bsz, off + plen + steps + 1, dev)
        logits, cache = prefill(params, batch, cache, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def pos(i):
            return torch.full((bsz, 1), off + plen + i, dtype=torch.int32, device=dev)

        tok, cache = step(params, tok, cache, pos(0), gen)  # warm
        torch.cuda.synchronize()
        try:
            for (mod, attr, real), (_, _, label) in zip(saved, spans):
                setattr(mod, attr, _ranged(real, label))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(1, steps + 1):
                    tok, cache = step(params, tok, cache, pos(i), gen)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            for mod, attr, real in saved:
                setattr(mod, attr, real)
    # kernel rows only: an operator's row repeats the time of its kernels
    dev_us, launches, ranges = {}, 0, {}
    for ev in prof.key_averages():
        t_dev = getattr(ev, "device_time_total", None)
        if t_dev is None:
            t_dev = getattr(ev, "cuda_time_total", 0)
        if ev.key in labels:
            if ev.device_type != DeviceType.CUDA:  # the host range, not its GPU annotation
                ranges[ev.key] = (ev.count / steps, t_dev / steps / 1e3,
                                  ev.cpu_time_total / steps / 1e3)
            continue
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
        return ranges
    topk_us = sum(t for n, t in dev_us.items() if "vocab_" in n or "router_topk" in n)
    log(f"  decode step profile of {cfg.name} (B={bsz}, {steps} steps, profiler on): per step "
        f"{launches / steps:.0f} kernels, device busy {total / steps / 1e3:.3f} ms of "
        f"{wall_us / steps / 1e3:.3f} ms wall (idle share {1 - total / wall_us:.3f}); "
        f"top-k kernels {topk_us / steps / 1e3:.4f} ms per step; {card}")
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t / steps / 1e3:8.4f} ms/step  {name[:90]}")
    return ranges


def main() -> int:
    import torch

    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: src/repro_torch is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    if os.environ.get("REPRO_FAILPOINTS", "").strip() or os.environ.get(
            "REPRO_RESILIENCE", "1") == "0":
        print("chip_smoke: REPRO_FAILPOINTS is set or REPRO_RESILIENCE=0: every phase must "
              "run with no fault armed and the degradation ladder on", file=sys.stderr)
        return 4
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

    def since() -> str:
        return f"({time.perf_counter() - t_start:.1f} s in)"

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

    log(f"phase 2: kernels against their plain versions {since()}")
    err = phase_kernels(dev, K, topk_block)
    err.update(phase_seg_kernels(dev, SK, capable_families))
    err.update(phase_merge_sort_kernels(dev, capable_families))
    err.update(phase_kway_kernels(dev))
    for name, e in phase_rawfloat_kernels(dev).items():
        err[name] = max(err[name], e)
    for name, e in phase_signed_zero_kernels(dev, K, SK, topk_block, capable_families).items():
        err[name] = max(err[name], e)
    guard("2")

    log(f"phase 3a: serve Qwen3-8B at full width {since()}")
    params, logits, smoke_logits, launches = phase_serve(dev, K)
    guard("3a")
    log(f"phase 3b: the request scheduler at full width {since()}")
    runs = [launches, phase_engine(dev, K, params, card)]
    phase_invariance(dev, params, get_config("qwen3-8b"), card)
    guard("3b")
    log(f"phase 3c: --engine at smoke width {since()}")
    got, tick_rows, tick_k = phase_engine_smoke(dev, K, SK, 4, 32, 16, 64, 0.8)
    runs.append(got)
    guard("3c")
    log(f"phase 3d: the segmented library calls {since()}")
    runs.append(phase_seg_library(dev, K, SK))
    guard("3d")
    log(f"phase 3e: the library's merge and sort {since()}")
    runs.append(phase_library_merge_sort(dev))
    guard("3e")
    log(f"phase 3f: the k-way merge and the median {since()}")
    runs.append(phase_library_kway(dev))
    guard("3f")
    log(f"phase 3g: the schedule executor and the backends {since()}")
    got, no_kernel_rows = phase_schedule_backends(dev, logits, card)
    runs.append(got)
    log("  Qwen3-8B: the decode profile and the cost of the padded rows")
    profile_serve(dev, params, get_config("qwen3-8b"), card)
    decode_tile_cost(dev, params, get_config("qwen3-8b"), card)
    gqa_err = decode_vs_prefill(dev, params, get_config("qwen3-8b"), card)
    guard("3g")
    del params  # the MoE's 61 GB of weights need the room
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3h: qwen3-moe-30b-a3b at full width {since()}")

    def phase_3t(moe_params, moe_cfg):
        guard("3h")
        log(f"phase 3t: MoE through the request scheduler at full width {since()}")
        runs.append(phase_moe_engine(dev, K, moe_params, moe_cfg, card))
        guard("3t")
        log(f"phase 3v: the escape hatches and the family registry {since()}")
        runs.append(phase_switches(dev, K, moe_params, moe_cfg, card))
        guard("3v")

    runs.append(phase_moe(dev, K, card, then=phase_3t))
    guard("3h")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3i: deepseek-v2-lite-16b (MLA) at full width {since()}")
    runs.append(phase_moe(dev, K, card, "deepseek-v2-lite-16b", gqa_err))
    guard("3i")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3j: mamba2-780m (SSM) at full width {since()}")
    runs.append(phase_ssm(dev, K, card, "mamba2-780m", gqa_err))
    guard("3j")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3k: zamba2-2.7b (hybrid) at full width {since()}")
    runs.append(phase_ssm(dev, K, card, "zamba2-2.7b", gqa_err))
    guard("3k")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3l: internvl2-26b (vlm) at full width {since()}")
    runs.append(phase_vlm(dev, K, card))
    guard("3l")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3m: hubert-xlarge (audio encoder) at full width {since()}")
    phase_audio(dev, K, card)
    guard("3m")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3n: the telemetry layer (repro_torch.obs) {since()}")
    runs.append(phase_obs(dev, K))
    guard("3n")
    gc.collect()
    torch.cuda.empty_cache()
    t_op = time.perf_counter()
    for arch in DENSE_ARCHS:
        log(f"phase 3o: {arch} (dense) at full width {since()}")
        got, params, cfg, sampled = phase_dense(dev, K, card, arch)
        runs.append(got)
        guard(f"3o {arch}")
        if arch != DENSE_ARCHS[-1]:
            del params
            gc.collect()
            torch.cuda.empty_cache()
    t_o = time.perf_counter() - t_op
    log(f"phase 3p: the resilience layer at full width on {cfg.name} {since()}")
    got = phase_resilience(dev, K, card, params, cfg, sampled)
    log(f"  launches of 3p (failpoints armed; not counted on the main paths): "
        f"{ {n: c for n, c in got.items() if c} }")
    guard("3p")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phases 3o {t_o:.1f} s and 3p {time.perf_counter() - t_op - t_o:.1f} s")
    t_q = time.perf_counter()
    log(f"phase 3q: the trainer at full width {since()}")
    runs.append(phase_train(dev, K, card))
    guard("3q")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 3q {time.perf_counter() - t_q:.1f} s")
    log(f"phase 3r: distribution on NCCL, one rank a card {since()}")
    runs.append(phase_dist(card))
    guard("3r")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3s: sharded parameters through the model, one rank a card {since()}")
    runs.append(phase_sharded(card))
    guard("3s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3u: the four examples on the card {since()}")
    runs.append(phase_examples(dev, K, card))
    guard("3u")
    launches = {n: sum(r[n] for r in runs) for n in K.LAUNCHES}
    log(f"  launches over all the main paths: {launches}")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")

    log(f"phase 4: times {since()}")
    rows = phase_times(dev, K, logits, smoke_logits, launches, err, card, ops_per_s)
    rows += phase_seg_times(dev, SK, tick_rows, tick_k, launches, err, card, ops_per_s)
    rows += phase_merge_sort_times(dev, launches, err, card, ops_per_s)
    rows += phase_kway_times(dev, launches, err, card, ops_per_s)
    guard("4")
    DISK_BYTES["builds"] = _tree_bytes(build.build_dir())
    log(f"  total {time.perf_counter() - t_start:.1f} s; disk written by the script's own "
        f"files {sum(DISK_BYTES.values()) / 1e9:.2f} GB (3q's checkpoints "
        f"{DISK_BYTES['checkpoints'] / 1e9:.2f} GB, the kernel builds "
        f"{DISK_BYTES['builds'] / 1e6:.1f} MB); {card}")
    log("  routes without a kernel (phase 3g): " + json.dumps(no_kernel_rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
