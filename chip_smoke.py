#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

  python3 chip_smoke.py

Finds ``src/repro_torch`` beside this file by itself (no PYTHONPATH) and
imports neither JAX nor the JAX package. Phases, each of which ends the
script with a non-zero exit code when it fails:

1. environment, the card's name and power limit, and the kernel build
   (nvcc, from ``src/repro_torch/csrc/`` only);
2. every CUDA kernel against its plain PyTorch version on the card,
   bit-equal values and indices, in bf16 and f32, on rows that hold NaN,
   ±inf, ±0.0 and many ties;
3. the main path: ``generate`` on Qwen3-8B at full width (bf16, random
   weights from seed 0), batch 4, prompt 128, 16 new tokens, top_k 64,
   temperature 0.8; the same with ragged prompt lengths; once greedy; and
   the launcher on the smoke-width config (vocab 256: the router kernel).
   Launch counts are zeroed just before each run and read just after it;
   each run's first-step candidates and token (the full-width sampled run
   and the launcher's) are checked against the plain top-k;
4. times (CUDA events) of every kernel beside its bound, its plain
   version and ``torch.topk`` on the same input (a yardstick the port
   never calls).

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
    x[1, -5:] = [-0.0, 0.0, np.inf, np.nan, -np.inf]
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
        for k in (64, 16, 256):
            b, v = 8, 151_936
            x = special_logits(b, v, dtype, dev, seed=k)
            blk = topk_block(v, k)
            keys, idx = K.vocab_phase1(x, k, blk)
            pk, pi = K.vocab_phase1_plain(x, k, blk)
            err["vocab_phase1"] = max(err["vocab_phase1"], require_equal(
                f"phase1 k={k} {dtype}", (keys, idx), (pk, pi)))
            levels = 0
            while keys.shape[1] > 1:
                dec = dtype if keys.shape[1] == 2 else None
                got = K.vocab_merge_level(keys, idx, k, dec)
                want = K.vocab_merge_level_plain(keys, idx, k, dec)
                err["vocab_merge_level"] = max(err["vocab_merge_level"], require_equal(
                    f"merge level {levels} k={k} {dtype}", got, want))
                keys, idx = got
                levels += 1
            require_equal(f"vocab top-k k={k} {dtype}", K.vocab_topk(x, k, block=blk),
                          K.vocab_topk_plain(x, k, blk))
            log(f"  vocab B={b} V={v} k={k} block={blk} {dtype}: phase 1 and "
                f"{levels} merge levels bit-equal")
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
    levels = K.vocab_levels(vocab, blk)
    # one draw per new token: a sampled full-width run launches phase 1
    # and the merge tree per token, greedy launches nothing, and the
    # smoke-width launcher (vocab 256) the router kernel per token
    vocab_run = {"router_topk": 0, "vocab_phase1": new, "vocab_merge_level": new * levels}
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
        K.reset_launch_counts()
        outs[name] = run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  launches, {name} run: {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{name} run: launch counts {got} != {want}")
        for n, c in got.items():
            launches[n] += c
    log(f"  vocab block {blk}, {levels} merge levels per sampled token; "
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
    # merge levels: the whole tree of one sampled token, on phase 1's lists
    keys, idx = K.vocab_phase1(logits, k, vb)

    def tree(merge):
        kx, ix = keys, idx
        while kx.shape[1] > 1:
            kx, ix = merge(kx, ix, k, logits.dtype if kx.shape[1] == 2 else None)
        return kx, ix

    eager["vocab_merge_level"] = cuda_ms(lambda: tree(K.vocab_merge_level), 100)
    ms = graph_ms(lambda: tree(K.vocab_merge_level), 100)
    plain = graph_ms(lambda: tree(K.vocab_merge_level_plain), 5)
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
    from repro_torch.kernels import build
    from repro_torch.kernels import topk as K

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
    for line in str(build.BUILD_INFO.get("ptxas_topk", "")).splitlines():
        if "registers" in line or "spill" in line:
            log("   " + line.strip())

    log("phase 2: kernels against their plain versions")
    err = phase_kernels(dev, K, topk_block)

    log("phase 3: serve Qwen3-8B at full width")
    params, logits, smoke_logits, launches = phase_serve(dev, K)

    log("phase 4: times")
    rows = phase_times(dev, K, logits, smoke_logits, launches, err, card, ops_per_s)
    from repro_torch.configs import get_config

    profile_serve(dev, params, get_config("qwen3-8b"), card)
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
