#!/usr/bin/env python3
"""Time the decode step of full-width dense models on one CUDA card, for
one copy of the port's package:

  python3 scripts/time_decode_step.py [--src DIR] [--label NAME]
                                      [--arch qwen3-8b --arch qwen1.5-32b ...]

Each model is built at its published width and depth with random bf16
weights from seed 0 and served as ``chip_smoke.py``'s phases 3a and 3o
serve it: ``generate`` at B = 4 on a 128-token prompt, 16 new tokens,
top-k 64 at temperature 0.8. After one warm run, three runs give the
decode step's p50 and p99 (host clock, the engine's own timing). Then
``torch.profiler`` over eight decode steps gives the device time a step:
all kernels, and the share of the kernels whose names hold ``cat`` or
``copy`` (a same-type copy that runs as a device-to-device memcpy, such
as the copy inside ``pad_decode_rows`` of ``models/attention.py``, is
not among them; the whole step's device time holds it).

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two versions of the package (say a
parent commit unpacked with ``git archive``) can be timed in turns on one
card. Each model prints one JSON line with the label and the card's name
and power limit as nvidia-smi reports them.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--arch", action="append")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, model_init, prefill
    from repro_torch.serving import ServeConfig, generate, make_serve_step

    if not torch.cuda.is_available():
        print("time_decode_step: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    bsz, plen, new, k, temp = 4, 128, 16, 64, 0.8
    for arch in args.arch or ["qwen3-8b", "qwen1.5-32b"]:
        cfg = get_config(arch)
        params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (bsz, plen)).astype(np.int32)
        sc = ServeConfig(max_new_tokens=new, top_k=k, temperature=temp, seed=0, time_steps=True)
        with torch.inference_mode():
            generate(params, {"tokens": toks}, cfg, sc, device=dev)  # warm
            p50, p99 = [], []
            for _ in range(3):
                o = generate(params, {"tokens": toks}, cfg, sc, device=dev)
                p50.append(o["decode_step_p50_us"] / 1e3)
                p99.append(o["decode_step_p99_us"] / 1e3)

            steps = 8
            step = make_serve_step(cfg, top_k=k, temperature=temp)
            gen = torch.Generator(device=dev).manual_seed(0)
            cache = init_cache(cfg, bsz, plen + steps + 2, dev)
            logits, cache = prefill(params, {"tokens": torch.from_numpy(toks).to(dev)},
                                    cache, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

            def pos(i):
                return torch.full((bsz, 1), plen + i, dtype=torch.int32, device=dev)

            tok, cache = step(params, tok, cache, pos(0), gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(1, steps + 1):
                    tok, cache = step(params, tok, cache, pos(i), gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        busy_us, copy_us = 0.0, 0.0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0)
            busy_us += t
            if "cat" in ev.key.lower() or "copy" in ev.key.lower():
                copy_us += t
        print(json.dumps({
            "label": args.label, "arch": arch, "batch": bsz, "prompt": plen, "new": new,
            "step_p50_ms": p50, "step_p99_ms": p99,
            "profiled_step_wall_ms": wall_ms, "device_ms_per_step": busy_us / steps / 1e3,
            "copy_kernels_ms_per_step": copy_us / steps / 1e3, "card": card}), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
