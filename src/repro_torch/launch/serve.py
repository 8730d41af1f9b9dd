"""Serving launcher of the port: batched generation with LOMS top-k sampling.

  python -m repro_torch.launch.serve --arch qwen3-8b \
      --batch 4 --prompt-len 32 --new-tokens 16 --top-k 16
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
  python -m repro_torch.launch.serve --arch mamba2-780m
  python -m repro_torch.launch.serve --arch zamba2-2.7b
  python -m repro_torch.launch.serve --arch internvl2-26b

(with ``src`` on ``PYTHONPATH``). The flags are those of
``repro.launch.serve`` plus ``--device`` (default ``cuda``; ``cpu`` only
when asked). The dense and MoE families serve, DeepSeek-V2-Lite's MLA
included, the SSM (mamba2-780m) and hybrid (zamba2-2.7b) families, and
the vlm family (internvl2-26b): its ``frontend_len`` image patches of
``frontend_dim`` float32 are drawn from the launcher's generator after
the tokens, as the reference launcher draws them. An encoder-only config
(hubert-xlarge) has no decode and is refused before any weight is drawn.
Weights are random, drawn from seed 0. ``--ragged`` draws a
length per request in [1, prompt_len] and right-pads the batch
(attention caches of token prompts only: the SSM, hybrid and vlm
families raise).
``--engine`` serves the same requests through the request scheduler
(paged slots, continuous batching; ``--slots``, ``--page-size``; dense
stacks only, as in the reference launcher): request r arrives at tick r
with seed r.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="random per-request prompt lengths in "
                         "[1, prompt_len], right-padded")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--engine", action="store_true",
                    help="serve through the request scheduler "
                         "(paged slots + continuous batching)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model_init
    from repro_torch.serving.engine import ServeConfig, generate

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    assert not cfg.is_encoder_only, f"{cfg.name} is encoder-only: no decode"
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    rng = np.random.default_rng(0)
    lengths = None
    if args.ragged:
        lengths = rng.integers(1, args.prompt_len + 1, args.batch).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    if lengths is not None:
        for r, n in enumerate(lengths):  # right-pad past each valid length
            tokens[r, n:] = 0
    if args.engine:
        import math

        from repro_torch.serving.scheduler import (SamplingParams, ScheduledEngine,
                                                   SchedulerConfig)

        assert cfg.family == "dense", \
            "--engine bit-equality contract covers dense stacks"
        lens = lengths if lengths is not None \
            else np.full(args.batch, args.prompt_len, np.int32)
        pages = math.ceil((args.prompt_len + args.new_tokens) / args.page_size)
        eng = ScheduledEngine(params, cfg, SchedulerConfig(
            n_slots=args.slots, page_size=args.page_size, pages_per_slot=pages),
            device=dev)
        rids = [eng.submit(tokens[r, :lens[r]],
                           SamplingParams(k=args.top_k, top_p=args.top_p,
                                          temperature=args.temperature,
                                          max_new_tokens=args.new_tokens, seed=r),
                           arrival=r)
                for r in range(args.batch)]
        out = eng.run()
        print(f"[serve] engine drained {len(out)} requests in {eng.t} ticks "
              f"({args.slots} slots, page {args.page_size})")
        for rid in rids[:2]:
            print(f"  rid {rid}: {out[rid]}")
        return {"engine": eng, "tokens": out, "rids": rids}

    batch = {"tokens": tokens}
    if lengths is not None:
        batch["lengths"] = lengths
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    out = generate(params, batch, cfg,
                   ServeConfig(max_new_tokens=args.new_tokens, top_k=args.top_k,
                               top_p=args.top_p, temperature=args.temperature),
                   device=dev)
    print(f"[serve] tokens shape {out['tokens'].shape} "
          f"prefill {out['prefill_s']*1e3:.1f}ms "
          f"decode {out['tok_per_s']:.1f} tok/s")
    print(out["tokens"][:2])
    return out


if __name__ == "__main__":
    main()
