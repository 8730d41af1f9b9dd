"""Serving example of the PyTorch port: batched generation with the LOMS
top-k sampler on a smoke-width config.

  PYTHONPATH=src python examples/torch_serve_topk.py [--arch qwen3-8b] [--device cpu]

The counterpart of ``examples/serve_topk.py``; it runs on the card unless
``--device cpu`` asks for the CPU, and returns ``generate``'s output.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model_init
from repro_torch.serving.engine import ServeConfig, generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = model_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, 32)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    out = generate(params, batch, cfg,
                   ServeConfig(max_new_tokens=args.new_tokens, top_k=16, temperature=0.8),
                   device=dev)
    print("generated:", out["tokens"])
    print(f"{out['tok_per_s']:.1f} tok/s (LOMS top-k sampler) on {dev}")
    return out


if __name__ == "__main__":
    main()
