"""Training launcher of the port.

  python -m repro_torch.launch.train --arch qwen3-8b --smoke --steps 3 --device cpu
  python -m repro_torch.launch.train --arch qwen3-8b --steps 50 --batch 4 --seq 128 \\
      [--retries 2] [--ckpt-dir DIR] [--remat none|dots|full]

(with ``src`` on ``PYTHONPATH``). The flags are those of
``repro.launch.train`` plus ``--device`` (default ``cuda``; ``cpu`` only
when asked). Float32 master weights from seed 0, AdamW, the synthetic
token stream (or ``--data-bin``, a uint32 token file); any fault restarts
from the latest atomic checkpoint (``repro_torch.runtime``). A full-width
config's training state is 16 bytes a parameter: Qwen3-8B's 8.2 B
parameters do not fit one 80 GB card, a few of its layers do.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--data-bin", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import TrainConfig, train_with_retries

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, bin_path=args.data_bin)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, remat=args.remat)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps)
    out = train_with_retries(cfg, dc, tc, oc, retries=args.retries, device=dev)
    print(f"[launch] done: final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
