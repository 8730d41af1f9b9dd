"""End-to-end driver of the PyTorch port: train a small MoE LM (the
deepseek-v2-lite family) with LOMS routing, with checkpoints and restart.

  PYTHONPATH=src python examples/torch_train_tiny_moe.py [--steps 200] [--device cpu]

The counterpart of ``examples/train_tiny_moe.py``: deepseek-v2-lite-16b's
smoke config widened to ``d_model=128``, ``n_layers=4``, through
``train_with_retries`` with a checkpoint every 50 steps into ``--ckpt-dir``
(by default a directory under the system's temporary directory; a second
run resumes from it unless ``--fresh``). It runs on the card unless
``--device cpu`` asks for the CPU, and returns ``train``'s output.
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.runtime import TrainConfig, train_with_retries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_tiny_moe"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("deepseek-v2-lite-16b")
    # widen it a little so that the loss curve means something
    cfg = dataclasses.replace(cfg, d_model=128, n_layers=4)
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    out = train_with_retries(
        cfg,
        DataConfig(seq_len=128, global_batch=8, seed=7),
        TrainConfig(steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir, log_every=20),
        OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        retries=2,
        device=dev,
    )
    print(f"loss: {out['losses'][0]:.3f} -> {out['final_loss']:.3f} "
          f"over {len(out['losses'])} steps on {dev}")
    return out


if __name__ == "__main__":
    main()
