"""Fault-tolerant training runtime: the step, the watchdog, the retry loop
(counterpart of ``repro.runtime.train_loop``).

Failure model, as the reference's:
  * a fault ends the attempt; :func:`train_with_retries` (the launcher's
    ``--retries``) starts another, which resumes from the latest atomic
    checkpoint, and the data pipeline is a pure function of the step, so
    no batch repeats or is skipped;
  * straggler steps: a step slower than ``straggler_factor`` x the
    running median is flagged, counted and logged.

The step is eager PyTorch: the loss and its backward (autograd, with the
flash-attention backward and ``remat``), then AdamW in place on float32
master weights. Nothing is compiled, so the reference's ``donate``
(buffer donation to ``jax.jit``) has no counterpart: the in-place update
already holds one copy of the state. ``train`` runs on the card unless
``device="cpu"``.

With ``par`` (one process a rank, each with the same data pipeline and
seed) the float32 masters and the moments are DTensors placed by the
model's specs (FSDP over ``data``, TP over ``model``), each rank runs
its rows of the batch (the batch splits over the dp axes), the
gradients come back reduce-scattered to the parameters' placements,
and the checkpoints hold the full arrays (rank 0 writes them).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import loss_fn, model_init
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.timing import time_once
from repro_torch.obs.trace import span
from repro_torch.optim import OptConfig, opt_init, opt_update
from repro_torch.optim.adamw import leaves


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    #: the reference's /tmp/repro_ckpt, under the process's temporary directory
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    log_every: int = 10
    straggler_factor: float = 3.0
    remat: str = "none"
    seed: int = 0


def make_train_step(cfg: ModelConfig, oc: OptConfig, par=None, remat="none"):
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient with respect to every parameter
    leaf, then :func:`~repro_torch.optim.opt_update` (in place); metrics
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors. With ``par`` the
    leaves may be sharded (:func:`~repro_torch.parallel.shard_params`)
    and the batch is the full one on every rank."""
    from repro_torch.models.model import _check_par

    _check_par(par)

    def step_fn(params, opt_state, batch):
        ps = leaves(params)
        for t in ps:
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, batch, cfg, par=par, remat=remat)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for t in ps:
                t.requires_grad_(False)
        # a leaf the loss does not reach (vlm's patch_proj without patches)
        # has a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ps)]
        _, opt_state, metrics = opt_update(grads, opt_state, ps, oc)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step_fn


class StragglerMonitor:
    def __init__(self, factor: float):
        self.factor = factor
        self.times = []
        self.flagged = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        med = float(np.median(self.times[-50:]))
        if dt > self.factor * med:
            self.flagged += 1
            return True
        return False


def train(
    cfg: ModelConfig,
    dc: DataConfig,
    tc: TrainConfig,
    oc: OptConfig,
    par=None,
    fail_at_step: Optional[int] = None,  # fault-injection hook for tests
    device: DeviceLike = None,
) -> dict:
    """Run (or resume) training; returns ``{"losses", "final_loss",
    "stragglers", "params"}`` as the reference's ``train`` does."""
    from repro_torch.models.model import _check_par

    _check_par(par)
    dev = resolve_device(device)
    pipeline = TokenPipeline(cfg, dc)
    ckpt = CheckpointManager(tc.ckpt_dir, par=par)

    placed = {} if par is None else {"par": par}  # each part placed as it is drawn
    params = model_init(torch.Generator(device=dev).manual_seed(tc.seed), cfg, dev,
                        torch.float32, **placed)
    opt_state = opt_init(params)
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        # into the fresh tensors: a resume holds one training state
        (params, opt_state), extra = ckpt.restore(latest, (params, opt_state),
                                                  in_place=True)
        start_step = extra["step"]
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, oc, par=par, remat=tc.remat)
    mon = StragglerMonitor(tc.straggler_factor)
    losses = []
    try:
        for step in range(start_step, tc.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipeline.get_batch(step).items()}
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected fault at step {step}")
            # one synchronised measurement a step: the dt feeds the
            # StragglerMonitor and, with REPRO_OBS on, a train.step span and
            # the step-time histogram
            with span("train.step", kind="run", step=step):
                (params, opt_state, metrics), dt = time_once(
                    step_fn, params, opt_state, batch)
            loss = float(metrics["loss"])
            obs_metrics.counter("train.steps").inc()
            obs_metrics.histogram("train.step_ms").observe(dt * 1e3)
            if mon.record(dt):
                obs_metrics.counter("train.stragglers").inc()
                print(f"[train] STRAGGLER step {step}: {dt:.3f}s "
                      f"(median {np.median(mon.times[-50:]):.3f}s)")
            losses.append(loss)
            if step % tc.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                ckpt.save(step + 1, (params, opt_state))
    finally:
        # a save in flight when a step fails is finished, so the next attempt
        # resumes from it (the reference's thread may still be writing when
        # its restart looks for the latest step)
        ckpt.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "stragglers": mon.flagged, "params": params}


def train_with_retries(cfg, dc, tc, oc, retries: int = 2, **kw):
    """Launcher-level fault tolerance: restart on failure, resuming from
    the latest checkpoint each time."""
    attempt = 0
    while True:
        try:
            return train(cfg, dc, tc, oc, **kw)
        except Exception as e:  # noqa: BLE001 — any fault triggers a restart
            attempt += 1
            if attempt > retries:
                raise
            print(f"[train] attempt {attempt} failed ({e}); restarting from "
                  f"latest checkpoint")
            kw["fail_at_step"] = None  # the injected fault fires once
