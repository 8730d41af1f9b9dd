"""Carry a parameter tree of the JAX package over to the port.

``params_from_jax`` takes the reference's ``model_init`` tree with every
leaf turned into a numpy array (the caller converts; this module imports
no JAX) and returns the port's parameters, so that both packages compute
the same function. The stacked ``stack/body`` leaves, with their leading
layer axis (the MoE router and expert weights too), become one dict per
layer; the unscanned ``stack/head`` blocks of a MoE stack carry over as
they are. MLA's leaves (``wq``, ``wuk`` and ``wuv`` 3-D, ``wdkv``,
``kv_norm``, ``wo``) and an SSM block's (``norm``, and the mixer's
``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
``norm``, ``out_proj``) carry over as every other leaf does; so does the
hybrid's unstacked ``stack/shared`` block, and the frontends' top-level
``frontend`` (audio) and ``patch_proj`` (vlm) denses.
``opt_state_from_jax`` carries the reference's AdamW state over the same
way.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .transformer import check_family


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Mapping, cfg: ModelConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Reference parameter tree (numpy leaves) -> port parameters in
    ``dtype`` (default ``cfg.dtype``, as served; the trainer's float32
    masters with ``torch.float32``) on ``device``."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dt)

    body = tree["stack"]["body"]
    n_layers = int(np.shape(next(_leaves(body)))[0])
    out = {k: _map(v, leaf) for k, v in tree.items() if k != "stack"}
    out["stack"] = {"body": [_map(body, lambda a, i=i: leaf(np.asarray(a)[i]))
                             for i in range(n_layers)]}
    if "head" in tree["stack"]:
        out["stack"]["head"] = [_map(h, leaf) for h in tree["stack"]["head"]]
    if "shared" in tree["stack"]:
        out["stack"]["shared"] = _map(tree["stack"]["shared"], leaf)
    return out


def opt_state_from_jax(tree: Mapping, cfg: ModelConfig, device: DeviceLike = None) -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves)
    -> the port's: float32 moments in the port's parameter layout and the
    int32 step, on ``device``."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(tree["mu"], cfg, dev, torch.float32),
            "nu": params_from_jax(tree["nu"], cfg, dev, torch.float32),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                 device=dev)}
