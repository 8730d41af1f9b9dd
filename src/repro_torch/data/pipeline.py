"""Deterministic sharded token pipeline (synthetic + memmapped bin files).

The port's own copy of ``repro.data.pipeline`` (numpy only): for one
``(seed, step, host_index)`` its batches are bit-equal to the reference's.

Resume contract: the pipeline is a pure function of (seed, step), so a
restarted job at step N sees exactly the batches it would have seen — no
iterator state beyond the step counter needs checkpointing. Each host
materializes only its slice (``host_count``/``host_index``), matching the
multi-host data-loading pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    bin_path: Optional[str] = None  # memmapped uint16/uint32 token file
    host_index: int = 0
    host_count: int = 1


class TokenPipeline:
    """get_batch(step) -> {'tokens','targets'} host-local numpy arrays."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        if dc.global_batch % dc.host_count:
            raise ValueError(f"global_batch {dc.global_batch} does not split over "
                             f"{dc.host_count} hosts")
        self.local_batch = dc.global_batch // dc.host_count
        self._mm = None
        if dc.bin_path:
            self._mm = np.memmap(dc.bin_path, dtype=np.uint32, mode="r")

    def _tokens(self, step: int) -> np.ndarray:
        b, s = self.local_batch, self.dc.seq_len
        if self._mm is not None:
            n_tok = self._mm.shape[0]
            rng = np.random.default_rng((self.dc.seed, step))
            starts = rng.integers(0, n_tok - s - 1, size=(self.dc.global_batch,))
            starts = starts[self.dc.host_index * b : (self.dc.host_index + 1) * b]
            # read the memmap in offset order (sequential-ish I/O instead of
            # b random seeks) and scatter rows back to their batch slots, so
            # the emitted batch is bit-identical to the unsorted read
            order = np.argsort(starts)
            rows = np.stack([self._mm[st : st + s + 1] for st in starts[order]])
            out = np.empty_like(rows)
            out[order] = rows
            return out.astype(np.int32) % self.cfg.vocab_size
        rng = np.random.default_rng(
            (self.dc.seed, step, self.dc.host_index))
        # synthetic: markovian-ish stream so the loss actually decreases
        base = rng.integers(0, self.cfg.vocab_size, size=(b, s + 1), dtype=np.int64)
        drift = np.cumsum(rng.integers(0, 3, size=(b, s + 1)), axis=1)
        return ((base // 7 + drift) % self.cfg.vocab_size).astype(np.int32)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens(step)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.family == "vlm":
            rng = np.random.default_rng((self.dc.seed, step, 99))
            batch["patches"] = rng.standard_normal(
                (self.local_batch, self.cfg.frontend_len, self.cfg.frontend_dim)
            ).astype(np.float32)
        if self.cfg.family == "audio":
            rng = np.random.default_rng((self.dc.seed, step, 98))
            frames = rng.standard_normal(
                (self.local_batch, self.dc.seq_len, self.cfg.frontend_dim)
            ).astype(np.float32)
            batch = {"frames": frames, "targets": batch["targets"]}
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.get_batch(step)
            step += 1
