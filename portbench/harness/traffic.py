"""The one traffic generator: a mix's parameters and a seed -> requests.

A mix file (``portbench/traffic/<mix>.json``) gives:

* ``prompt``: ``{"median", "sigma", "min", "max"}``: log-normal lengths
  clipped to ``[min, max]``, at any length;
* ``output``: ``{"min", "max"}``: new tokens, uniform;
* ``greedy_share``, ``k``, ``temperature``: the sampling of a request
  (greedy, or top-k at a temperature);
* ``block``: requests come in blocks of this many. Each block holds the
  same set of sizes, whatever the seed: the lengths at the block's evenly
  spaced quantiles, the output lengths evenly spaced, exactly
  ``round(block * greedy_share)`` greedy requests. The seed permutes each
  of the three within every block and draws the tokens (uniform over the
  vocabulary) and each request's sampling seed. So two seeds give the
  same work in another order. (A fixed well-mixed order that the seed
  only rotated made the dense cell's runs spread wider, not narrower:
  PERF.md.)

``lead`` (the stream's, not the mix's: a cell's clients) sets the first
``lead`` requests apart as a block of their own, the clients' first
wave; the blocks of ``block`` follow it. So a window that opens once the
first wave has ended starts at a block's first request.

Request ``i`` depends only on the seed, ``lead`` and ``i``.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    index: int
    prompt_len: int
    max_new_tokens: int
    greedy: bool
    k: int
    temperature: float
    seed: int  # the request's own sampling seed


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def prompt_lengths(mix: dict, n: int) -> List[int]:
    """The ``n`` evenly spaced quantiles of the mix's length distribution."""
    p = mix["prompt"]
    out = []
    for j in range(n):
        z = NormalDist().inv_cdf((j + 0.5) / n)
        x = min(max(p["median"] * math.exp(p["sigma"] * z), p["min"]), p["max"])
        out.append(min(int(math.ceil(x)), p["max"]))
    return out


def output_lengths(mix: dict, n: int) -> List[int]:
    o = mix["output"]
    span = o["max"] - o["min"] + 1
    return [o["min"] + int((j + 0.5) * span / n) for j in range(n)]


class RequestStream:
    """The requests of a mix for a seed, in the order the clients send
    them; :meth:`tokens` gives a request's prompt."""

    def __init__(self, mix: dict, seed: int, vocab: int, lead: int = 0):
        self.mix = mix
        self.seed = _seed(seed)
        self.vocab = int(vocab)
        self.block = int(mix["block"])
        self.lead = int(lead)
        self._blocks = {}

    def _block(self, b: int) -> List[RequestSpec]:
        """Block ``b``; block -1 is the lead."""
        got = self._blocks.get(b)
        if got is None:
            n = self.lead if b < 0 else self.block
            first = 0 if b < 0 else self.lead + b * self.block
            rng = np.random.default_rng([self.seed, 1, b + 1])
            lens = rng.permutation(prompt_lengths(self.mix, n))
            outs = rng.permutation(output_lengths(self.mix, n))
            greedy = rng.permutation(np.arange(n) < int(round(n * self.mix["greedy_share"])))
            seeds = rng.integers(0, 1 << 31, n)
            got = [RequestSpec(index=first + j, prompt_len=int(lens[j]),
                               max_new_tokens=int(outs[j]), greedy=bool(greedy[j]),
                               k=int(self.mix["k"]),
                               temperature=0.0 if greedy[j] else float(self.mix["temperature"]),
                               seed=int(seeds[j]))
                   for j in range(n)]
            self._blocks = {b: got}  # one block at a time is enough
        return got

    def spec(self, i: int) -> RequestSpec:
        if i < self.lead:
            return self._block(-1)[i]
        return self._block((i - self.lead) // self.block)[(i - self.lead) % self.block]

    def tokens(self, spec: RequestSpec) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, spec.index])
        return rng.integers(0, self.vocab, spec.prompt_len, dtype=np.int64).astype(np.int32)
