"""repro_torch — the PyTorch and CUDA port of the LOMS sorting system.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch around hand-written CUDA kernels for Hopper
(``csrc/``). It imports neither JAX nor the JAX package. Entry points run
on the card unless the caller passes ``device="cpu"`` or a CPU tensor.
``repro_torch.obs`` is the telemetry layer (spans, metrics, timing, the
flight recorder, export), inert unless ``REPRO_OBS`` is set;
``repro_torch.resilience`` the failpoints, circuit breakers and the
degradation ladder every op runs through.
"""
from repro_torch import obs, resilience  # noqa: F401
from .api import (Backend, Decision, SortSpec, backend_names,  # noqa: F401
                  decision_table, get_backend, median_of_lists, merge, merge_k, plan,
                  register_backend, segment_argmax, segment_merge, segment_sort,
                  segment_topk, sort, topk)
from .streaming import chunked_merge, chunked_merge_k  # noqa: F401

__all__ = ["obs", "resilience", "merge", "merge_k", "sort", "median_of_lists", "chunked_merge",
           "chunked_merge_k", "topk", "segment_sort", "segment_merge", "segment_topk",
           "segment_argmax", "Backend", "Decision", "SortSpec", "plan",
           "register_backend", "get_backend", "backend_names", "decision_table"]
