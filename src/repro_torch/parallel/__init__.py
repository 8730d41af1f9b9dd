"""repro_torch.parallel — distribution on ``torch.distributed`` (counterpart
of ``repro.parallel``).

Process model. ``torch.distributed`` is SPMD: one process a rank, each
running the same program. The reference instead traces one program over
a ``jax.sharding.Mesh`` and lets ``shard_map`` run its body on every
device. Here:

* :class:`~.sharding.Parallelism` holds a
  ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the
  reference's axis names (``"data"``, ``"model"``, and ``"pod"`` where
  given); the process group of an axis is ``mesh.get_group(name)``, a
  rank's coordinate on it ``mesh.get_local_rank(name)``.
* The entry points keep the reference's contract, "full logical arrays
  in, full logical arrays out": every rank passes the same full tensor,
  takes its slice by its coordinate on the axis, and returns the full
  result. Beside each one sits its local form (the counterpart of the
  ``shard_map`` body: the rank's slice in, the rank's slice out), which
  takes the axis's process group where the reference's body takes an
  ``axis_name`` (:func:`~.dist_sort.sample_sort_local`,
  :func:`~repro_torch.streaming.tree.tree_topk_local`,
  :func:`~.pipeline.pipeline_apply_local`,
  :func:`~.compress.compressed_psum`,
  :func:`repro_torch.models.moe.moe_ffn_local`).
* The mesh's device type decides where the work runs: ``"cuda"`` is
  NCCL, one rank a card, each rank on ``cuda:<local rank>``
  (:func:`~.sharding.init_mesh` sets it); ``"cpu"`` is gloo, which only
  the tests ask for. A CUDA mesh without a card raises, as
  :func:`repro_torch.device.resolve_device` does.
* The model stack under ``par`` (:mod:`.spmd`): parameters and caches
  are DTensors placed by their specs, activations this rank's rows, the
  TP regions entered and left by explicit collectives.
* ``shard_map_compat`` has no counterpart: there is no tracer to hand a
  body to; each rank runs its local form eagerly.
* Every rank must make the same calls in the same order, as under any
  collective; see :mod:`repro_torch.resilience.ladder` for what that asks
  of the degradation ladder.
"""
from .compress import compress, compress_tree, compressed_psum, decompress  # noqa: F401
from .dist_sort import (DIST_MIN_TOTAL, sample_merge_k, sample_merge_k_local,  # noqa: F401
                        sample_sort, sample_sort_local)
from .pipeline import pipeline_apply, pipeline_apply_local  # noqa: F401
from .sharding import (LOGICAL_RULES, Parallelism, PSpec, axis_sizes, batch_pspecs,  # noqa: F401
                       build_param_pspecs, cache_pspecs, dist_sort_axis, full_params,
                       init_mesh, make_parallelism, shard_params, shard_tree, to_named,
                       vocab_topk_axis)
