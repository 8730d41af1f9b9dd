"""Production meshes (counterpart of ``repro.launch.mesh``). Functions, not
constants: importing this module touches no device and no process group.

Each builds a ``DeviceMesh`` over the default process group with
:func:`repro_torch.parallel.init_mesh`, so the group must exist and hold
as many ranks as the mesh (one process a rank: ``torchrun``, or the
dry-run's fake group). ``device_type`` ``"cuda"`` pins each rank to its
card and raises without one.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One pod: 256 ranks as (data=16, model=16). Two pods: 512 ranks as
    (pod=2, data=16, model=16); the ``pod`` axis carries only data
    parallelism (the gradient's all-reduce crosses between pods)."""
    from repro_torch.parallel.sharding import init_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """The process group's ranks as (data=world // model, model)."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import init_mesh

    if not dist.is_initialized():
        raise RuntimeError("init_process_group first (nccl for cuda, gloo for cpu)")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide {n} ranks")
    return init_mesh(device_type, (n // model, model), ("data", "model"))
