"""Async, atomic checkpointing in the reference's layout (counterpart of
``repro.checkpoint.manager``).

Layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` per tree leaf, named by
its path (``_flatten_with_paths``: dict keys in sorted order, list and
tuple items as ``#i``, joined with ``__``), and ``manifest.json`` (step,
``extra``, each leaf's path, shape and dtype, the device count at save).
A save writes ``step_<N>.tmp`` and publishes it with one ``os.rename``,
so a crashed save never leaves a readable half checkpoint; the oldest
steps past ``keep_last`` are removed after each publish.

Saving is async: the leaves are copied to host memory before ``save``
returns (a copy of its own even for a leaf already on the host, since
the optimizer updates the live tensors in place while the thread
writes), then a thread writes them while training goes on; ``wait()``
joins it (``save`` calls it first, and the trainer before it returns).

bfloat16 leaves, which numpy has no type for, are written as their 16-bit
patterns (``<u2``) with the manifest naming ``bfloat16``, and come back
bit-exact. ``restore`` reads a checkpoint the reference wrote too: its
float32 and int32 leaves, and its bfloat16 leaves, which ``np.save``
writes as ``|V2`` and the reference's own ``restore`` cannot cast.

Sharded state (``CheckpointManager(..., par=...)``, leaves that are
DTensors): a save writes the full logical arrays, each leaf gathered by
every rank and written by rank 0 alone; ``wait`` ends with a barrier, so
no rank looks for the latest step before rank 0 has published it. A
restore places each leaf by its template leaf: a DTensor takes its own
block of the full array, so a checkpoint written on any mesh restores on
any other, and with no mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.adamw import map_tree


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _flatten_with_paths(tree, prefix=()):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (f"#{i}",))
    else:
        out.append((prefix, tree))
    return out


def _tree_set(tree, path, value):
    """Set the leaf at ``path``; returns the tree (a tuple on the path is
    rebuilt, since it cannot be assigned into)."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    key = int(head[1:]) if head.startswith("#") else head
    if isinstance(tree, tuple):
        items = list(tree)
        items[key] = _tree_set(items[key], rest, value)
        return tuple(items)
    tree[key] = _tree_set(tree[key], rest, value)
    return tree


def _to_host(v) -> Tuple[np.ndarray, str]:
    """A leaf as a host array of its own (never a view of the live leaf)
    and the dtype name the manifest records; a DTensor's full array."""
    if _is_dtensor(v):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(v)
    return a, str(a.dtype)


def _host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded leaf as a host tensor of the dtype the manifest names."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":  # the port's <u2 patterns or the reference's |V2
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _from_file(arr: np.ndarray, dtype_name: str, like):
    """A loaded leaf in ``like``'s type, on ``like``'s device; for a
    DTensor ``like``, its block of the array placed as it is."""
    t = _host_tensor(arr, dtype_name)
    if _is_dtensor(like):
        from torch.distributed.tensor import DTensor

        from repro_torch.parallel.sharding import local_chunk

        loc = local_chunk(t, like.device_mesh, like.placements)
        loc = loc.to(device=like.device, dtype=like.dtype, copy=True)
        return DTensor.from_local(loc, like.device_mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().astype(
        np.asarray(like).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, par=None):
        self.dir = directory
        self.keep_last = keep_last
        #: sharded state: every rank gathers, rank 0 writes
        self.par = par
        self.writer = par is None or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot ``state`` (a tree of tensors or arrays) to host memory,
        then write ``step_<step>`` (in a thread unless ``blocking``)."""
        self.wait()
        host = []
        for p, v in _flatten_with_paths(state):
            if not self.writer:  # the gathers only: every rank takes part
                if _is_dtensor(v):
                    v.full_tensor()
                continue
            arr, dt = _to_host(v)
            host.append(("/".join(p), arr, dt))
        if not self.writer:
            return
        manifest = {
            "step": int(step),
            "extra": extra or {},
            "leaves": [{"path": name, "shape": list(a.shape), "dtype": dt}
                       for name, a, dt in host],
            "n_devices_at_save": max(torch.cuda.device_count(), 1),
        }

        def _write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for name, arr, _ in host:
                np.save(os.path.join(tmp, name.replace("/", "__") + ".npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the save in flight; a write that failed raises here. With
        ``par``, every rank then waits for rank 0's write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
        if self.par is not None:
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any,
                in_place: bool = False) -> Tuple[Any, dict]:
        """Load ``step_<step>`` into the structure of ``template``: each
        leaf comes back in the template leaf's dtype, a tensor on the
        template tensor's device (an array for an array). Returns
        ``(state, extra | {"step": step})``; the template is not changed,
        unless ``in_place``.

        With ``in_place`` (a template of tensors) each leaf is copied into
        the template's own tensor, and the template is returned: a resume
        then holds one training state, not two."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
        state = template if in_place else map_tree(lambda leaf: leaf, template)
        for p, tmpl in _flatten_with_paths(template):
            name = "/".join(p)
            arr = np.load(os.path.join(path, name.replace("/", "__") + ".npy"))
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, the "
                                 f"template {tuple(tmpl.shape)}")
            if in_place and _is_dtensor(tmpl):
                from repro_torch.parallel.sharding import local_chunk

                tmpl.to_local().copy_(local_chunk(_host_tensor(arr, dtypes[name]),
                                                  tmpl.device_mesh, tmpl.placements))
            elif in_place:
                tmpl.copy_(_host_tensor(arr, dtypes[name]))  # from the host, no device copy
            else:
                state = _tree_set(state, p, _from_file(arr, dtypes[name], tmpl))
        return state, manifest["extra"] | {"step": manifest["step"]}
