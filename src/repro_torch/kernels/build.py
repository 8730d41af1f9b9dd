"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

nvcc compiles each ``.cu`` file into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), and ctypes loads
it; the sources share the headers ``csrc/*.cuh``. Builds happen at first use, never at import, into
``repro_torch/_build/`` (listed in ``.gitignore``; ``REPRO_TORCH_BUILD_DIR``
overrides it). A library is named by the hash of its source and flags, so
an edited source rebuilds and an unchanged one loads at once. All sources
build in parallel: one nvcc per file, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`build_all` spent, and nvcc's ptxas report per source
BUILD_INFO: Dict[str, object] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", PKG_DIR / "_build"))


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by the hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, all
    nvcc processes at once; raise with nvcc's output if one fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    todo = [src for src in sources if not _lib_path(src).exists()]
    t0 = time.perf_counter()
    jobs = []
    if todo:
        nvcc = find_nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src.stem, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        BUILD_INFO[f"ptxas_{name}"] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["built"] = [name for name, *_ in jobs]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src.stem: _lib_path(src) for src in sources}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _LIBS[name] = lib
        return lib
