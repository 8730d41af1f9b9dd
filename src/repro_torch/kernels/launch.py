"""What the CUDA wrappers of the kernels share: the libraries, the
key type codes, the payload-lane arguments, the program words on the
card, the input checks and the stream.

The kernels (``csrc/topk.cu``, ``segmented.cu``, ``merge.cu``,
``sort.cu``, ``grid_merge.cu``, ``kway.cu``) take raw pointers through a
plain C interface; the wrappers turn tensors into those arguments with these
helpers. Nothing here runs on the CPU path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch

#: payload lanes one launch carries
MAX_PAYLOADS = 8

#: key type code of the kernels: floats are encoded, int32 is taken raw
KEY_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
            torch.int32: 3}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each library's entry points and their argument types (all return an int)
_SIGNATURES = {
    "topk": {
        "repro_router_topk": [P, P, P, I, I, I, I, I, I, P],
        "repro_vocab_phase1": [P, P, P, P, P, I, I, I, I, I, I, I, I, P],
        "repro_vocab_phase1_parts": [P, P, P, P, I, I, I, I, I, I, I, I, P],
        "repro_vocab_merge_tree": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "segmented": {
        "repro_seg_sort": [P, P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, P],
        "repro_seg_merge": [P, P, P, P, P, P, P, I, P, P, P, I, I, I, I, I, I, P],
        "repro_seg_merge_rows": [P, P, P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "merge": {"repro_loms_merge2": [P, P, P, P, P, I, P, P, P, P, I, I, I, I, I, I, I, P],
              "repro_merge_tiles": [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, P],
              "repro_merge_rows": [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, P]},
    "sort": {"repro_loms_sort": [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I, P]},
    "grid_merge": {"repro_grid_merge2": [P, P, P, P, I, I, I, I, L, L, L, L, L, L, I, I, I,
                                         P]},
    "kway": {"repro_kway_merge": [P, P, I, I, P, P, I, P, P, P, I, I, I, I, I, I, P]},
}

#: lanes a thread of the sort executor of the fused sort and the class
#: sort (``csrc/program.cuh`` ``sort_plan``); 0: the launch plan's choice
SORT_LANES = 0
#: rows of the column stack a CTA of the tiled 2-way merge takes
#: (``csrc/merge.cu`` ``merge_tile_kernel``); 0: the plan's, which tiles
#: only the rows past a CTA's shared memory; > 0 forces that many rows a
#: tile on every row the tiled kernel takes
MERGE_TILE = 0
#: threads a row of the row-merge executor takes (``csrc/merge_rows.cuh``:
#: the 2-way merge's shared-memory rows and the class merge of the
#: single-level programs); 0: the plan's (``rows_plan``); a power of two
#: from 4 to 256 forces that many
MERGE_ROW_THREADS = 0
#: outputs a thread of the grid merge (``csrc/grid_merge.cu``), its tile
#: being that many times 256; 0: the wrapper's choice for the shape
#: (``streaming/grid_merge.py`` ``_items``); 1..16 forces that tile
GRID_ITEMS = 0
#: lists a CTA of the vocab merge tree merges (``csrc/topk.cu``
#: ``vocab_merge_tree_kernel``), a power of two >= 2; 0: the plan's
#: (``kernels/topk.py`` ``vocab_merge_plan``); > 0 forces that subtree size
#: on every launch but the last, which takes the rest
VOCAB_GROUP = 0
_LIBS: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with its argument types
    set, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        from .build import load

        lib = load(name)
        for fn, args in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_rc(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


_PROGRAMS: Dict[tuple, torch.Tensor] = {}


def program_tensor(device, kind: str, family: str, a: int, b: int = 0,
                   n_cols: Optional[int] = None) -> torch.Tensor:
    """The int32 words of a sort program (width ``a``) or a merge program
    (``a`` + ``b``) on ``device``, copied there once."""
    key = (str(device), kind, family, a, b, n_cols)
    t = _PROGRAMS.get(key)
    if t is None:
        from repro_torch.networks import encode_program, merge_program, sort_program

        levels = (sort_program(family, a).levels if kind == "sort"
                  else [merge_program(family, a, b, n_cols)])
        t = torch.tensor(encode_program(levels), dtype=torch.int32, device=device)
        _PROGRAMS[key] = t
    return t


@functools.lru_cache(maxsize=None)
def sort_prefix(family: str, width: int) -> int:
    """The S2MS levels at the bottom of the sort program, which the sort
    executor runs as one register sort (``networks.s2ms_prefix``)."""
    from repro_torch.networks import s2ms_prefix, sort_program

    return s2ms_prefix(sort_program(family, width))


def forget_family(family: str) -> None:
    """Drop what is kept by the name ``family`` (its programs on the card
    and its sort prefixes): ``networks.register_family`` calls it when a
    name is given a new family."""
    for key in [k for k in _PROGRAMS if k[2] == family]:
        del _PROGRAMS[key]
    sort_prefix.cache_clear()


def cuda_checks(what: str, tensors: Sequence[torch.Tensor], key_dtype: torch.dtype,
                n_payloads: int = 0) -> None:
    """Raise on what the kernels do not take: another key type, too many
    payload lanes, a tensor off the card, not contiguous or too large."""
    if key_dtype not in KEY_CODE:
        raise TypeError(f"the CUDA {what} takes float32, bfloat16, float16 or "
                        f"int32 values, not {key_dtype}")
    if n_payloads > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payload lanes, got {n_payloads}")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"tensor on {t.device}: every input of the CUDA "
                             f"{what} lies on the card")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA {what} takes contiguous tensors")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"tensor of shape {tuple(t.shape)} is too large")


def payload_args(payloads: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    """``(n, in pointers, out pointers, bytes of one lane element)``."""
    n = len(payloads)
    ins = (ctypes.c_void_p * MAX_PAYLOADS)(*[p.data_ptr() for p in payloads])
    pouts = (ctypes.c_void_p * MAX_PAYLOADS)(*[o.data_ptr() for o in outs])
    row_bytes = (ctypes.c_int * MAX_PAYLOADS)(
        *[(p[0, 0].numel() if p.shape[0] else 1) * p.element_size()
          for p in payloads])
    return n, ins, pouts, row_bytes


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def empty_payloads(payloads: Sequence[torch.Tensor], rows: int, width: int):
    """Outputs shaped like the payload lanes, ``width`` lanes a row."""
    return tuple(torch.empty((rows, width) + tuple(p.shape[2:]), dtype=p.dtype,
                             device=p.device) for p in payloads)
