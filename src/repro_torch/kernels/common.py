"""Plain PyTorch versions of the in-kernel primitives shared by the sorters.

Counterpart of ``repro.kernels.common``. These are the kernels' plain
versions: the CPU path of every wrapper, and what ``chip_smoke.py`` holds
each CUDA kernel against on the card. They are written as the reference
writes them (comparison clouds, then an exact scatter permute), so that
their tie order is the reference's:

* ``ranks_sort`` is a stable ascending rank (equal keys keep their order);
* ``ranks_merge2`` merges two ascending runs with the first run winning
  ties.

Encoded keys and integers take the exact scatter permute (the reference's
``use_mxu=False``). Raw floats take :func:`onehot_permute`, the rule of
the reference's float32 one-hot matrix permute (``use_mxu=True``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: float itemsize -> same-width signed integer type carrying the bit trick
KEY_ITYPE = {2: torch.int16, 4: torch.int32}

#: bit pattern of the canonical quiet NaN that every NaN maps to
_CANONICAL_NAN = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC0,
                  torch.float16: 0x7E00}


def key_transformable(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is a float type the total-order key map covers."""
    return dtype in _CANONICAL_NAN


def encode_key_values(x: torch.Tensor) -> torch.Tensor:
    """Float tensor -> int32 keys with the same sort order, NaNs last.

    Bijective and strictly monotonic over every float (finite, ±0, ±inf):
    -0.0 stays below +0.0. NaNs canonicalise to the positive quiet NaN,
    which maps above ``key(+inf)``. bf16/f16 bitcast to int16 and f32 to
    int32; every key widens to int32."""
    itype = KEY_ITYPE[x.element_size()]
    mask = torch.iinfo(itype).max  # 0x7fff..: flip all but the sign
    y = x.view(itype).masked_fill(torch.isnan(x), _CANONICAL_NAN[x.dtype])
    return torch.where(y < 0, y ^ mask, y).to(torch.int32)


def decode_key_values(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`encode_key_values` (``dtype`` = the
    original float type). The downcast to a 16-bit key wraps, as the
    reference's ``astype`` does, so pad keys decode to the same bits."""
    itype = KEY_ITYPE[torch.empty((), dtype=dtype).element_size()]
    mask = torch.iinfo(itype).max
    k = k.to(torch.int32)
    if itype == torch.int16:
        y = (((k & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
    else:
        y = k
    y = torch.where(y < 0, y ^ mask, y)
    return y.view(dtype)


def tie_signed_zeros(keys: torch.Tensor) -> torch.Tensor:
    """Total-order float keys with -0.0's (-1, in every float dtype) made
    +0.0's (0): under ``nan_policy="unsafe"`` the two tie, as the
    reference's raw comparison ties them. No other float encodes to -1."""
    return keys.masked_fill(keys == -1, 0)


def check_mode(dtype: torch.dtype, key_dtype: Optional[torch.dtype],
               use_mxu: bool, n_payloads: int = 0) -> None:
    """The value modes of the merge, sort and k-way kernels: float rows
    as total-order keys (``key_dtype`` = their dtype), int32 rows as
    keys, or float rows raw with the reference's one-hot permute
    (``use_mxu``, no ``key_dtype``; positions, but no payload lanes)."""
    if use_mxu and n_payloads:
        raise NotImplementedError(
            "payload lanes in the raw-float mode: the colliding positions of a NaN "
            "row index past the row; the reference's callers carry none there")
    if key_dtype is not None and key_dtype != dtype:
        raise ValueError(f"key_dtype {key_dtype} is not the rows' dtype {dtype}")
    if use_mxu and (key_dtype is not None or not dtype.is_floating_point):
        raise NotImplementedError(
            "use_mxu permutes raw floats; the reference's float32 matrix permute of "
            "integer keys (exact only below 2**24) has no counterpart")
    if dtype.is_floating_point and key_dtype is None and not use_mxu:
        raise NotImplementedError(
            "float rows go as total-order keys (key_dtype=dtype) or raw with the "
            "one-hot permute (use_mxu=True); raw floats through the exact permute "
            "have no counterpart")


def sentinel_max(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).max)
    return int(torch.iinfo(dtype).max)


def sentinel_min(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).min)
    return int(torch.iinfo(dtype).min)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The integer view of a float tensor (itself otherwise): torch's CPU
    gather and scatter rewrite the bits of a bfloat16 NaN, so the plain
    versions move floats as integers."""
    if t.dtype.is_floating_point and t.element_size() in KEY_ITYPE:
        return t.view(KEY_ITYPE[t.element_size()])
    return t


def take_along(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather`` that keeps every bit of the values."""
    return torch.gather(_bits(t), dim, idx.long()).view(t.dtype)


def scatter_along(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``zeros_like(t).scatter(dim, idx, t)`` that keeps every bit."""
    b = _bits(t)
    return torch.zeros_like(b).scatter(dim, idx.long(), b).view(t.dtype)


def scatter_permute(vals: torch.Tensor, rank: torch.Tensor,
                    payload: Optional[torch.Tensor] = None):
    """``out[..., rank[i]] = vals[..., i]`` (the exact permute)."""
    out = scatter_along(vals, -1, rank)
    if payload is None:
        return out
    return out, scatter_along(payload, -1, rank)


#: the longest permuted vector whose zero sum keeps the sign of its
#: products in the reference's one-hot permute (see :func:`onehot_permute`)
SIGNED_ZERO_LANES = 7


def canonical_nan(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN replaced by the canonical quiet NaN's bits
    (conversions write other NaN bits on the card than on the CPU)."""
    itype = KEY_ITYPE[x.element_size()]
    return x.view(itype).masked_fill(torch.isnan(x), _CANONICAL_NAN[x.dtype]).view(x.dtype)


def onehot_permute(vals: torch.Tensor, rank: torch.Tensor,
                   payload: Optional[torch.Tensor] = None):
    """The reference's one-hot matrix permute (``use_mxu=True``): output
    slot j is the float32 sum over every lane i of ``(rank[i] == j) *
    vals[i]``, then cast back to the dtype. Its rule, lane by lane:

    * slot j holds the sum of the lanes that land on it (one lane when
      the ranks are a permutation, none or several where a NaN made them
      collide), plus ``0 * vals[i]`` of every other lane;
    * so it is NaN where any lane that does not land on it is ±inf or NaN
      (0 x inf and 0 x NaN are NaN);
    * a zero sum is +0.0, except in a vector of at most
      :data:`SIGNED_ZERO_LANES` lanes whose every lane has its sign bit
      set: there it is -0.0. That is how XLA's CPU compiler sums the
      reference's batched products: a short vector's sum starts from its
      first product (0 x a negative lane is -0.0), a longer one's from
      +0.0. It held at every shape the reference's kernels permute (each
      with a batch of at least 8 vectors); a single vector always sums
      from +0.0.

    NaN comes out as the canonical quiet NaN (the reference's bits are
    the host FPU's). The position lane (``payload``) is summed the same
    way: the sum of the positions that land, 0 where none does."""
    v = vals.float()
    bad = ~torch.isfinite(v)
    slot = torch.zeros_like(v).scatter_add(-1, rank.long(), v)
    landed_bad = torch.zeros_like(rank, dtype=torch.int32).scatter_add(
        -1, rank.long(), bad.to(torch.int32))
    n_bad = bad.sum(dim=-1, keepdim=True, dtype=torch.int32)
    slot = slot.masked_fill(n_bad > landed_bad, float("nan"))
    if v.shape[-1] <= SIGNED_ZERO_LANES:
        negative = torch.signbit(v).all(dim=-1, keepdim=True)
        slot = slot.masked_fill((slot == 0) & negative, -0.0)
    out = canonical_nan(slot.to(vals.dtype))
    if payload is None:
        return out
    return out, torch.zeros_like(payload).scatter_add(-1, rank.long(), payload)


def ranks_sort(x: torch.Tensor) -> torch.Tensor:
    """Stable full-sort ranks along the last axis (N-sorter comparator cloud)."""
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    j_lt_i = pos[None, :] < pos[:, None]  # [i, j]: j < i
    xi, xj = x[..., :, None], x[..., None, :]
    before = (xj < xi) | ((xj == xi) & j_lt_i)
    return before.sum(dim=-1).to(torch.int32)


def ranks_merge2(lo: torch.Tensor, hi: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable 2-run merge ranks (S2MS cloud): ``lo`` wins ties.

    Both runs ascend. ``lo_i`` counts the strictly smaller ``hi``;
    ``hi_j`` counts ``lo_i <= hi_j`` — together a collision-free
    permutation."""
    m, n = lo.shape[-1], hi.shape[-1]
    cmp_ = hi[..., None, :] < lo[..., :, None]  # (.., m, n): hi_j < lo_i
    rank_lo = torch.arange(m, device=lo.device) + cmp_.sum(dim=-1)
    rank_hi = torch.arange(n, device=hi.device) + (~cmp_).sum(dim=-2)
    return rank_lo.to(torch.int32), rank_hi.to(torch.int32)


def merge2_sorted(lo: torch.Tensor, hi: torch.Tensor,
                  payload: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  use_mxu: bool = False):
    """Single-stage stable merge of two ascending runs along the last axis
    (``use_mxu``: the one-hot permute of raw floats)."""
    rank_lo, rank_hi = ranks_merge2(lo, hi)
    vals = torch.cat([lo, hi], dim=-1)
    rank = torch.cat([rank_lo, rank_hi], dim=-1)
    permute = onehot_permute if use_mxu else scatter_permute
    if payload is None:
        return permute(vals, rank)
    return permute(vals, rank, torch.cat(list(payload), dim=-1))


def sort_nsorter(x: torch.Tensor, payload: Optional[torch.Tensor] = None,
                 use_mxu: bool = False):
    """Single-stage N-sorter along the last axis (ascending, stable)."""
    rank = ranks_sort(x)
    return (onehot_permute if use_mxu else scatter_permute)(x, rank, payload)


def ceil_pow2(n: int) -> int:
    """Smallest power of two >= ``n``; 0 and 1 give 1 (an empty or
    one-element list needs no network)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def flip_keys(k: torch.Tensor) -> torch.Tensor:
    """Exact order reversal: bitwise not for integer keys, negation for
    raw floats."""
    return -k if k.dtype.is_floating_point else ~k


def stable_compact(valid: torch.Tensor, *arrays: torch.Tensor):
    """Stable valid-first compaction along the last axis: the slots where
    ``valid`` holds come first, both sides keep their order."""
    if valid.shape[-1] <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    v = valid.to(torch.int32)
    n_valid = v.sum(dim=-1, keepdim=True)
    dest = torch.where(valid, torch.cumsum(v, dim=-1) - 1,
                       n_valid + torch.cumsum(1 - v, dim=-1) - 1).long()
    outs = tuple(scatter_along(a, -1, dest) for a in arrays)
    return outs if len(outs) > 1 else outs[0]


def gather_lanes(perm: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``leaf[..., perm, :]`` along axis 1: ``perm`` (bt, L) positions,
    ``leaf`` (bt, L[, F]); negative positions clamp to 0."""
    idx = torch.where(perm < 0, 0, perm).long()
    if leaf.ndim > idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (leaf.ndim - idx.ndim))
        idx = idx.expand(idx.shape[:2] + leaf.shape[2:])
    return take_along(leaf, 1, idx)


def pad_tail_sorted(x: torch.Tensor, length: int) -> torch.Tensor:
    """Pad the last axis of ascending rows out to ``length`` with the
    dtype's maximum, so each row stays sorted. A genuine maximum ties its
    pads: exact for values-only consumers, never for positions."""
    pad = length - x.shape[-1]
    if pad < 0:
        raise ValueError(f"rows of {x.shape[-1]} are longer than {length}")
    if pad == 0:
        return x
    fill = x.new_full(x.shape[:-1] + (pad,), sentinel_max(x.dtype))
    return torch.cat([x, fill], dim=-1)
