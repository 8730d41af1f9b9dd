"""Total-order float keys: the NaN / ±inf pre-pass behind ``nan_policy``
(counterpart of ``repro.api.keys``).

A comparison network mis-sorts special floats: a NaN makes every
comparison false, so the ranks stop being a permutation. The fix is the
radix-sort trick: view the float as its signed integer and flip the low
bits of the negative half, a bijective, strictly monotonic map of every
float (finite, ±0, ±inf) onto integer keys; NaNs first become the
positive quiet NaN, which maps above ``key(+inf)`` (NaNs last, as
``torch.sort``). -0.0 orders strictly below +0.0. Decoding restores the
input's bits, except that every NaN comes back canonical.

The map itself lives in :mod:`repro_torch.kernels.common`
(``encode_key_values`` / ``decode_key_values``), where the kernels'
plain versions use it; this module is the api layer's face of it.

Integer types other than int32 run as int32 keys too
(:func:`widen_int_keys`): the value, made signed (an unsigned type less
half its range), shifted into the key's high bits, with the low bits all
ones for values >= 0. That map keeps the order, and it sends the type's
minimum to ``INT32_MIN`` and its maximum to ``INT32_MAX``: the int32 pads
and sentinels of the kernels and the executor are then the narrow type's
own, so a pad ties a genuine extreme exactly where the reference's pad in
the raw type ties it, and a top-k pad decodes to the type's minimum.
uint32 is the shift-0 case, ``x ^ 0x80000000``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (  # noqa: F401  (re-exported names)
    KEY_ITYPE as _ITYPE,
    decode_key_values,
    encode_key_values,
    key_transformable,
)


#: integer type -> (bits its value shifts up by, offset that makes it signed)
_INT_KEYS = {torch.int8: (24, 0), torch.int16: (16, 0), torch.uint8: (24, 1 << 7),
             torch.uint16: (16, 1 << 15), torch.uint32: (0, 1 << 31)}
_INT32_MIN = torch.iinfo(torch.int32).min


def has_int_widening(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is an integer type that runs as int32 keys."""
    return dtype in _INT_KEYS


def widen_int_keys(x: torch.Tensor) -> torch.Tensor:
    """int8 / int16 / uint8 / uint16 / uint32 -> order-preserving int32
    keys; the type's minimum and maximum become ``INT32_MIN`` and
    ``INT32_MAX``."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ _INT32_MIN
    shift, off = _INT_KEYS[x.dtype]
    v = x.to(torch.int32) - off
    return (v << shift) | torch.where(v >= 0, (1 << shift) - 1, 0).to(torch.int32)


def narrow_int_keys(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`widen_int_keys` on its image; every other
    int32 key (a pad) goes to the nearest value of ``dtype`` below it."""
    if dtype == torch.uint32:
        return (k ^ _INT32_MIN).view(torch.uint32)
    shift, off = _INT_KEYS[dtype]
    return ((k >> shift) + off).to(dtype)


def has_key_transform(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is a float type the key transform covers."""
    return key_transformable(dtype)


def encode_keys(x: torch.Tensor) -> torch.Tensor:
    """Float tensor -> int32 keys with the same order, NaNs last."""
    return encode_key_values(x)


def decode_keys(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`encode_keys` (NaNs canonical)."""
    return decode_key_values(k, dtype)
