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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (  # noqa: F401  (re-exported names)
    KEY_ITYPE as _ITYPE,
    decode_key_values,
    encode_key_values,
    key_transformable,
)


def has_key_transform(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is a float type the key transform covers."""
    return key_transformable(dtype)


def encode_keys(x: torch.Tensor) -> torch.Tensor:
    """Float tensor -> int32 keys with the same order, NaNs last."""
    return encode_key_values(x)


def decode_keys(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`encode_keys` (NaNs canonical)."""
    return decode_key_values(k, dtype)
