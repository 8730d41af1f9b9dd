"""Device selection shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU
(``device="cpu"``, as the tests do). With no card and no explicit CPU
request it raises: nothing drops to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
