"""The device rule every entry point of the port follows: CUDA unless the
caller names another device, and no silent CPU fallback.

Kept apart from `core/pipeline.py` so that `core/bits.py`, which parses
entropy-coded frames on a device, can use it without an import cycle.
"""
from __future__ import annotations

from typing import Union

import torch

#: what an entry point's `device` keyword takes (None: the card)
DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    There is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless told otherwise, and "
                "none is available; pass device='cpu' to run the plain "
                "versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
