"""The device rule every entry point of the port follows: CUDA unless the
caller names another device, and no silent CPU fallback; and the devices a
fleet mesh can take (`visible_devices`), and the context a mesh slot's work
runs under (`on_device`).

Kept apart from `core/pipeline.py` so that `core/bits.py`, which parses
entropy-coded frames on a device, can use it without an import cycle.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager, List, Union

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


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices a mesh of `device`'s type can take, in order: every card
    (`cuda:0` ... `cuda:{device_count() - 1}`) on CUDA, the one `cpu` on
    the CPU. The port's counterpart of the reference's `jax.devices()`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), before a
    host clock is read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_device(device: torch.device) -> ContextManager:
    """The context a mesh slot's launches run under: its card made current
    (kernels launch on the current device's stream), nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
