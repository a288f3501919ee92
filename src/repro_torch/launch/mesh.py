"""Production meshes (port of `repro/launch/mesh.py`).

Functions, not module constants, so that importing this module touches no
device. The production meshes put their slots on the `meta` device: the
counterpart of the reference's placeholder host devices (its dry run forces
512 of them). Nothing runs on them; they carry shapes, as the dry run will
need.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import visible_devices
from repro_torch.runtime.elastic import DeviceMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 16x16 = 256 slots ("data", "model").
    Multi-pod: 2x16x16 = 512 slots ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, devices=[torch.device("meta")] * n)


def logical_mapping(multi_pod: bool = False) -> dict:
    """Logical -> physical axis mapping for `models/partition.py`: the pod
    axis folds into data parallelism."""
    if multi_pod:
        return {"data": ("pod", "data"), "model": "model"}
    return {"data": "data", "model": "model"}


def make_host_mesh(n: int = 1, device=None) -> DeviceMesh:
    """A (d, 1) ("data", "model") mesh over the first n devices visible on
    `device`'s type (CUDA when None), d = min(n, visible): the CPU has one,
    so a wider CPU mesh needs `elastic.make_mesh(..., devices=[...])`."""
    devs = visible_devices(device)[:n]
    return make_mesh((len(devs), 1), ("data", "model"), devices=devs)
