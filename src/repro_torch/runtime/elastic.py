"""Elastic scaling: the serving fleet's device mesh and its re-mesh onto the
devices that are still healthy (port of `repro/runtime/elastic.py`;
DESIGN.md §14).

The port has no `jax.sharding.Mesh`. A mesh is `DeviceMesh`: an ordered
tuple of `torch.device`, one per mesh slot, with the shape and axis names
`plan_mesh` gives. A slot may name a device that another slot names too
(`ElasticSession(4, profile="cstream", devices=[cpu] * 4)`, the port's
counterpart of the reference's `--xla_force_host_platform_device_count`):
each slot still runs as its own device would, with its own shard of a wave
and its own kernel launches.

  plan_mesh(n_devices)   — pick (data, model) [(pod, data, model)] factors
                           for the healthy devices (the lm profile), or a
                           pure data axis of any width (the cstream fleet);
  make_mesh_for(n)       — the mesh over the first n visible devices, or
                           over an explicit (surviving) device list;
  ElasticSession         — the current mesh; `resize` re-plans it when the
                           healthy set changes (a device loss shrinks it
                           onto the named survivors).

  reshard(tree, specs)   — place a live tree onto a (new) mesh by its
                           logical specs: one shard per slot, on the
                           slot's device (`runtime/sharding.Sharded`);
                           `sharding.gather` reads the whole tensors back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import DeviceLike, visible_devices
from repro_torch.models import partition


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A device mesh: `devices[i]` runs mesh slot i (row-major over
    `shape`); the same device may fill several slots."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    shape: Sequence[int],
    names: Sequence[str],
    devices: Optional[Sequence[Any]] = None,
    device: DeviceLike = None,
) -> DeviceMesh:
    """Build a mesh of `shape`; `devices=None` takes the first prod(shape)
    devices visible on `device`'s type (CUDA when None)."""
    n = math.prod(shape)
    if devices is None:
        avail = visible_devices(device)
        if n > len(avail):
            raise ValueError(
                f"a mesh of {n} devices exceeds the {len(avail)} visible "
                "device(s); name its slots with devices=[...]"
            )
        devices = avail[:n]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, got {len(devices)}")
    return DeviceMesh(devices, tuple(shape), tuple(names))


def plan_mesh(
    n_devices: int,
    prefer_model: int = 16,
    multi_pod_at: int = 512,
    profile: str = "lm",
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Factor the healthy device count into a mesh shape.

    profile="lm" (default): keeps the model axis at the largest power-of-two
    divisor <= prefer_model, and splits off a pod axis for very large jobs.

    profile="cstream": pure data-axis mesh, `(n,), ("data",)` for ANY
    device count including non-powers-of-two. The serving fleet shards
    gang waves over sessions, so there is no model axis to keep, and the
    survivors of a device loss may be a prime count."""
    if n_devices < 1:
        raise ValueError(f"plan_mesh needs >= 1 device, got {n_devices}")
    if profile == "cstream":
        return (n_devices,), ("data",)
    if profile != "lm":
        raise ValueError(f"unknown mesh profile {profile!r}; use 'lm' or 'cstream'")
    model = 1
    for cand in (prefer_model, 8, 4, 2, 1):
        if n_devices % cand == 0:
            model = cand
            break
    rest = n_devices // model
    if n_devices >= multi_pod_at and rest % 2 == 0:
        return (2, rest // 2, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def logical_mapping(axis_names: Tuple[str, ...]) -> dict:
    if "pod" in axis_names:
        return {"data": ("pod", "data"), "model": "model"}
    if "model" not in axis_names:  # cstream fleet mesh: data axis only
        return {"data": "data"}
    return {"data": "data", "model": "model"}


def make_mesh_for(
    n_devices: int,
    devices: Optional[Sequence[Any]] = None,
    profile: str = "lm",
    device: DeviceLike = None,
) -> Tuple[DeviceMesh, dict]:
    """Mesh + logical mapping for `n_devices`. `devices` pins an explicit
    device list: required when meshing anything but the first n visible
    devices, e.g. the survivors of a device loss."""
    shape, names = plan_mesh(n_devices, profile=profile)
    return make_mesh(shape, names, devices=devices, device=device), logical_mapping(names)


def reshard(tree: Any, logical_specs: Any, mesh: DeviceMesh, mapping: dict) -> Any:
    """Place a live tree onto a (new) mesh per its logical specs: each
    tensor leaf becomes a `sharding.Sharded`, one shard per slot on the
    slot's device (a `Sharded` leaf is gathered first, so a job re-meshes
    onto the survivors of a device loss)."""
    from repro_torch.runtime import sharding as shpol

    with partition.logical_axes(mapping):
        placements = shpol.resolve(logical_specs, mesh)
    return shpol.place(tree, placements, logical_specs)


@dataclasses.dataclass
class ElasticSession:
    """Tracks the current mesh and re-plans when the healthy set changes.

    `devices` names the slots explicitly (None: the first `n_devices`
    visible on `device`'s type, CUDA when None)."""

    n_devices: int
    mesh: Optional[DeviceMesh] = None
    mapping: Optional[dict] = None
    profile: str = "lm"
    devices: Optional[Sequence[Any]] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.mesh is None:
            self.mesh, self.mapping = make_mesh_for(
                self.n_devices, devices=self.devices, profile=self.profile, device=self.device
            )

    def resize(self, new_n: int, devices: Optional[Sequence[Any]] = None) -> "ElasticSession":
        """Shrink (device loss) or grow (devices returned). Returns self.

        `devices` pins the surviving device list explicitly: after a loss
        the healthy set is NOT a prefix of the visible devices, so the
        fleet's recovery names the survivors it re-meshes onto."""
        self.n_devices = new_n
        self.devices = devices
        self.mesh, self.mapping = make_mesh_for(
            new_n, devices=devices, profile=self.profile, device=self.device
        )
        return self

    def shardings_for(self, logical_specs: Any) -> Any:
        """Logical specs resolved onto the current mesh: a tree of
        `sharding.Placement`s."""
        from repro_torch.runtime import sharding as shpol

        with partition.logical_axes(self.mapping):
            return shpol.resolve(logical_specs, self.mesh)
