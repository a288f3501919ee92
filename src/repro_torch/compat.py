"""Meshes and collectives (port of `repro/compat.py`).

The reference's `compat.py` is a shim over jax versions: `shard_map` under
its old and new spellings, and `make_mesh` over an explicit device subset.
The port has no `shard_map` to shim. Each of the reference's three
`shard_map` sites (the distributed-LSE decode, the moe dispatch and
combine, the compressed gradient sync) becomes an explicit map over the
mesh's slots, each slot running on its own device, followed by an explicit
merge. Each site has one point where the slots exchange values, so the
merge is a function over the list of per-slot tensors: `psum`, `pmax` and
`all_gather` below, the counterparts of `jax.lax.psum`/`pmax`/`all_gather`
inside a `shard_map` body; each takes the slots' devices. Each moves the
tensors to every slot's device and counts the bytes that leave a slot
(`wire_bytes`), whether or not two slots share a device (on the chip
machine every slot is the one H100, so no byte crosses a link).

The three collectives are plain torch ops over the list (copies to each
device, sums, maxima, concatenations), so autograd runs through them: the
backward of a sum over slots gives each slot's tensor the gradient of the
sum. Tensor parallelism (`models/partition.py: Group`) differentiates one
graph over a model group's slots this way.

Observers (`observe`) see each collective with the slots taking part
(`slots_of`), for the dry run's program analysis
(`launch/hlo_analysis.py: analyze_program`); the arithmetic of a
collective runs inside `in_collective()`.

`make_mesh` builds a `runtime/elastic.DeviceMesh`; `slot_coords` and
`groups` name the slots of a mesh by axis.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

_WIRE: Dict[str, int] = {}
#: callbacks (kind, output bytes per slot, group size, slots or None)
OBSERVERS: List[Callable] = []
_SLOTS: Optional[tuple] = None
_INSIDE = False


@contextlib.contextmanager
def slots_of(slots: Sequence[int]) -> Iterator[None]:
    """Name the mesh slots that take part in the collectives of the block."""
    global _SLOTS
    prev = _SLOTS
    _SLOTS = tuple(slots)
    try:
        yield
    finally:
        _SLOTS = prev


def in_collective() -> bool:
    """Whether a collective's own arithmetic is running now."""
    return _INSIDE


def observe(kind: str, out_bytes: float, n: int, slots: Optional[tuple] = None) -> None:
    """Report one collective of `kind` ("all-reduce", "all-gather") whose
    output on each slot is `out_bytes`, over a group of n slots."""
    for fn in OBSERVERS:
        fn(kind, float(out_bytes), int(n), _SLOTS if slots is None else slots)


def _collective(fn):
    def run(*a, **kw):
        global _INSIDE
        prev = _INSIDE
        _INSIDE = True
        try:
            return fn(*a, **kw)
        finally:
            _INSIDE = prev
    return run


def make_mesh(shape: Sequence[int], names: Sequence[str], devices: Optional[Sequence] = None,
              device=None):
    """A `DeviceMesh` of `shape`; `devices=None` takes the first prod(shape)
    devices visible on `device`'s type (CUDA when None). A device may fill
    several slots."""
    from repro_torch.runtime.elastic import make_mesh as _make

    return _make(shape, names, devices=devices, device=device)


def slot_coords(mesh, slot: int) -> Dict[str, int]:
    """{axis name: coordinate} of slot `slot` (row-major over the shape)."""
    out = {}
    for name, size in zip(reversed(mesh.axis_names), reversed(mesh.shape)):
        out[name] = slot % size
        slot //= size
    return {n: out[n] for n in mesh.axis_names}


def shard_index(mesh, slot: int, axes: Sequence[str]) -> int:
    """The row-major index of slot `slot` over `axes` (in that order): which
    shard of a dim split over those axes the slot holds."""
    c = slot_coords(mesh, slot)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[mesh.axis_names.index(a)] + c[a]
    return idx


_GROUPS: Dict[tuple, List[List[int]]] = {}


def groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The slots of `mesh` in groups that share every coordinate outside
    `axes`; each group ordered by `shard_index` over `axes`."""
    key = (mesh.shape, tuple(mesh.axis_names), tuple(axes))
    if key not in _GROUPS:
        _GROUPS[key] = _groups(mesh, axes)
    return [list(g) for g in _GROUPS[key]]


def group_of(mesh, axes: Sequence[str], slot: int) -> List[int]:
    """The group of `groups(mesh, axes)` that holds slot `slot`."""
    return next(g for g in groups(mesh, axes) if slot in g)


def _groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    others = [a for a in mesh.axis_names if a not in axes]
    sizes = [mesh.shape[mesh.axis_names.index(a)] for a in others]
    out = []
    for key in itertools.product(*(range(s) for s in sizes)):
        members = [s for s in range(mesh.size)
                   if all(slot_coords(mesh, s)[a] == k for a, k in zip(others, key))]
        out.append(sorted(members, key=lambda s: shard_index(mesh, s, axes)))
    return out


# ----------------------------------------------------------- collectives --
def count_bytes(kind: str, nbytes: int) -> None:
    """Add `nbytes` moved between slots to the count of `kind`."""
    _WIRE[kind] = _WIRE.get(kind, 0) + int(nbytes)


def _count(kind: str, xs: Sequence[torch.Tensor]) -> None:
    count_bytes(kind, (len(xs) - 1) * sum(x.numel() * x.element_size() for x in xs))


def wire_bytes() -> Dict[str, int]:
    """Bytes the collectives moved between slots since `reset_wire`, by kind."""
    return dict(_WIRE)


def reset_wire() -> None:
    _WIRE.clear()


def _meta(xs) -> bool:
    """Every tensor on `meta` (the dry run): no values to reduce, the
    result is the first slot's tensor, whose shape every slot's result has."""
    return all(x.device.type == "meta" for x in xs)


@_collective
def _per_device(fn, devices: Sequence) -> List[torch.Tensor]:
    """fn(device) for each slot's device. Slots that share a device share
    one result tensor: callers treat the results as read-only."""
    devs = [torch.device(d) for d in devices]
    done: Dict[torch.device, torch.Tensor] = {}
    return [done[d] if d in done else done.setdefault(d, fn(d)) for d in devs]


def psum(xs: Sequence[torch.Tensor], devices: Sequence) -> List[torch.Tensor]:
    """The sum of one tensor per slot, on each slot's device (summed in slot
    order)."""
    _count("psum", xs)
    observe("all-reduce", xs[0].numel() * xs[0].element_size(), len(xs))
    if _meta(xs):
        return [xs[0]] * len(devices)

    def one(d):
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = acc + x.to(d)
        return acc

    return _per_device(one, devices)


def pmax(xs: Sequence[torch.Tensor], devices: Sequence) -> List[torch.Tensor]:
    """The elementwise max of one tensor per slot, on each slot's device."""
    _count("pmax", xs)
    observe("all-reduce", xs[0].numel() * xs[0].element_size(), len(xs))
    if _meta(xs):
        return [xs[0]] * len(devices)

    def one(d):
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = torch.maximum(acc, x.to(d))
        return acc

    return _per_device(one, devices)


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence, dim: int = 0) -> List[torch.Tensor]:
    """Every slot's tensor on each slot's device, concatenated along `dim`
    (`jax.lax.all_gather(..., tiled=True)`)."""
    _count("all_gather", xs)
    observe("all-gather", sum(x.numel() * x.element_size() for x in xs), len(xs))
    return _per_device(lambda d: torch.cat([x.to(d) for x in xs], dim=dim), devices)


def n_slots(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[mesh.axis_names.index(a)] for a in axes)
