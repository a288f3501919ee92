"""Logical -> physical sharding for model internals (port of
`repro/models/partition.py`).

Model code names the axes of its activations logically ("data", "model",
None). The launcher maps them onto the physical mesh, single-pod ("data",
"model") or multi-pod (("pod", "data"), "model"), with `set_logical_axes`
or `logical_axes`. The context also carries the current mesh, a
`runtime/elastic.DeviceMesh` (`set_mesh`, `current_mesh`): the port's
counterpart of `jax.set_mesh`, read through `data_shards` by the moe
dispatch (`models/moe.py`) and the sharded prefill
(`models/transformer.py`), and by the distributed-LSE decode
(`core/kvcache.py: decode_attend_dlse`). `lead_slots` names the slot
that runs each data shard's work in those and in the data-parallel step
(`launch/steps.py`).

The port has no SPMD partitioner. Outside the explicit per-slot maps a
tensor is whole (the reference's global array), so `hint` is the identity
there. Inside a slot's program (`slot_program`: one slot of the mesh runs
its shard of a batch, as a `shard_map` body does) `hint` checks that each
dim named by a split logical axis has its shard's size. The model axis's
compute is not split in this port (tensor parallelism is the next ROADMAP
item), so only the batch-like axes are checked.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch import compat

Axis = Union[str, Sequence[str], None]

_AXES: Optional[dict] = None
_MESH = None  # the current runtime/elastic.DeviceMesh, or None
#: the slot program running now: process-wide, since autograd runs a card's
#: backward (full remat's recompute of a slot's blocks) on its own thread
_SLOT: Optional["SlotProgram"] = None


@dataclasses.dataclass(frozen=True)
class SlotProgram:
    """The program of one mesh slot: `slot` indexes `mesh.devices`;
    `split` maps a logical axis to (global size, shard count) for the dims
    that this program holds a shard of."""

    mesh: object
    slot: int
    split: Dict[str, Tuple[int, int]]
    #: values the step shares across its slots' programs (the moe routed
    #: fractions, `models/moe.py`)
    shared: dict = dataclasses.field(default_factory=dict)


def set_logical_axes(mapping: Optional[dict]) -> None:
    """mapping e.g. {'data': ('pod', 'data'), 'model': 'model'}, or None to
    disable."""
    global _AXES
    _AXES = mapping


@contextlib.contextmanager
def logical_axes(mapping: Optional[dict]) -> Iterator[None]:
    global _AXES
    prev = _AXES
    _AXES = mapping
    try:
        yield
    finally:
        _AXES = prev


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[None]:
    """Make `mesh` the current mesh for the block (`jax.set_mesh`)."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def current_axes() -> Optional[dict]:
    return _AXES


def current_slot() -> Optional[SlotProgram]:
    """The slot program running now, or None outside one."""
    return _SLOT


@contextlib.contextmanager
def slot_program(mesh, slot: int, split: Dict[str, Tuple[int, int]],
                 shared: Optional[dict] = None) -> Iterator[SlotProgram]:
    """Run the block as slot `slot`'s program (see `SlotProgram`)."""
    global _SLOT
    prev = _SLOT
    _SLOT = SlotProgram(mesh, slot, dict(split), {} if shared is None else shared)
    try:
        yield _SLOT
    finally:
        _SLOT = prev


def spec(*logical: Axis) -> tuple:
    """The physical entries of a logical spec under the active mapping: a
    tuple with one entry per dim (a mesh axis name, a tuple of names, or
    None). The port has no `PartitionSpec`; this tuple is its value."""
    assert _AXES is not None
    return tuple(_AXES.get(a, a) if isinstance(a, str) else a for a in logical)


def axis_names(entry) -> Tuple[str, ...]:
    """The mesh axes of one physical entry, in order."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(entry, mesh) -> int:
    """The number of shards a physical entry cuts a dim into on `mesh`."""
    n = 1
    for a in axis_names(entry):
        n *= mesh.shape[mesh.axis_names.index(a)]
    return n


def data_shards() -> Tuple[Optional[object], int]:
    """(physical data-axis entry, shard count) of the active mapping and
    mesh, or (None, 1) without them."""
    entry = _AXES.get("data") if _AXES else None
    if entry is None or _MESH is None:
        return None, 1
    if not all(a in _MESH.axis_names for a in axis_names(entry)):
        return None, 1
    return entry, axis_size(entry, _MESH)


def lead_slots(mesh, axes: Sequence[str]) -> list:
    """The first slot of each shard of a dim split over `axes`, in shard
    order: the slot that runs the shard's work when the other axes'
    slots would repeat it."""
    lead: Dict[int, int] = {}
    for s in range(mesh.size):
        lead.setdefault(compat.shard_index(mesh, s, axes), s)
    return [lead[i] for i in range(len(lead))]


def hint(x: torch.Tensor, *logical: Axis) -> torch.Tensor:
    """The reference's sharding constraint on logical axes: the identity.
    Inside a slot's program, checks that each dim of a split logical axis
    has its shard's size."""
    prog = current_slot()
    if _AXES is None or prog is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"hint of {len(logical)} axes on a tensor of shape {tuple(x.shape)}")
    for d, a in enumerate(logical):
        if isinstance(a, str) and a in prog.split:
            total, n = prog.split[a]
            if x.shape[d] * n != total:
                raise ValueError(f"dim {d} of {tuple(x.shape)} is not a 1/{n} shard of {a!r} "
                                 f"({total}) in slot {prog.slot}'s program")
    return x
