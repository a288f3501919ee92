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
dim named by a split logical axis has its shard's size.

Tensor parallelism (every family on a model axis wider than one slot)
runs one program per data shard over that shard's model group
(`model_groups`, a `Group`): the layer code holds lists of per-slot
tensors, one per model slot, each on its slot's device, and the slots meet
at the collectives of `compat.py`. `Group.map` runs each slot's part under
its slot program, whose split also names "model" (the vocab, the one dim
the model code hints over "model"), so `hint` checks the slot's vocab
shard too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch import compat
from repro_torch.core.device import on_device

Axis = Union[str, Sequence[str], None]

_AXES: Optional[dict] = None
#: run only the first data shard's model group (the dry run's one device)
_LEAD_ONLY = False
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
    ("data", and "model" inside a group program) has its shard's size."""
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


@dataclasses.dataclass(frozen=True)
class Group:
    """The model group of one data shard: its `slots` (indices into
    `mesh.devices`) in `shard_index` order over the model axes, the data
    shard's index `data`, and the split its slot programs hold (see
    `SlotProgram`)."""

    mesh: object
    slots: Tuple[int, ...]
    data: int
    split: Dict[str, Tuple[int, int]]
    #: each slot's variant of a head-split call (`map(by=)`): under
    #: `only_lead_group`, slots of one variant give results of the same
    #: shapes for inputs of the same shapes
    variants: Optional[tuple] = None

    @property
    def n(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> list:
        return [self.mesh.devices[s] for s in self.slots]

    def map(self, fn, *lists, by: Optional[tuple] = None) -> list:
        """[fn(i, lists[0][i], ...) for each slot i of the group], each call
        as the slot's program on its device. Under `only_lead_group` (the
        dry run, whose count reads the first slot alone) a later slot on
        inputs of the same shapes as an earlier one, and of the same variant
        in `by` when fn's shapes depend on the slot (`variants`), takes that
        slot's results: shapes are all the other slots contribute."""
        out, memo = [], ({} if _LEAD_ONLY else None)
        for i, s in enumerate(self.slots):
            args = [x[i] for x in lists]
            key = None if memo is None else (None if by is None else by[i], _shapes(args))
            if key is not None and key in memo:
                out.append(memo[key])
                continue
            with slot_program(self.mesh, s, self.split), on_device(self.mesh.devices[s]):
                out.append(fn(i, *args))
            if key is not None:
                memo[key] = out[-1]
        return out


def _shapes(x) -> tuple:
    """The shapes and dtypes of the tensors in x (nested lists and tuples;
    other leaves by type)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_shapes(y) for y in x)
    return (type(x).__name__,)


#: the trips a counted block stands for (the dry run's microbatches)
_REPEAT = 1


def repeat() -> int:
    return _REPEAT


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """The block runs once and stands for n identical trips (a loop whose
    trips do the same work on other data): the dry run's analysis counts
    its ops n times, as the reference's counts a loop body by its trip
    count."""
    global _REPEAT
    prev = _REPEAT
    _REPEAT = prev * n
    try:
        yield
    finally:
        _REPEAT = prev


def model_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes of the active mapping's "model" entry, () without a
    mapping or mesh, or when the mesh lacks one of them."""
    mesh = _MESH if mesh is None else mesh
    names = axis_names(_AXES.get("model")) if _AXES else ()
    if mesh is None or not names or not all(a in mesh.axis_names for a in names):
        return ()
    return names


def model_width(mesh=None) -> int:
    """Slots on the model axes of the active mapping and mesh (1 without)."""
    mesh = _MESH if mesh is None else mesh
    axes = model_axes(mesh)
    return axis_size(axes, mesh) if axes else 1


def model_groups(mesh, split: Dict[str, Tuple[int, int]]) -> list:
    """The model group of each data shard of `mesh` under the active
    mapping, in data-shard order; the first alone under `lead_group_only`."""
    axes = model_axes(mesh)
    out = [Group(mesh, tuple(g), d, dict(split)) for d, g in enumerate(compat.groups(mesh, axes))]
    return out[:1] if _LEAD_ONLY else out


def lead_group_only() -> bool:
    return _LEAD_ONLY


@contextlib.contextmanager
def only_lead_group() -> Iterator[None]:
    """Run only the first data shard's model group in the block: every
    group does the same work on its shard, so the dry run
    (`launch/dryrun.py`) reads one device's program from the first."""
    global _LEAD_ONLY
    prev = _LEAD_ONLY
    _LEAD_ONLY = True
    try:
        yield
    finally:
        _LEAD_ONLY = prev
