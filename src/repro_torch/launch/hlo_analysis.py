"""Program analysis: FLOPs, HBM bytes, collective bytes of one device's work
(port of `repro/launch/hlo_analysis.py`; DESIGN.md §9).

The reference parses the compiled HLO of its jitted, SPMD-partitioned step
and re-derives trip-count-aware totals. The port has no HLO: its programs
are eager torch. `analyze_program(fn, *args)` runs `fn` (on `meta`
tensors in the dry run, so nothing is allocated or computed) under a
`TorchDispatchMode` that counts the aten ops the program issues. Python
loops run, so a loop's body is counted once per trip without a special
case. The rules, per op:

  flops            — 2 * M * N * K for `mm`, `addmm`, `bmm` and `baddbmm`
                     (and 2 * M * N for `mv`, 2 * N for `dot`); kernel B10
                     reports its own work through its meta form
                     (`kernels/ops.py: _flash_meta`): 4 * B * H * Dh per
                     (query, key) pair, by the counter's `attention` rule:
                     "pairs", the unmasked (causal, windowed) pairs the
                     kernel computes (`flash_attn.flops`), or "blocks",
                     every pair, as the reference's HLO counts the dots of
                     its blocked scan. `flash_backward` is
                     plain torch: its einsums count as their products over
                     whole KV blocks, masked pairs included;
  hbm bytes        — the operand and output sizes of each op: eager torch
                     does not fuse, so every op materializes its output.
                     A view costs nothing; an op that writes into an
                     argument (`copy_`, `index_put_` on a slice, `add_`)
                     counts the update twice (read and written), not the
                     buffer, as the reference's dynamic-update-slice rule
                     does; B10 counts q, k, v read and out (and lse)
                     written once;
  transcendentals  — the output elements of `exp`, `log`, `tanh`,
                     `rsqrt`, `sqrt`, `sigmoid` and `pow`, and B10's one
                     exponential per unmasked pair;
  collectives      — the calls of `compat.psum`/`pmax` (all-reduce) and
                     `compat.all_gather` (all-gather), and the FSDP gathers
                     of `Sharded.gather_over` (all-gather), with the
                     reference's per-device formulas: all-gather operand
                     out / n and ring wire (n - 1) / n * out, all-reduce
                     operand out and wire 2 (n - 1) / n * out, n the group
                     size.

All quantities are PER DEVICE: the ops of one mesh slot (`slot`, the
first of the dry run's model group). An op belongs to the slot whose
program issued it (`partition.current_slot()`); in the backward, to the
slot whose forward op created the autograd node running it (tagged by a
`TorchFunctionMode`). Ops outside every slot program count for every
device; the arithmetic inside a collective counts in the collective term
alone. `roofline()` rescales to the global task formula against a
`core/energy.GpuChip` (`H100_SXM`), its link term on `link_bw`. The
counts are of the eager program, not measurements.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import compat
from repro_torch.core.energy import H100_SXM, GpuChip
from repro_torch.kernels import ops
from repro_torch.models import partition

_aten = torch.ops.aten
_MATMUL = {_aten.mm.default: "mm", _aten.addmm.default: "addmm", _aten.bmm.default: "bmm",
           _aten.baddbmm.default: "baddbmm", _aten.mv.default: "mv", _aten.dot.default: "dot"}
_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "sigmoid", "pow"}
#: ops that allocate or describe without moving bytes
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
             "lift_fresh", "alias", "_local_scalar_dense", "resize_", "set_", "is_same_size"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        self.transcendentals += mult * other.transcendentals
        for op, d in other.collectives.items():
            mine = self.collectives.setdefault(op, {"count": 0.0, "operand_bytes": 0.0, "wire_bytes": 0.0})
            for k in mine:
                mine[k] += mult * d[k]

    def collective(self, kind: str, out_b: float, n: int) -> None:
        """One collective of `kind` whose per-device output is `out_b`
        bytes over n slots (the reference's formulas)."""
        n = max(n, 1)
        if kind == "all-gather":
            operand, wire = out_b / n, (n - 1) / n * out_b
        elif kind == "all-reduce":
            operand, wire = out_b, 2 * (n - 1) / n * out_b
        elif kind == "reduce-scatter":
            operand, wire = out_b * n, (n - 1) * out_b
        elif kind == "all-to-all":
            operand, wire = out_b, (n - 1) / n * out_b
        else:  # collective-permute
            operand, wire = out_b, out_b
        d = self.collectives.setdefault(kind, {"count": 0.0, "operand_bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += 1
        d["operand_bytes"] += operand
        d["wire_bytes"] += wire


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, Dict[str, float]]

    @property
    def operand_bytes(self) -> float:
        return sum(v["operand_bytes"] for v in self.per_op.values())

    @property
    def wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.per_op.values())

    def to_json(self) -> dict:
        return {"per_op": self.per_op, "operand_bytes": self.operand_bytes, "wire_bytes": self.wire_bytes}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _slot_now():
    prog = partition.current_slot()
    if prog is not None:
        return prog.slot
    node = torch._C._current_autograd_node()
    return None if node is None else node.metadata.get("slot")


class _Tag(TorchFunctionMode):
    """Tags each autograd node a slot's call creates with the slot: the
    output's node and the new nodes behind it (a composite op, `matmul`,
    makes several)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        slot = _slot_now()
        if slot is not None:
            todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
            while todo:
                node = todo.pop()
                if node is None or "slot" in node.metadata or type(node).__name__ == "AccumulateGrad":
                    continue
                node.metadata["slot"] = slot
                todo.extend(nxt for nxt, _ in node.next_functions)
        return out


class _Count(TorchDispatchMode):
    def __init__(self, counter: "ProgramCounter"):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.c
        if compat.in_collective() or not c.mine():
            return out
        name = func._schema.name.split("::")[-1]
        cost = c.scaled()
        kind = _MATMUL.get(func)
        if kind is not None:
            a, b = (args[1], args[2]) if kind in ("addmm", "baddbmm") else (args[0], args[1])
            if kind in ("mm", "addmm"):
                cost.flops += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
            elif kind in ("bmm", "baddbmm"):
                cost.flops += 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            elif kind == "mv":
                cost.flops += 2.0 * a.shape[0] * a.shape[1]
            else:
                cost.flops += 2.0 * a.shape[0]
        if name in _TRANSCENDENTAL or name.rstrip("_") in _TRANSCENDENTAL:
            cost.transcendentals += sum(t.numel() for t in _tensors(out))
        if name in _NO_BYTES:
            return out
        schema = func._schema
        writes = [i for i, a in enumerate(schema.arguments) if a.alias_info is not None and a.alias_info.is_write]
        if writes:
            flat = list(args) + [kwargs.get(a.name) for a in schema.arguments[len(args):]]
            written = {id(flat[i]) for i in writes if i < len(flat) and isinstance(flat[i], torch.Tensor)}
            upd = sum(_nbytes(t) for t in _tensors(flat) if id(t) not in written)
            if upd == 0:
                upd = sum(_nbytes(flat[i]) for i in writes if i < len(flat) and isinstance(flat[i], torch.Tensor))
            cost.bytes += 2 * upd
            return out
        if any(r.alias_info is not None for r in schema.returns):
            return out  # a view
        ins = sum(_nbytes(t) for t in _tensors(list(args) + list(kwargs.values())))
        outs = list(_tensors(out))
        cost.bytes += ins + sum(_nbytes(t) for t in outs)
        for t in outs:
            c.alloc(t)
        return out


class ProgramCounter:
    """Counts one device's ops (`slot`) of the program run in its block
    (see the module's docstring), and the live bytes of the tensors they
    create (`live`, `peak`: the eager program's working set beyond its
    arguments)."""

    def __init__(self, slot: int = 0, attention: str = "pairs"):
        if attention not in ("pairs", "blocks"):
            raise ValueError(f"attention rule {attention!r}: 'pairs' or 'blocks'")
        self.slot = slot
        self.attention = attention
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._modes = []
        self._rep = None

    def scaled(self) -> "Cost":
        """Where the current op's counts go: `cost`, or under
        `partition.repeated(n)` a scratch `Cost` added n times on exit."""
        n = partition.repeat()
        if n == 1:
            return self.cost
        if self._rep is None or self._rep[0] != n:
            self._flush()
            self._rep = (n, Cost())
        return self._rep[1]

    def _flush(self) -> None:
        if self._rep is not None:
            self.cost.add(self._rep[1], self._rep[0])
            self._rep = None

    def mine(self) -> bool:
        s = _slot_now()
        return s is None or s == self.slot

    def alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _collective(self, kind: str, out_b: float, n: int, slots) -> None:
        if slots is None or self.slot in slots:
            self.scaled().collective(kind, out_b, n)

    def _meta(self, name: str, pairs: float, every: float, nbytes: float, trans: float) -> None:
        if self.mine():
            cost = self.scaled()
            cost.flops += pairs if self.attention == "pairs" else every
            cost.bytes += nbytes
            cost.transcendentals += trans

    def __enter__(self) -> "ProgramCounter":
        compat.OBSERVERS.append(self._collective)
        ops.META_COST.append(self._meta)
        self._modes = [_Count(self), _Tag()]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._flush()
        for m in reversed(self._modes):
            m.__exit__(*exc)
        compat.OBSERVERS.remove(self._collective)
        ops.META_COST.remove(self._meta)


def analyze_program(fn, *args, slot: int = 0, attention: str = "pairs",
                    **kwargs) -> Tuple[Cost, CollectiveStats]:
    """Run fn(*args, **kwargs) and count the ops of mesh slot `slot` (and
    of no slot), B10's by the `attention` rule: (Cost, CollectiveStats),
    per device."""
    with ProgramCounter(slot, attention) as pc:
        fn(*args, **kwargs)
    return pc.cost, CollectiveStats(pc.cost.collectives)


# ----------------------------------------------------------------- terms --
@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    hbm_bytes_global: float
    collective_bytes_global: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time (no-overlap: max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_json(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_global": self.flops_global,
            "hbm_bytes_global": self.hbm_bytes_global,
            "collective_bytes_global": self.collective_bytes_global,
            "chips": self.chips,
        }


def roofline(cost: Cost, coll: CollectiveStats, chips: int, chip: GpuChip = H100_SXM) -> RooflineTerms:
    """cost/coll are PER-DEVICE; the three terms follow the task formula:
    term = global_quantity / (chips * per-chip rate), the collective term
    on the chip's link rate (NVLink, each way)."""
    return RooflineTerms(
        compute_s=cost.flops / chip.peak_flops,
        memory_s=cost.bytes / chip.hbm_bw,
        collective_s=coll.operand_bytes / chip.link_bw,
        flops_global=cost.flops * chips,
        hbm_bytes_global=cost.bytes * chips,
        collective_bytes_global=coll.operand_bytes * chips,
        chips=chips,
    )


__all__ = ["Cost", "CollectiveStats", "ProgramCounter", "RooflineTerms", "analyze_program", "roofline"]
