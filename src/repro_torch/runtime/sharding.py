"""Per-architecture sharding policy (port of `repro/runtime/sharding.py`;
DESIGN.md §8).

Logical axes:  "data"  = DP + FSDP (and, multi-pod, ("pod", "data"))
               "model" = TP / EP / sequence-parallel KV

The rules (`_rule`, copied) give each parameter leaf its logical axes:
embeddings vocab-sharded over model and FSDP over d_model; q/o projections
head-sharded over model; k/v projections FSDP-only when the kv heads do not
fill the model axis; the dense FFN's d_ff over model; moe experts over
model when E divides the model axis (qwen3-moe), else TP inside each
expert (mixtral); the KV cache batch -> data, ring -> model; AdamW's m/v
mirror the parameters (FSDP'd Adam).

`param_specs` is keyed by the port's parameter names (`layers.<i>.attn.wq`,
a row of the reference's stacked `layers/attn/wq`, so its spec is the
reference's without the leading layer entry); `cache_specs` follows the
port's cache dict. Specs are tuples of logical entries; `partition.spec`
maps them onto a mesh's axes under the active mapping.

A placement (`Placement`, from `resolve`) is the port's `NamedSharding`:
which dims split over which mesh axes, and each slot's slice. `Sharded`
is a tensor held as one shard per slot, each on its slot's device, with
its placement and global shape; `gather` rebuilds the whole tensor, the
counterpart of reading a global array, and `gather_over` rebuilds it over
some mesh axes only, keeping the slot's shard along the others. Under
tensor parallelism (every family on a model axis wider than one slot) a
slot gathers a weight over the data axes alone (FSDP) and computes on its
model shard (`model_split`, `slot_weight`); a replicated leaf (a norm, or
a recurrent block's per-channel or per-head `conv_b`, `lam`, `b_a`, `b_x`,
`A_log`, `D`, `dt_bias`, mamba2's gated-norm `norm`) reaches every slot
whole, and the group forms of `models/ssd.py` and `models/rglru.py` take
the slot's slice of it. The decode cache's recurrent states are held as
`Sharded` by `cache_specs`, as its rings are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig

MODEL_AXIS_SIZE = 16  # production meshes put 16 chips on the model axis


def _rule(cfg: ModelConfig, path: str, ndim: int, mode: str) -> tuple:
    """Logical axes for one param leaf; `path` is the reference's '/'-joined
    tree keys. Leading stacked-layer dims (layers/groups/tail) already
    accounted for."""
    kv_shardable = (cfg.n_kv_heads * cfg.head_dim) % MODEL_AXIS_SIZE == 0 and cfg.n_kv_heads >= MODEL_AXIS_SIZE
    ep = cfg.n_experts % MODEL_AXIS_SIZE == 0 and cfg.n_experts > 0
    # train: FSDP over data.  serve: weights replicated over data, except
    # models over 20B parameters, which keep FSDP (weight-gathered serving)
    fsdp = "data" if (mode == "train" or cfg.param_count() > 2e10) else None

    def base():
        # moe expert tensors first (they share leaf names with the dense FFN)
        if path.endswith(("moe/w_gate", "moe/w_up")):
            return ("model", fsdp, None) if ep else (None, fsdp, "model")
        if path.endswith("moe/w_down"):
            return ("model", None, fsdp) if ep else (None, "model", fsdp)
        if path.endswith("embed"):
            return ("model", fsdp)
        if path.endswith("head"):
            return (fsdp, "model")
        if path.endswith(("wq", "w_gate", "w_up", "w_in_x", "w_in_gate", "w_a", "w_x", "in_proj")):
            return (fsdp, "model")
        if path.endswith(("wk", "wv")):
            return (fsdp, "model") if kv_shardable else (fsdp, None)
        if path.endswith(("wo", "w_down", "w_out", "out_proj")):
            return ("model", fsdp)
        if path.endswith("router"):
            return (fsdp, None)
        if path.endswith("conv_w"):
            return (None, "model")
        return None  # norms, biases, lam, A_log, ... replicated

    spec = base()
    if spec is None:
        return ()
    return spec


def model_split(cfg: ModelConfig, mode: str = "train") -> Dict[str, Optional[int]]:
    """{port parameter name: the dim its logical spec splits over "model",
    or None}: what a model slot holds a 1/n shard of under tensor
    parallelism."""
    key = (cfg, mode)
    if key not in _MODEL_SPLIT:
        _MODEL_SPLIT[key] = {k: (spec.index("model") if "model" in spec else None)
                             for k, spec in param_specs(cfg, mode).items()}
    return _MODEL_SPLIT[key]


_MODEL_SPLIT: Dict[tuple, Dict[str, Optional[int]]] = {}


def slot_weight(t: torch.Tensor, dim: Optional[int], i: int, n: int, device) -> torch.Tensor:
    """Model slot i's shard (of n) of a whole weight `t` along `dim` (the
    whole weight when None): a view on `t`'s device, else a copy on
    `device`."""
    if dim is not None:
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t if t.device == torch.device(device) else t.to(device)


def _ref_path(name: str) -> Tuple[str, bool]:
    """(the reference's tree path of port parameter `name`, whether its
    leaf is stacked over blocks)."""
    from repro_torch.models.convert import STACKS

    parts = name.split(".")
    if parts[0] in STACKS:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def param_specs(cfg: ModelConfig, mode: str = "train") -> Dict[str, tuple]:
    """{port parameter name: LOGICAL spec} for every parameter of
    `init_params(cfg)` (built on the `meta` device).

    mode='train': FSDP over data; mode='serve': weights replicated over
    data (except models over 20B parameters)."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, "meta", param_dtype=cfg.param_dtype)
    out = {}
    for name, p in model.named_parameters():
        path, stacked = _ref_path(name)
        logical = _rule(cfg, path, p.dim() + stacked, mode)
        pad = p.dim() - len(logical)
        out[name] = ((None,) * pad + tuple(logical))[: p.dim()]
    return out


def batch_specs(cfg: ModelConfig, kind: str, data_ok: bool = True) -> Dict[str, tuple]:
    """Logical specs for the input feeds. data_ok=False replicates the batch
    dim (a global batch of 1 cannot shard over the data axis)."""
    d = "data" if data_ok else None
    ins = (d, None, None) if cfg.input_kind == "embeddings" else (d, None)
    if kind == "train":
        return {"inputs": ins, "labels": (d, None)}
    if kind == "prefill":
        return {"inputs": ins}
    return {"inputs_t": ins}


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    """Logical specs for the port's decode cache (`init_decode_cache`, built
    on `meta`): batch -> data, ring -> model, and the recurrent states'
    heads (`ssm_state`), channels (`conv_tail`) and width (`h`) -> model.
    batch == 1 leaves the batch unsharded and keeps the ring on model.
    `pos` (an int) gets ()."""
    from repro_torch.models.transformer import init_decode_cache

    with partition.set_mesh(None):
        shapes = init_decode_cache(cfg, batch, seq_len, device="meta")
    data = "data" if batch > 1 else None

    def one(name: str, leaf) -> tuple:
        if name == "pos":
            return ()
        if name in ("k_codes", "v_codes", "k", "v"):
            return (None, data, "model", None, None)  # (L, B, W, K, Dh)
        if name in ("k_scale", "v_scale"):
            return (None, data, "model", None)  # (L, B, W//G, K)
        if name == "ssm_state":
            return (None, data, None, "model", None, None)  # (L, B, G, E, P, N)
        if name == "conv_tail":
            return (None, data, None, "model")  # (L, B, W-1, C)
        if name == "h":
            return (None, data, "model")  # (G, B, R)
        return (None,) * leaf.dim()

    def walk(node: Dict[str, Any]) -> Dict[str, Any]:
        return {k: walk(v) if isinstance(v, dict) else one(k, v) for k, v in node.items()}

    return walk(shapes)


# ------------------------------------------------------------- placement --
def is_spec(x) -> bool:
    """A spec leaf: a plain tuple of entries (None, a name, or a tuple of
    names); NamedTuples (AdamW's state) are nodes."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, (str, tuple)) for e in x))


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable = lambda x: False) -> Any:
    """`fn` over the leaves of `tree` (dicts, lists, tuples, NamedTuples),
    with the matching nodes of `rest`."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The port's `NamedSharding`: a mesh and one physical entry per dim
    (a mesh axis, a tuple of axes, or None; missing trailing entries are
    None). A dim split over axes (a, b) is cut into size(a) * size(b)
    equal shards, slot s holding shard `compat.shard_index(mesh, s, (a, b))`."""

    mesh: Any
    spec: tuple

    def entry(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = []
        for d, size in enumerate(shape):
            n = partition.axis_size(self.entry(d), self.mesh)
            if size % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split {n} ways ({self.spec})")
            out.append(size // n)
        return tuple(out)

    def slices(self, shape, slot: int) -> Tuple[slice, ...]:
        """Slot `slot`'s slice of a tensor of `shape`."""
        local = self.shard_shape(shape)
        out = []
        for d, n in enumerate(local):
            axes = partition.axis_names(self.entry(d))
            i = compat.shard_index(self.mesh, slot, axes) if axes else 0
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def place(self, t: torch.Tensor, logical: Optional[tuple] = None) -> "Sharded":
        """Each slot's shard of `t`, a copy on its slot's device."""
        shards = []
        for slot, dev in enumerate(self.mesh.devices):
            part = t[self.slices(t.shape, slot)]
            shards.append(torch.empty(part.shape, dtype=t.dtype, device=dev).copy_(part))
        return Sharded(shards, self, tuple(t.shape), logical)

    def zeros(self, shape, dtype: torch.dtype, fill: float = 0.0,
              logical: Optional[tuple] = None) -> "Sharded":
        """A Sharded tensor of `shape` filled with `fill`."""
        local = self.shard_shape(shape)
        return Sharded([torch.full(local, fill, dtype=dtype, device=d) for d in self.mesh.devices],
                       self, tuple(shape), logical)


@dataclasses.dataclass(eq=False)
class Sharded:
    """A tensor held as one shard per mesh slot (`shards[s]` on
    `mesh.devices[s]`), with its placement, global shape and logical spec."""

    shards: List[torch.Tensor]
    placement: Placement
    shape: Tuple[int, ...]
    logical: Optional[tuple] = None
    _over_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def mesh(self):
        return self.placement.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the mesh's first slot's when None):
        each distinct shard copied into its slice once."""
        device = self.mesh.devices[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for slot, shard in enumerate(self.shards):
            sl = self.placement.slices(self.shape, slot)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl].copy_(shard)
        return out

    def _over(self, axes, slot: int):
        """(dims split over `axes`, [(slot s, its slice relative to the
        result)] for one slot of each distinct shard that `gather_over(axes,
        slot)` assembles), and the result's shape."""
        key = (tuple(axes), slot)
        if key in self._over_cache:
            return self._over_cache[key]
        own = self.placement.slices(self.shape, slot)
        dims = []
        for d in range(len(self.shape)):
            names = partition.axis_names(self.placement.entry(d))
            inside = [a in axes for a in names]
            if any(inside) and not all(inside):
                raise ValueError(f"dim {d} of {self.placement.spec} is split over {names}: "
                                 f"partly inside {tuple(axes)}")
            if names and all(inside):
                dims.append(d)
        shape = tuple(self.shape[d] if d in dims else own[d].stop - own[d].start for d in range(len(self.shape)))
        parts, seen = [], set()
        for s in compat.group_of(self.mesh, [a for a in self.mesh.axis_names if a in axes], slot):
            sl = self.placement.slices(self.shape, s)
            k = tuple((x.start, x.stop) for x in sl)
            if k not in seen:
                seen.add(k)
                parts.append((s, tuple(sl[d] if d in dims else slice(0, shape[d]) for d in range(len(sl)))))
        self._over_cache[key] = (parts, shape)
        return parts, shape

    def gather_over(self, axes, slot: int, device=None) -> torch.Tensor:
        """The tensor gathered over the mesh axes `axes` only, keeping slot
        `slot`'s shard along the dims split over other axes (a model slot's
        weight gathered over the data axes: FSDP), on `device` (the slot's
        when None). The bytes of other slots' shards count as
        `all_gather`."""
        device = self.mesh.devices[slot] if device is None else torch.device(device)
        parts, shape = self._over(axes, slot)
        if len(parts) == 1 and self.shards[parts[0][0]].device == device:
            return self.shards[parts[0][0]]
        out = torch.empty(shape, dtype=self.dtype, device=device)
        moved = 0
        for s, sl in parts:
            out[sl].copy_(self.shards[s])
            if s != slot:
                moved += self.shards[s].numel() * self.shards[s].element_size()
        compat.count_bytes("all_gather", moved)
        compat.observe("all-gather", out.numel() * out.element_size(), len(parts), slots=(slot,))
        return out

    def own_in(self, axes, slot: int) -> Tuple[slice, ...]:
        """Slot `slot`'s own shard as slices of what `gather_over(axes,
        slot)` gives."""
        own = self.placement.slices(self.shape, slot)
        parts, _ = self._over(axes, slot)
        return next(sl for s, sl in parts if s == slot or self.placement.slices(self.shape, s) == own)

    def write_over(self, axes, slot: int, t: torch.Tensor) -> None:
        """Write `t` (what `gather_over(axes, slot)` gives) into the shards
        of every slot that shares slot `slot`'s coordinates outside `axes`,
        in place."""
        others = [a for a in self.mesh.axis_names if a not in axes]
        key = compat.shard_index(self.mesh, slot, others)
        parts, _ = self._over(axes, slot)
        where = {tuple((x.start, x.stop) for x in self.placement.slices(self.shape, s)): sl for s, sl in parts}
        for s, shard in enumerate(self.shards):
            if compat.shard_index(self.mesh, s, others) != key:
                continue
            sl = where.get(tuple((x.start, x.stop) for x in self.placement.slices(self.shape, s)))
            if sl is not None and shard is not t:
                shard.copy_(t[sl])

    def row(self, i: int) -> "Sharded":
        """Row i of dim 0 (an unsplit dim), as views of the shards: a
        layer's slice of a stacked cache; writes land in the shards."""
        if partition.axis_size(self.placement.entry(0), self.mesh) != 1:
            raise ValueError("row() indexes an unsplit leading dim")
        logical = self.logical[1:] if self.logical else None
        return Sharded([s[i] for s in self.shards], Placement(self.mesh, self.placement.spec[1:]),
                       self.shape[1:], logical)

    def write(self, t: torch.Tensor) -> None:
        """Copy the whole tensor `t` into every slot's shard, in place."""
        for slot, shard in enumerate(self.shards):
            shard.copy_(t[self.placement.slices(self.shape, slot)])


def resolve(logical_tree: Any, mesh) -> Any:
    """Logical spec tree -> `Placement` tree on `mesh` (under the active
    `partition.logical_axes` mapping)."""
    return tree_map(lambda t: Placement(mesh, partition.spec(*t)), logical_tree, is_leaf=is_spec)


def physical_specs(logical_tree: Any) -> Any:
    """Logical spec tree -> physical spec tree (tuples of mesh-axis
    entries)."""
    return tree_map(lambda t: partition.spec(*t), logical_tree, is_leaf=is_spec)


def place(tree: Any, placements: Any, logical_tree: Any = None) -> Any:
    """Each tensor of `tree` as a `Sharded` by its placement (a `Sharded`
    leaf is gathered first: a re-mesh); other leaves (ints) pass."""
    def one(p: Placement, x, logical=None):
        if isinstance(x, Sharded):
            x = x.gather()
        if not isinstance(x, torch.Tensor):
            return x
        return p.place(x, logical)

    if logical_tree is None:
        return tree_map(one, placements, tree, is_leaf=lambda x: isinstance(x, Placement))
    return tree_map(one, placements, tree, logical_tree, is_leaf=lambda x: isinstance(x, Placement))


def gather(tree: Any, device=None) -> Any:
    """Every `Sharded` leaf of `tree` as its whole tensor."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Sharded) else x, tree,
                    is_leaf=lambda x: isinstance(x, Sharded))
