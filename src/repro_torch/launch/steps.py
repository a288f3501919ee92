"""Step builders (port of `repro/launch/steps.py`).

`make_train_step` returns (init_fn, train_step): microbatched gradient
accumulation in float32, optional compressed gradient sync across a mesh
axis, AdamW applied in place, and metrics; on a mesh, data parallel, and
tensor parallel over the model axis for every family.
`make_serve_step` / `make_prefill_step` wrap the decode and prefill paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.core import gradient as gradmod
from repro_torch.core.device import DeviceLike, on_device
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, decode_greedy, init_params, loss_fn, prefill
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw, apply_updates_, global_norm


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_compression: Optional[gradmod.GradCompressionConfig] = None
    sync_axis: str = "pod"  # compressed sync crosses this axis (multi-pod DP)
    aux_weight: float = 0.01


def pick_microbatches(cfg: ModelConfig, global_batch: int, seq: int, data_size: int,
                      budget_bytes: float = None) -> int:
    """Smallest grad-accumulation factor whose activation working set fits
    (the reference's estimate: with full remat ~1 layer-input carry per
    layer plus the model-sharded float32 logits; MoE archs get a tighter
    budget)."""
    if budget_bytes is None:
        budget_bytes = 2e9 if cfg.n_experts else 6e9
    model_shard = 16
    for mb in (1, 2, 4, 8, 16, 32, 64):
        if global_batch % mb or (global_batch // mb) < data_size:
            continue
        b_local = global_batch // mb // data_size
        carries = cfg.n_layers * b_local * seq * cfg.d_model * 2
        logits = b_local * seq * max(cfg.vocab_size // model_shard, 1) * 8
        if carries + logits <= budget_bytes:
            return mb
    return max(1, global_batch // data_size)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    step_cfg: TrainStepConfig = TrainStepConfig(), mesh=None, param_pspecs=None,
                    device: DeviceLike = None) -> Tuple[Callable, Callable]:
    """Returns (init_fn, train_step).

    init_fn(seed) -> (model, opt_state): a `Transformer` with float32
    master parameters (`cfg.param_dtype`) on `device` (CUDA when None).
    train_step(model, opt_state, batch) -> (model, opt_state, metrics
    {"loss", "ce", "grad_norm" (0-d tensors), "lr" (float)}) updates the
    model's parameters in place. batch = {inputs (B, S) or (B, S, D)
    embeddings, labels (B, S)},
    pre-split to (mb, b, ...) by `microbatch_split` when microbatches > 1.

    With `step_cfg.grad_compression` and a port `runtime/elastic.DeviceMesh`
    holding `step_cfg.sync_axis` of one slot, the gradients go through
    `gradient.compressed_grad_sync` before AdamW.

    Data parallelism: given `param_pspecs` (physical specs by parameter
    name, `sharding.physical_specs(sharding.param_specs(cfg, "train"))`
    under the mapping), or a compressed sync over an axis of several
    slots, the step runs on `mesh` (`_mesh_train_step`): init_fn(seed) ->
    (params {name: `sharding.Sharded`}, AdamWState whose m and v are
    `Sharded` alike), train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)."""
    sync = (step_cfg.grad_compression is not None and mesh is not None
            and step_cfg.sync_axis in mesh.axis_names)
    if mesh is not None and (param_pspecs is not None
                             or (sync and mesh.shape[mesh.axis_names.index(step_cfg.sync_axis)] > 1)):
        return _mesh_train_step(cfg, opt_cfg, step_cfg, mesh, param_pspecs, sync, device)
    opt_init, opt_update = adamw(opt_cfg)

    def init_fn(seed: int = 0):
        model = init_params(cfg, seed, device, param_dtype=cfg.param_dtype)
        return model, opt_init(dict(model.named_parameters()))

    def train_step(model: Transformer, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        mb = step_cfg.microbatches
        params = dict(model.named_parameters())
        names = list(params)
        grads = ({} if mb == 1 else
                 {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()})
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        ce_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(mb):
            mbatch = batch if mb == 1 else {k: v[i] for k, v in batch.items()}
            loss, metrics = loss_fn(model, cfg, mbatch, step_cfg.aux_weight)
            # an embeddings model's untied `embed` is not used: a zero
            # gradient, as the reference's `jax.grad` gives it
            got = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True,
                                      materialize_grads=True)
            with torch.no_grad():
                if mb == 1:  # 0 + g / 1 is g: keep autograd's tensors
                    grads = {k: g.to(torch.float32) for k, g in zip(names, got)}
                else:
                    for k, g in zip(names, got):
                        grads[k] += g.to(torch.float32) / mb
                loss_acc = loss_acc + loss.detach() / mb
                ce_acc = ce_acc + metrics["ce"].detach() / mb
            del got, loss, metrics
        if sync:
            grads = gradmod.compressed_grad_sync(grads, mesh, step_cfg.sync_axis,
                                                 step_cfg.grad_compression)
        with torch.no_grad():
            updates, opt_state, om = opt_update(grads, opt_state, params)
            del grads
            apply_updates_(params, updates)
        return model, opt_state, {"loss": loss_acc, "ce": ce_acc, "grad_norm": om["grad_norm"],
                                  "lr": om["lr"]}

    return init_fn, train_step


def data_axes(mesh, mapping: Optional[dict]) -> Tuple[str, ...]:
    """The mesh axes the mapping's "data" entry names, () when it names an
    axis the mesh lacks: the axes a global batch splits over."""
    axes = partition.axis_names((mapping or {}).get("data"))
    return axes if axes and all(a in mesh.axis_names for a in axes) else ()


def _mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, step_cfg: TrainStepConfig, mesh,
                     param_pspecs, sync: bool, device: DeviceLike):
    """The data-parallel step on `mesh`, under the active logical mapping
    (else `elastic.logical_mapping(mesh.axis_names)`).

    It gives the numbers of the reference's step jitted with
    `in_shardings=(pshard, oshard, bshard)`, which are those of the
    unsharded program up to reduction order, then the pod sync:
      * storage: master parameters and AdamW's m/v held as `Sharded` by
        `param_pspecs` (replicated when None): FSDP'd Adam;
      * each slot's program (`partition.slot_program`): the whole weights
        gathered from the shards into a working model on the slot's device,
        the slot's rows of the global batch (split over the mapping's data
        axes), the loss on them scaled by the slot's share of the global
        mask count, and its gradients. The moe family first records each
        layer's routed counts over the data shards, so that each slot's
        load-balance loss is its share of the global one;
      * the merge: the gradients summed over the data axes (`compat.psum`),
        which gives every slot the global mean;
      * then the compressed sync over `step_cfg.sync_axis`. On the
        reference, the gradients entering its partial-manual `shard_map`
        already hold that global mean, identical on every pod (checked on
        a (pod 2, data 2, model 1) mesh of forced host devices: the pods'
        local views equal each other and the jitted global gradient
        exactly); so the pod sync is a quantize round trip of one tensor,
        each pod's codes averaged with identical ones;
      * AdamW: the global norm clip on the whole gradients, then each
        slot updates its own shards in place.
    Tensor parallelism (every family on a model axis wider than one slot,
    `transformer.tp_active`): each data shard runs one group
    program over its model group (`transformer.loss_group`) instead of
    one program per slot. Each slot's leaves are its model shards of the
    masters gathered over the data axes only (`Sharded.gather_over`); one
    autograd graph runs over the group's slots, differentiating the loss of
    its first slot (every slot holds the same value); a leaf the model
    axis does not split gets each slot's partial gradient, summed over the
    group (a replicated per-channel or per-head leaf of the recurrent
    blocks, `conv_b`, `lam`, `A_log`, ..., of which each slot uses its
    slice, the same way); the gradients are summed over the data axes;
    the pod sync quantizes whole leaves (the model shards all-gathered),
    as the reference's does; the clip's norm is a `psum` of the model slots'
    squared norms, a replicated leaf counted once; AdamW runs on each
    slot's own shards."""
    from repro_torch.runtime.elastic import logical_mapping
    from repro_torch.runtime.sharding import Placement

    from repro_torch.models import transformer as tt
    from repro_torch.runtime.sharding import model_split

    mapping = partition.current_axes() or logical_mapping(mesh.axis_names)
    daxes = data_axes(mesh, mapping)
    n_data = compat.n_slots(mesh, daxes)
    with partition.logical_axes(mapping):
        maxes = partition.model_axes(mesh)
    tp = bool(maxes) and compat.n_slots(mesh, maxes) > 1
    #: the axes a slot's gradient spans: all of them, or under tensor
    #: parallelism all but the model axes (its model shard)
    oaxes = tuple(a for a in mesh.axis_names if not tp or a not in maxes)
    mspec = model_split(cfg) if tp else {}
    compute = getattr(torch, cfg.dtype)
    _, shard_update = adamw(dataclasses.replace(opt_cfg, clip_norm=None))
    workers: Dict[torch.device, Transformer] = {}
    #: the first slot of each data shard: the moe recording pass runs there
    leads = partition.lead_slots(mesh, daxes)

    def placement(name: str) -> Placement:
        return Placement(mesh, tuple(() if param_pspecs is None else param_pspecs[name]))

    def init_fn(seed: int = 0):
        model = init_params(cfg, seed, mesh.devices[0], param_dtype=cfg.param_dtype)
        with torch.no_grad():
            params = {k: placement(k).place(p.detach()) for k, p in model.named_parameters()}
        del model

        def zeros():
            return {k: t.placement.zeros(t.shape, torch.float32) for k, t in params.items()}

        return params, AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros())

    def load(params, slot: int) -> Transformer:
        """The slot's working model holding the whole weights (the FSDP
        all-gather; the bytes of other slots' shards counted)."""
        dev = mesh.devices[slot]
        if dev not in workers:
            workers[dev] = Transformer(cfg, dev, param_dtype=cfg.param_dtype)
        model = workers[dev]
        moved = 0
        with torch.no_grad():
            for k, p in model.named_parameters():
                t = params[k]
                own = t.placement.slices(t.shape, slot)
                seen = set()
                for s, shard in enumerate(t.shards):
                    sl = t.placement.slices(t.shape, s)
                    key = tuple((x.start, x.stop) for x in sl)
                    if key in seen:
                        continue
                    seen.add(key)
                    p[sl].copy_(shard)
                    if sl != own:
                        moved += shard.numel() * shard.element_size()
        compat.count_bytes("all_gather", moved)
        return model

    def rows(mbatch, slot: int):
        i = compat.shard_index(mesh, slot, daxes)
        dev = mesh.devices[slot]
        return {k: x[i * (x.shape[0] // n_data):(i + 1) * (x.shape[0] // n_data)].to(dev)
                for k, x in mbatch.items()}

    def count(b) -> float:
        m = b.get("mask")
        return float(b["labels"].numel()) if m is None else float(torch.sum(m.to(torch.float32)))

    def run_slot(params, mbatch, slot: int, shared: dict, record: bool = False):
        b = rows(mbatch, slot)
        model = load(params, slot)
        split = {"data": (mbatch["labels"].shape[0], n_data)} if n_data > 1 else {}
        with partition.logical_axes(mapping), partition.set_mesh(mesh), \
                partition.slot_program(mesh, slot, split, shared), on_device(mesh.devices[slot]):
            if record:
                with torch.no_grad():
                    loss_fn(model, cfg, b, step_cfg.aux_weight)
                return None
            total_count = count(mbatch)
            mine = count(b)
            w = mine / max(total_count, 1.0) if mine > 0 else 0.0
            _, m = loss_fn(model, cfg, b, step_cfg.aux_weight)
            # a recorded moe loss is already the slot's share of the global aux
            aux_w = 1.0 if "moe_f" in shared else w
            loss = w * m["ce"] + step_cfg.aux_weight * aux_w * m["aux"]
            params_list = [p for _, p in model.named_parameters()]
            got = torch.autograd.grad(loss, params_list, allow_unused=True, materialize_grads=True)
        names = [k for k, _ in model.named_parameters()]
        return ({k: g.to(torch.float32) for k, g in zip(names, got)}, loss.detach(),
                (w * m["ce"]).detach())

    def tp_grads(params, mbatch) -> list:
        """Each group program's [(slot, {name: gradient of the slot's
        leaf}, loss, ce)] (see the docstring)."""
        with partition.logical_axes(mapping), partition.set_mesh(mesh):
            groups, data_split = tt.tp_groups(cfg, mbatch["labels"].shape[0])
            total = count(mbatch)
            f_global, t_global = None, None
            if cfg.family == "moe" and data_split:
                record: dict = {}
                with torch.no_grad():
                    for g in groups:
                        with compat.slots_of(g.slots):
                            run_group(params, mbatch, g, data_split, {"record": record})
                t_global = mbatch["labels"].numel()
                f_global = {li: torch.stack([c.to(mesh.devices[0]) for c in cs]).sum(0) / t_global
                            for li, cs in record.items()}
                if partition.lead_group_only():
                    f_global = {li: f * n_data for li, f in f_global.items()}
            out = []
            for g in groups:
                kw = {} if f_global is None else {"f_global": f_global, "t_global": t_global}
                with compat.slots_of(g.slots):
                    out.extend(run_group(params, mbatch, g, data_split, kw, total))
        return out

    def run_group(params, mbatch, g, data_split: bool, moe_kw: dict, total: float = 0.0):
        b = {k: tt.group_rows(x, g, data_split, n_data) for k, x in mbatch.items()}
        leaves = g.map(lambda i: {k: t.gather_over(oaxes, g.slots[i]).detach().requires_grad_(
            torch.is_grad_enabled()) for k, t in params.items()})
        ps = g.map(lambda i, lv: tt.nested({k: v if v.dtype == compute else v.to(compute)
                                            for k, v in lv.items()}), leaves)
        t = b["labels"].shape[0] * b["labels"].shape[1]
        cap = tt.moe_capacity(cfg, t, n_data, data_split) if cfg.family == "moe" else 0
        if "record" in moe_kw:
            tt.loss_group(g, cfg, ps, b, compute, cap, moe_kw)
            return []
        mine = count(b)
        w = mine / max(total, 1.0) if mine > 0 else 0.0
        ce, aux = tt.loss_group(g, cfg, ps, b, compute, cap, moe_kw)
        # a recorded moe loss is already the shard's share of the global aux
        aux_w = 1.0 if "f_global" in moe_kw else w
        loss = w * ce[0] + step_cfg.aux_weight * aux_w * aux[0]
        names = list(params)
        flat = [lv[k] for lv in leaves for k in names]
        got = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        return [(s, {k: got[i * len(names) + j].to(torch.float32) for j, k in enumerate(names)},
                 loss.detach(), (w * ce[0]).detach()) for i, s in enumerate(g.slots)]

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        mb = step_cfg.microbatches
        with partition.logical_axes(mapping), partition.set_mesh(mesh):
            active = [s for g in tt.tp_groups(cfg, 1)[0] for s in g.slots] if tp else list(range(mesh.size))
        grads: List[Optional[dict]] = [None] * mesh.size
        loss_acc = [0.0] * mesh.size
        ce_acc = [0.0] * mesh.size
        # the dry run counts one microbatch as mb identical trips
        trips = 1 if tp and partition.lead_group_only() else mb
        for j in range(trips):
            mbatch = batch if mb == 1 else {k: v[j] for k, v in batch.items()}
            shared: dict = {}
            if cfg.family == "moe" and n_data > 1 and not tp:
                shared["moe_counts"] = {}
                for slot in leads:
                    run_slot(params, mbatch, slot, shared, record=True)
                t_global = mbatch["labels"].numel()
                shared = {"moe_f": {k: c / t_global for k, c in shared["moe_counts"].items()}}
            with partition.repeated(mb // trips):
                got = tp_grads(params, mbatch) if tp else [(s, *run_slot(params, mbatch, s, shared))
                                                            for s in range(mesh.size)]
            for slot, g, loss, ce in got:
                with torch.no_grad():
                    if mb == 1:
                        grads[slot] = g
                    elif grads[slot] is None:
                        grads[slot] = {k: x / mb for k, x in g.items()}
                    else:
                        for k, x in g.items():
                            grads[slot][k] += x / mb
                loss_acc[slot] = loss_acc[slot] + loss / mb
                ce_acc[slot] = ce_acc[slot] + ce / mb
            del got
        with torch.no_grad():
            if tp and partition.lead_group_only():  # the dry run: the other groups' alike
                lead = {compat.shard_index(mesh, s, maxes): s for s in active}
                for s in range(mesh.size):
                    if grads[s] is None:
                        twin = lead[compat.shard_index(mesh, s, maxes)]
                        grads[s], loss_acc[s], ce_acc[s] = grads[twin], loss_acc[twin], ce_acc[twin]
            merged: List[Optional[dict]] = [None] * mesh.size
            losses, ces = [], []
            for grp in compat.groups(mesh, daxes):
                devs = [mesh.devices[s] for s in grp]
                if not any(s in active for s in grp):
                    continue
                with compat.slots_of(grp):
                    summed = {k: compat.psum([grads[s][k] for s in grp], devs) for k in grads[grp[0]]}
                    losses.append(compat.psum([loss_acc[s] for s in grp], devs)[0])
                    ces.append(compat.psum([ce_acc[s] for s in grp], devs)[0])
                for i, s in enumerate(grp):
                    merged[s] = {k: v[i] for k, v in summed.items()}
            del grads, summed
            if tp:
                merged = _tp_merge_model(merged, params, mesh, maxes, active, mspec)
            if sync:
                merged = (_tp_sync(merged, params, mesh, maxes, mspec, step_cfg, param_pspecs) if tp else
                          gradmod.compressed_grad_sync(merged, mesh, step_cfg.sync_axis,
                                                       step_cfg.grad_compression, param_pspecs))
            gnorm = _tp_norm(merged, mesh, maxes, mspec) if tp else global_norm(merged[0])
            scale = (torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                     if opt_cfg.clip_norm is not None else None)
            new_state = opt_state
            # the dry run counts the first slot's update alone
            for slot in (active[:1] if partition.lead_group_only() else active):
                with partition.slot_program(mesh, slot, {}):
                    dev = mesh.devices[slot]
                    p_s, m_s, v_s, g_s = {}, {}, {}, {}
                    for k, t in params.items():
                        sl = t.own_in(oaxes, slot)
                        g = merged[slot][k][sl]
                        g_s[k] = g if scale is None else (g * scale.to(dev)).to(g.dtype)
                        p_s[k], m_s[k], v_s[k] = (t.shards[slot], opt_state.m[k].shards[slot],
                                                  opt_state.v[k].shards[slot])
                    updates, new_state, om = shard_update(g_s, AdamWState(opt_state.step, m_s, v_s), p_s)
                    apply_updates_(p_s, updates)
                    del updates, g_s
        opt_state = AdamWState(step=new_state.step, m=opt_state.m, v=opt_state.v)
        return params, opt_state, {"loss": losses[0], "ce": ces[0], "grad_norm": gnorm, "lr": om["lr"]}

    return init_fn, train_step


def microbatch_split(batch: Dict[str, Any], mb: int) -> Dict[str, Any]:
    """Split a flat batch into (mb, b, ...) leaves."""
    if mb <= 1:
        return batch
    return {k: x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:])) for k, x in batch.items()}


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(model, cache, inputs_t) -> (cache, next_token int32 (B, 1)),
    greedy (the reference's default; its sampling variant has no caller).
    Under tensor parallelism the argmax runs over the split vocab
    (`transformer.decode_greedy`)."""

    def serve_step(model, cache, inputs_t: torch.Tensor):
        return decode_greedy(model, cfg, cache, inputs_t)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_seq_len: Optional[int] = None) -> Callable:
    """prefill_step(model, inputs) -> (cache, logits (B, 1, V))."""

    def prefill_step(model, inputs: torch.Tensor):
        return prefill(model, cfg, inputs, cache_seq_len)

    return prefill_step


def _tp_merge_model(merged, params, mesh, maxes, active, mspec):
    """Under tensor parallelism: the gradient of a leaf that the model axes
    do not split holds each model slot's part; summed over the group."""
    out = list(merged)
    for grp in compat.groups(mesh, maxes):
        if not any(s in active for s in grp):
            continue
        devs = [mesh.devices[s] for s in grp]
        for i, s in enumerate(grp):
            out[s] = dict(merged[s])
        for k in params:
            if mspec[k] is None:
                with compat.slots_of(grp):
                    summed = compat.psum([merged[s][k] for s in grp], devs)
                for i, s in enumerate(grp):
                    out[s][k] = summed[i]
    return out


def _tp_norm(merged, mesh, maxes, mspec) -> torch.Tensor:
    """The global gradient norm from the model shards of the first data
    shard's group: each slot's squared norms of its split leaves, the
    replicated leaves' on the first slot alone, summed (`compat.psum`)."""
    grp = compat.groups(mesh, maxes)[0]
    devs = [mesh.devices[s] for s in grp]
    parts = []
    for i, s in enumerate(grp[:1] if partition.lead_group_only() else grp):
        with partition.slot_program(mesh, s, {}):
            sq = [torch.sum(torch.square(g.to(torch.float32))) for k, g in merged[s].items()
                  if mspec[k] is not None or i == 0]
            parts.append(torch.sum(torch.stack(sq)))
    parts = parts + parts[:1] * (len(grp) - len(parts))
    with compat.slots_of(grp):
        return torch.sqrt(compat.psum(parts, devs)[0])


def _tp_sync(merged, params, mesh, maxes, mspec, step_cfg, param_pspecs):
    """The compressed pod sync under tensor parallelism: each data shard's
    model shards all-gathered over its group into whole leaves, synced as
    the reference's partial-manual `shard_map` syncs its global leaves (the
    quantizer's chunks run over the whole leaf), and cut back to each
    slot's shard. Every slot of a group holds the same whole leaves, so the
    sync runs once per data shard, over the mesh of the groups' first
    slots."""
    from repro_torch.runtime.elastic import DeviceMesh

    groups = compat.groups(mesh, maxes)
    whole = []
    for grp in groups:
        devs = [mesh.devices[s] for s in grp]
        tree = {}
        for k in params:
            d = mspec[k]
            with compat.slots_of(grp):
                tree[k] = (merged[grp[0]][k] if d is None
                           else compat.all_gather([merged[s][k] for s in grp], devs, dim=d)[0])
        whole.append(tree)
    rest = [a for a in mesh.axis_names if a not in maxes]
    leads = DeviceMesh(tuple(mesh.devices[g[0]] for g in groups),
                       tuple(mesh.shape[mesh.axis_names.index(a)] for a in rest), tuple(rest))
    synced = gradmod.compressed_grad_sync(whole, leads, step_cfg.sync_axis, step_cfg.grad_compression,
                                          param_pspecs)
    out: List[Optional[dict]] = [None] * mesh.size
    for grp, tree in zip(groups, synced):
        for i, s in enumerate(grp):
            out[s] = {k: (v if mspec[k] is None else
                          v.narrow(mspec[k], i * (v.shape[mspec[k]] // len(grp)), v.shape[mspec[k]] // len(grp))
                          .to(mesh.devices[s]))
                      for k, v in tree.items()}
    return out
