"""Step builders (port of `repro/launch/steps.py`).

`make_train_step` returns (init_fn, train_step): microbatched gradient
accumulation in float32, optional compressed gradient sync across a mesh
axis, AdamW applied in place, and metrics. `make_serve_step` /
`make_prefill_step` wrap the decode and prefill paths.
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
from repro_torch.models.transformer import Transformer, decode_step, init_params, loss_fn, prefill
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
    The model axis's slots replicate their data shard's compute: splitting
    it (tensor parallelism) is the next ROADMAP item."""
    from repro_torch.runtime.elastic import logical_mapping
    from repro_torch.runtime.sharding import Placement

    mapping = partition.current_axes() or logical_mapping(mesh.axis_names)
    daxes = data_axes(mesh, mapping)
    n_data = compat.n_slots(mesh, daxes)
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

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        mb = step_cfg.microbatches
        grads: List[Optional[dict]] = [None] * mesh.size
        loss_acc = [0.0] * mesh.size
        ce_acc = [0.0] * mesh.size
        for j in range(mb):
            mbatch = batch if mb == 1 else {k: v[j] for k, v in batch.items()}
            shared: dict = {}
            if cfg.family == "moe" and n_data > 1:
                shared["moe_counts"] = {}
                for slot in leads:
                    run_slot(params, mbatch, slot, shared, record=True)
                t_global = mbatch["labels"].numel()
                shared = {"moe_f": {k: c / t_global for k, c in shared["moe_counts"].items()}}
            for slot in range(mesh.size):
                g, loss, ce = run_slot(params, mbatch, slot, shared)
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
                del g
        with torch.no_grad():
            merged: List[Optional[dict]] = [None] * mesh.size
            losses, ces = [], []
            for grp in compat.groups(mesh, daxes):
                devs = [mesh.devices[s] for s in grp]
                summed = {k: compat.psum([grads[s][k] for s in grp], devs) for k in grads[grp[0]]}
                for i, s in enumerate(grp):
                    merged[s] = {k: v[i] for k, v in summed.items()}
                losses.append(compat.psum([loss_acc[s] for s in grp], devs)[0])
                ces.append(compat.psum([ce_acc[s] for s in grp], devs)[0])
            del grads, summed
            if sync:
                merged = gradmod.compressed_grad_sync(merged, mesh, step_cfg.sync_axis,
                                                      step_cfg.grad_compression, param_pspecs)
            gnorm = global_norm(merged[0])
            scale = (torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                     if opt_cfg.clip_norm is not None else None)
            new_state = opt_state
            for slot in range(mesh.size):
                dev = mesh.devices[slot]
                p_s, m_s, v_s, g_s = {}, {}, {}, {}
                for k, t in params.items():
                    sl = t.placement.slices(t.shape, slot)
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
    greedy (the reference's default; its sampling variant has no caller)."""

    def serve_step(model, cache, inputs_t: torch.Tensor):
        cache, logits = decode_step(model, cfg, cache, inputs_t)
        return cache, torch.argmax(logits, dim=-1).to(torch.int32)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_seq_len: Optional[int] = None) -> Callable:
    """prefill_step(model, inputs) -> (cache, logits (B, 1, V))."""

    def prefill_step(model, inputs: torch.Tensor):
        return prefill(model, cfg, inputs, cache_seq_len)

    return prefill_step
