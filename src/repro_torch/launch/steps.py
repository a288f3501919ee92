"""Step builders (port of `repro/launch/steps.py`).

`make_train_step` returns (init_fn, train_step): microbatched gradient
accumulation in float32, optional compressed gradient sync across a mesh
axis, AdamW applied in place, and metrics. `make_serve_step` /
`make_prefill_step` wrap the decode and prefill paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import gradient as gradmod
from repro_torch.core.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, decode_step, init_params, loss_fn, prefill
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw, apply_updates_


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
    holding `step_cfg.sync_axis`, the gradients go through
    `gradient.compressed_grad_sync` before AdamW. One model trains in one
    process, so that axis must have one slot: data parallelism over a wider
    axis (a model and a batch shard per slot) is ROADMAP A10's and is
    refused here, as is `param_pspecs` (logical sharding through
    `runtime/sharding.py`, not ported)."""
    if param_pspecs is not None:
        raise NotImplementedError("make_train_step(param_pspecs=...) shards parameters through "
                                  "runtime/sharding.py, which is not ported (ROADMAP A10)")
    sync = (step_cfg.grad_compression is not None and mesh is not None
            and step_cfg.sync_axis in mesh.axis_names)
    if sync and mesh.shape[mesh.axis_names.index(step_cfg.sync_axis)] != 1:
        raise NotImplementedError(
            f"make_train_step syncs the gradients of one model: a {step_cfg.sync_axis!r} axis of "
            f"{mesh.shape[mesh.axis_names.index(step_cfg.sync_axis)]} slots needs one model per slot "
            "(data parallelism, ROADMAP A10)")
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
