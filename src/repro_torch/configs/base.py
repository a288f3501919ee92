"""Architecture registry (port of `repro/configs/base.py`): ArchSpec, the
LM shape set, `register_arch`, `get_arch`, `arch_ids`.

The port registers all ten of the reference's architectures: the dense
`qwen3-1.7b`, `deepseek-coder-33b`, `mistral-nemo-12b` and
`phi4-mini-3.8b`, the moe `mixtral-8x7b` and `qwen3-moe-30b-a3b`, the ssm
`mamba2-1.3b`, the hybrid `recurrentgemma-9b`, and the dense backbones
behind embedding front ends, `musicgen-large` and `pixtral-12b`.
`get_arch` of an unknown id raises a KeyError. `input_specs` gives the
dry run's stand-ins for a cell's feeds: `torch.empty(..., device="meta")`
tensors of the reference's shapes and dtypes (the port's
`jax.ShapeDtypeStruct`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


#: the assigned LM shape set: decode_*/long_* run the serve step
TRAIN_4K = ShapeSpec("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524_288, 1)
LM_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

FULL_ATTN_SKIP = (
    "long_500k needs sub-quadratic attention; pure full-attention arch — "
    "skipped per task spec (DESIGN.md §6)"
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    source: str  # provenance tag from the assignment table
    shapes: Tuple[ShapeSpec, ...] = LM_SHAPES
    skips: Optional[Dict[str, str]] = None  # shape name -> reason
    notes: str = ""

    def runnable_shapes(self) -> Tuple[ShapeSpec, ...]:
        skips = self.skips or {}
        return tuple(s for s in self.shapes if s.name not in skips)


_REGISTRY: Dict[str, Callable[[], ArchSpec]] = {}

def register_arch(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _REGISTRY:
        return _REGISTRY[arch_id]()
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")


def arch_ids():
    return sorted(_REGISTRY)


# ------------------------------------------------------------ input specs --
def input_specs(spec: ArchSpec, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Stand-ins on the `meta` device for every model input of (arch,
    shape), no storage allocated.

    train:   {inputs, labels}           prefill: {inputs}
    decode:  {inputs_t} (the KV cache is built by the launcher: it is
             carried state, not a feed).
    For embedding-frontend archs (musicgen, pixtral) `inputs` are
    precomputed frame/patch embeddings (B, S, d_model) in bfloat16."""
    cfg = spec.model
    b, s = shape.global_batch, shape.seq_len

    def ins(rows: int, cols: int) -> torch.Tensor:
        if cfg.input_kind == "embeddings":
            return torch.empty((rows, cols, cfg.d_model), dtype=torch.bfloat16, device="meta")
        return torch.empty((rows, cols), dtype=torch.int32, device="meta")

    if shape.kind == "train":
        return {"inputs": ins(b, s), "labels": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if shape.kind == "prefill":
        return {"inputs": ins(b, s)}
    return {"inputs_t": ins(b, 1)}
