"""Architecture registry (port of `repro/configs/base.py`): ArchSpec, the
LM shape set, `register_arch`, `get_arch`, `arch_ids`.

The port registers all ten of the reference's architectures: the dense
`qwen3-1.7b`, `deepseek-coder-33b`, `mistral-nemo-12b` and
`phi4-mini-3.8b`, the moe `mixtral-8x7b` and `qwen3-moe-30b-a3b`, the ssm
`mamba2-1.3b`, the hybrid `recurrentgemma-9b`, and the dense backbones
behind embedding front ends, `musicgen-large` and `pixtral-12b`.
`get_arch` of an unknown id raises a KeyError. `input_specs` (the
reference's `jax.ShapeDtypeStruct` stand-ins for its dry-run) has no
counterpart yet: it comes with the dry run (ROADMAP A10 item 5b).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
