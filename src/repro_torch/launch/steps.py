"""The serving loop's step functions (port of the serving half of
`repro/launch/steps.py`): `make_prefill_step` and `make_serve_step` wrap
the prefill and decode paths of `models/transformer.py`. The training half
(`make_train_step`, `microbatch_split`) waits for the training slice
(ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


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
