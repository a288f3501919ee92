"""Raw32: the bypass codec (port of `repro/core/algorithms/raw.py`).

Emits every tuple verbatim as a 32-bit symbol, so the wire payload is the
input stream bit-for-bit (plus frame header/metadata): the cheapest legal
member of the tier ladder and an honest ratio-1.0 baseline.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register


@register("raw32")
class Raw32(Codec):
    """Pass-through: 32-bit symbol per tuple, zero transform work."""

    meta = CodecMeta(
        "raw32", lossy=False, stateful=False, state_kind="none", aligned=True
    )

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        x = x.to(torch.int32)
        codes = torch.stack([x, torch.zeros_like(x)], dim=-1)
        blen = torch.full(x.shape, 32, dtype=torch.int32, device=x.device)
        return state, Encoded(codes, blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        return state, enc.codes[..., 0]
