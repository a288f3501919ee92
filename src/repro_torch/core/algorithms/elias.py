"""Byte-unaligned stateless codecs (port of `repro/core/algorithms/elias.py`):
Tcomp32 (lossless) and UANUQ (lossy).

Tcomp32 is simplified Elias coding (paper §3.1.4): suppress leading zeros
of each 32-bit tuple and emit a 6-bit length prefix followed by the
significant bits *minus the implicit leading one*, so 16-bit values cost
6+15=21 bits. The output is bit-granular; the
carry-free packer absorbs the shift/mask work.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import bits
from repro_torch.core.algorithms import nuq
from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register

PREFIX_BITS = 6


@register("tcomp32")
class Tcomp32(Codec):
    meta = CodecMeta("tcomp32", lossy=False, stateful=False, state_kind="none", aligned=False)

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        v = bits._u(x)
        nbits = bits.bit_length(v).to(torch.int64)
        nstored = (nbits - 1).clamp(min=0)  # MSB is implicit for v > 0
        stored = v & bits.mask_bits(nstored)
        # code = [6-bit length][stored bits], LSB-first
        c0 = (nbits & 0x3F) | bits._safe_lshift(stored, PREFIX_BITS)
        c1 = bits._safe_rshift(stored, 32 - PREFIX_BITS)
        codes = bits._i32(torch.stack([c0, c1], dim=-1))
        return state, Encoded(codes, (PREFIX_BITS + nstored).to(torch.int32))

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        c0 = bits._u(enc.codes[..., 0])
        c1 = bits._u(enc.codes[..., 1])
        nbits = c0 & 0x3F
        nstored = (nbits - 1).clamp(min=0)
        stored = (
            bits._safe_rshift(c0, PREFIX_BITS) | bits._safe_lshift(c1, 32 - PREFIX_BITS)
        ) & bits.mask_bits(nstored)
        msb = torch.where(
            nbits > 0, bits._safe_lshift(torch.ones_like(c0), nstored), torch.zeros_like(c0)
        )
        return state, bits._i32(stored | msb)


@register("uanuq")
class UANUQ(Codec):
    """Unaligned NUQ: mu-law quantize to exactly `qbits` bits per tuple
    (the tables of `nuq.py`)."""

    meta = CodecMeta("uanuq", lossy=True, stateful=False, state_kind="none", aligned=False)

    def __init__(self, qbits: int = 12, vmax: float = float(2**32 - 1), mu: float = nuq.DEFAULT_MU):
        self.qbits = qbits
        self.vmax = vmax
        self.mu = mu

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        q = nuq.mulaw_encode_unsigned(bits._u(x).clamp(max=int(self.vmax)), self.qbits, self.vmax, self.mu)
        codes = torch.stack([q, torch.zeros_like(q)], dim=-1)
        blen = torch.full(x.shape, self.qbits, dtype=torch.int32, device=x.device)
        return state, Encoded(codes, blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        v = nuq.mulaw_decode_unsigned(enc.codes[..., 0], self.qbits, self.vmax, self.mu)
        return state, nuq.to_u32_saturating(v)

    def error_bound(self) -> float:
        return nuq.mulaw_max_abs_err(self.qbits, self.vmax, self.mu)
