"""LEB128 family (port of `repro/core/algorithms/leb128.py`): LEB128
(lossless, stateless, aligned), Delta-LEB128 (lossless, value state) and
LEB128-NUQ (lossy, stateless, aligned).

LEB128 follows Android-Dex (paper Alg. 2): 7 data bits per byte, MSB is the
continuation flag. The byte-append loop becomes a fixed 5-step vectorized
byte assembly (32-bit tuples need at most 5 groups).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.algorithms import nuq
from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register


def leb128_encode_words(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized LEB128: (c0, c1, bitlen) for uint32 values; c0/c1 are
    int32 bit patterns, bitlen int32."""
    v = bits._u(v)
    nbytes = ((bits.bit_length(v).to(torch.int64) + 6) // 7).clamp(min=1)
    c0 = torch.zeros_like(v)
    c1 = torch.zeros_like(v)
    for i in range(5):
        group = (v >> (7 * i)) & 0x7F
        cont = (nbytes > i + 1).to(torch.int64) << 7
        byte = torch.where(nbytes > i, group | cont, torch.zeros_like(v))
        if i < 4:
            c0 = c0 | (byte << (8 * i))
        else:
            c1 = c1 | byte
    return bits._i32(c0), bits._i32(c1), (nbytes * 8).to(torch.int32)


def leb128_decode_words(codes: torch.Tensor, bitlen: torch.Tensor) -> torch.Tensor:
    """Inverse of leb128_encode_words on symbol slots (int32 bit patterns)."""
    c0 = bits._u(codes[..., 0])
    c1 = bits._u(codes[..., 1])
    nbytes = bitlen.to(torch.int64) // 8
    v = torch.zeros_like(c0)
    for i in range(5):
        byte = (c0 >> (8 * i)) & 0xFF if i < 4 else c1 & 0xFF
        group = byte & 0x7F
        v = v | torch.where(nbytes > i, group << (7 * i), torch.zeros_like(v))
    return bits._i32(v)  # group 4's bits past 32 wrap away, as in uint32


@register("leb128")
class LEB128(Codec):
    meta = CodecMeta("leb128", lossy=False, stateful=False, state_kind="none", aligned=True)

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        c0, c1, blen = leb128_encode_words(x)
        return state, Encoded(torch.stack([c0, c1], dim=-1), blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        return state, leb128_decode_words(enc.codes, enc.bitlen)


@register("delta_leb128")
class DeltaLEB128(Codec):
    """Delta (value state, paper Alg. 4) + zigzag + LEB128.

    The delta is computed in uint32 wraparound arithmetic and zigzag is a
    bijection, so the codec is lossless for arbitrary inputs. Within a call
    the deltas are a shifted difference (parallel); the lane state carries
    the last value across calls.
    """

    # not maskable: the decoder's `prev` replays from decoded symbols, so pad
    # symbols must travel on the wire or session state forks at each pad
    meta = CodecMeta(
        "delta_leb128", lossy=False, stateful=True, state_kind="value",
        aligned=True, maskable=False,
    )
    state_dtypes = {"prev": np.dtype(np.uint32)}

    def init_state(self, lanes: int, device: torch.device):
        return {"prev": torch.zeros((lanes,), dtype=torch.int32, device=device)}

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        x = x.to(torch.int32)
        prev = torch.cat([state["prev"][:, None], x[:, :-1]], dim=1)
        delta = bits._i32(bits._u(x) - bits._u(prev))  # uint32 wraparound
        c0, c1, blen = leb128_encode_words(bits.zigzag_encode(delta))
        return {"prev": x[:, -1]}, Encoded(torch.stack([c0, c1], dim=-1), blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        z = leb128_decode_words(enc.codes, enc.bitlen)
        delta = bits._u(bits.zigzag_decode(z))
        # prefix-sum turns the sequential reconstruction into a parallel scan
        x = bits._i32(bits._u(state["prev"])[:, None] + torch.cumsum(delta, dim=1))
        return {"prev": x[:, -1]}, x


@register("leb128_nuq")
class LEB128NUQ(Codec):
    """Lossy: mu-law NUQ of the value (the tables of `nuq.py`), then LEB128
    of the quantized code."""

    meta = CodecMeta("leb128_nuq", lossy=True, stateful=False, state_kind="none", aligned=True)

    def __init__(self, qbits: int = 8, vmax: float = float(2**32 - 1), mu: float = nuq.DEFAULT_MU):
        self.qbits = qbits
        self.vmax = vmax
        self.mu = mu

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        q = nuq.mulaw_encode_unsigned(bits._u(x).clamp(max=int(self.vmax)), self.qbits, self.vmax, self.mu)
        c0, c1, blen = leb128_encode_words(q)
        return state, Encoded(torch.stack([c0, c1], dim=-1), blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        q = leb128_decode_words(enc.codes, enc.bitlen)
        v = nuq.mulaw_decode_unsigned(q, self.qbits, self.vmax, self.mu)
        return state, nuq.to_u32_saturating(v)

    def error_bound(self) -> float:
        return nuq.mulaw_max_abs_err(self.qbits, self.vmax, self.mu)
