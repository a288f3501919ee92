"""Plain PyTorch versions of the CUDA kernels (port of `repro/kernels/ref.py`
for the kernels ported so far). They repeat the kernels' arithmetic with the
tensor ops of `core/bits.py`: the CPU path of `ops`, and the oracle the
kernels are held against on the card, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bits


def pack_blocks_ref(codes: torch.Tensor, bitlen: torch.Tensor, block: int,
                    out_words: Optional[int] = None):
    """Block-local packing (carry-free scatter-add): int32[N, 2] codes and
    int32[N] bitlens -> (words int32[N/block, out_words], nbits int32[N/block]).
    `out_words` defaults to the kernel contract's 2*block+1."""
    nblocks = codes.shape[0] // block
    out_words = 2 * block + 1 if out_words is None else out_words
    words, totals, _ = bits.pack_bits(
        codes.reshape(nblocks, block, 2), bitlen.reshape(nblocks, block), out_words
    )
    return words, totals


def unpack_blocks_ref(words: torch.Tensor, bitlen: torch.Tensor):
    """`bits.unpack_symbols` per block: int32[nb, W] words and int32[nb*S]
    bitlens -> int32[nb*S, 2] codes."""
    nblocks = words.shape[0]
    codes, _ = bits.unpack_symbols(words, bitlen.reshape(nblocks, -1))
    return codes.reshape(-1, 2)


def compact_blocks_ref(words: torch.Tensor, nbits: torch.Tensor):
    """`bits.compact_payload`: (payload int32[n*OW], total int32)."""
    return bits.compact_payload(words, nbits)


def pack_meta7_ref(bitlen: torch.Tensor) -> torch.Tensor:
    """`bits.pack_meta7` per row: int32[n, S] -> int32[n, ceil(7S/32)]."""
    return bits.pack_meta7(bitlen)
