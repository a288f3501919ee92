"""Public wrappers of the CUDA kernels (port of `repro/kernels/ops.py`).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, and then:
  * on CPU tensors, returns the plain version (`kernels/ref.py`);
  * on CUDA tensors, launches its kernel on the current stream, adds one to
    its plain-integer `launches` count, and raises if the launch failed.
There is no fallback from a CUDA tensor to the plain version.

uint32 data travels as int32 tensors holding the same bits (ROADMAP C1).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bitpack, bitunpack, frame_compact, ref


def _check(t: torch.Tensor, name: str, ndim: int, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def pack_blocks(codes: torch.Tensor, bitlen: torch.Tensor,
                block: int = bitpack.DEFAULT_BLOCK, out_words: Optional[int] = None):
    """Pack int32[N, 2] codes with int32[N] bitlens (0..64) into per-block
    word-aligned bitstreams: (words int32[N/block, out_words], nbits
    int32[N/block]). `out_words` defaults to 2*block+1 (the Pallas kernel's
    width); the executor passes lanes*B*2+2 (the frame's `bits.pack_bits`)."""
    dev = codes.device
    _check(codes, "codes", 2, dev)
    _check(bitlen, "bitlen", 1, dev)
    n = codes.shape[0]
    if codes.shape[1] != 2 or bitlen.shape[0] != n:
        raise ValueError(f"codes {tuple(codes.shape)} and bitlen {tuple(bitlen.shape)} disagree")
    if block < 1 or n % block:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    out_words = bitpack.words_per_block(block) if out_words is None else out_words
    if out_words < 1:
        raise ValueError(f"out_words must be >= 1, got {out_words}")
    if dev.type == "cpu":
        return ref.pack_blocks_ref(codes, bitlen, block, out_words)
    words = torch.empty((n // block, out_words), dtype=torch.int32, device=dev)
    nbits = torch.empty((n // block,), dtype=torch.int32, device=dev)
    bitpack.launch(codes, bitlen, words, nbits, block)
    pack_blocks.launches += 1
    return words, nbits


def unpack_blocks(words: torch.Tensor, bitlen: torch.Tensor, block: Optional[int] = None):
    """Unpack per-block bitstreams int32[nb, W] with int32[nb*S] bitlens back
    into int32[nb*S, 2] codes (0-bit slots give zero codes). `block` (S) is
    inferred from the shapes when omitted."""
    dev = words.device
    _check(words, "words", 2, dev)
    _check(bitlen, "bitlen", 1, dev)
    nb, in_words = words.shape
    if block is None:
        block = bitlen.shape[0] // nb if nb else 0
    if bitlen.shape[0] != nb * block:
        raise ValueError(f"bitlen has {bitlen.shape[0]} symbols, expected {nb}*{block}")
    if in_words < 1:
        raise ValueError("words rows must hold at least one word")
    if dev.type == "cpu":
        return ref.unpack_blocks_ref(words, bitlen)
    codes = torch.empty((nb * block, 2), dtype=torch.int32, device=dev)
    bitunpack.launch(words, bitlen, codes)
    unpack_blocks.launches += 1
    return codes


def compact_blocks(words: torch.Tensor, nbits: torch.Tensor):
    """Gather-compact int32[n, OW] worst-case word buffers into one payload:
    (payload int32[n*OW], total_words int32 scalar tensor); the `total`
    prefix is the wire payload, the rest zeros."""
    dev = words.device
    _check(words, "words", 2, dev)
    _check(nbits, "nbits", 1, dev)
    n, ow = words.shape
    if nbits.shape[0] != n:
        raise ValueError(f"nbits has {nbits.shape[0]} entries for {n} blocks")
    if dev.type == "cpu":
        return ref.compact_blocks_ref(words, nbits)
    payload = torch.empty((n * ow,), dtype=torch.int32, device=dev)
    total = torch.zeros((1,), dtype=torch.int32, device=dev)
    frame_compact.launch_compact(words, nbits, payload, total)
    compact_blocks.launches += 1
    return payload, total[0]


def pack_meta7_blocks(bitlen: torch.Tensor) -> torch.Tensor:
    """Pack int32[n, S] per-block bitlens at 7 bits/symbol into
    int32[n, ceil(7S/32)] words (bit-identical to the host serializer)."""
    dev = bitlen.device
    _check(bitlen, "bitlen", 2, dev)
    n, symbols = bitlen.shape
    if dev.type == "cpu":
        return ref.pack_meta7_ref(bitlen)
    out = torch.empty((n, (7 * symbols + 31) // 32), dtype=torch.int32, device=dev)
    frame_compact.launch_meta7(bitlen, out)
    pack_meta7_blocks.launches += 1
    return out


#: the kernel wrappers, by kernel name
WRAPPERS = {
    "pack_blocks": pack_blocks,
    "unpack_blocks": unpack_blocks,
    "compact_blocks": compact_blocks,
    "pack_meta7_blocks": pack_meta7_blocks,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Each wrapper's kernel launches since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = [
    "compact_blocks",
    "launch_counts",
    "pack_blocks",
    "pack_meta7_blocks",
    "reset_launches",
    "unpack_blocks",
]
