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

from repro_torch.core import bits
from repro_torch.kernels import bitpack, bitunpack, dict_hash, frame_compact, rans, ref


def _check(t: torch.Tensor, name: str, ndim: int, device: torch.device,
           dtype: torch.dtype = torch.int32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        what = "int32 (uint32 bits)" if dtype == torch.int32 else str(dtype)
        raise TypeError(f"{name} must be {what}, got {t.dtype}")
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


def dict_probe(x: torch.Tensor, table: torch.Tensor, valid: torch.Tensor, idx_bits: int = 12):
    """Probe uint32 words int32[L, N] against per-lane frozen tables
    int32[L, 2^idx_bits] (valid uint8[L, 2^idx_bits]): (c0, c1, bitlen)
    int32[L, N]. L = 1 is the Pallas kernel's contract."""
    dev = x.device
    _check(x, "x", 2, dev)
    _check(table, "table", 2, dev)
    _check(valid, "valid", 2, dev, torch.uint8)
    if not 1 <= idx_bits <= 31:
        raise ValueError(f"idx_bits must be in [1, 31], got {idx_bits}")
    lanes = x.shape[0]
    if table.shape != (lanes, 1 << idx_bits) or valid.shape != table.shape:
        raise ValueError(
            f"table {tuple(table.shape)} and valid {tuple(valid.shape)} must be "
            f"({lanes}, {1 << idx_bits}) for x {tuple(x.shape)}, idx_bits={idx_bits}"
        )
    if dev.type == "cpu":
        return ref.probe_ref(x, table, valid, idx_bits)
    c0, c1, bitlen = (torch.empty_like(x) for _ in range(3))
    dict_hash.launch(x, table, valid, idx_bits, c0, c1, bitlen)
    dict_probe.launches += 1
    return c0, c1, bitlen


def _check_grid(syms_or_mask: torch.Tensor, name: str, dev, dtype) -> None:
    _check(syms_or_mask, name, 3, dev, dtype)
    if syms_or_mask.shape[2] != rans.N_LANES:
        raise ValueError(f"{name} must be (C, T, {rans.N_LANES}), got {tuple(syms_or_mask.shape)}")


def rans_encode(syms: torch.Tensor, mask: torch.Tensor, freqs: torch.Tensor):
    """Interleaved rANS encode of C chunks' (C, T, 8) byte grids (int32
    bytes, bool mask) under one frequency table int32[256]: (states
    int32[C, 8], flags int32[C, T, 8], vals int32[C, T, 8]), flags and
    u16 values at the original row."""
    dev = syms.device
    _check_grid(syms, "syms", dev, torch.int32)
    _check_grid(mask, "mask", dev, torch.bool)
    _check(freqs, "freqs", 1, dev)
    if mask.shape != syms.shape or freqs.shape[0] != 256:
        raise ValueError(f"syms {tuple(syms.shape)}, mask {tuple(mask.shape)} and freqs "
                         f"{tuple(freqs.shape)} disagree")
    if dev.type == "cpu":
        return ref.rans_encode_ref(syms, mask, freqs)
    c, t_rows, n = syms.shape
    states = torch.empty((c, n), dtype=torch.int32, device=dev)
    flags = torch.empty_like(syms)
    vals = torch.empty_like(syms)
    cum = bits._i32(rans.cum_freqs(freqs))
    rans.launch_encode(syms, mask.view(torch.uint8), freqs, cum, states, flags, vals)
    rans_encode.launches += 1
    return states, flags, vals


def rans_decode(stream: torch.Tensor, freqs: torch.Tensor, states: torch.Tensor,
                offsets: torch.Tensor, mask: torch.Tensor, cap: Optional[int] = None):
    """Forward rANS decode of C chunks: the u16 `stream` int32[S], table
    int32[256], lane states int32[C, 8] and absolute lane offsets int32
    [C, 8], mask bool[C, T, 8] -> bytes int32[C, T, 8]. Reads clip to
    [0, cap-1] of the stream zero-padded to `cap` entries (default S, the
    Pallas contract's padded stream)."""
    dev = mask.device
    _check(stream, "stream", 1, dev)
    _check(freqs, "freqs", 1, dev)
    _check(states, "states", 2, dev)
    _check(offsets, "offsets", 2, dev)
    _check_grid(mask, "mask", dev, torch.bool)
    cap = stream.numel() if cap is None else int(cap)
    c = mask.shape[0]
    if states.shape != (c, rans.N_LANES) or offsets.shape != states.shape or freqs.shape[0] != 256:
        raise ValueError(f"states {tuple(states.shape)}, offsets {tuple(offsets.shape)} and "
                         f"freqs {tuple(freqs.shape)} disagree with mask {tuple(mask.shape)}")
    if cap < 1 or cap < stream.numel():
        raise ValueError(f"cap={cap} must be >= 1 and cover the {stream.numel()}-entry stream")
    if dev.type == "cpu":
        return ref.rans_decode_ref(stream, cap, freqs, states, offsets, mask)
    syms = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    cum = bits._i32(rans.cum_freqs(freqs))
    lut = rans.slot_table(freqs).to(torch.int32)
    rans.launch_decode(stream, cap, freqs, cum, lut, states, offsets, mask.view(torch.uint8), syms)
    rans_decode.launches += 1
    return syms


#: the kernel wrappers, by kernel name
WRAPPERS = {
    "pack_blocks": pack_blocks,
    "unpack_blocks": unpack_blocks,
    "compact_blocks": compact_blocks,
    "pack_meta7_blocks": pack_meta7_blocks,
    "dict_probe": dict_probe,
    "rans_encode": rans_encode,
    "rans_decode": rans_decode,
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
    "dict_probe",
    "launch_counts",
    "pack_blocks",
    "pack_meta7_blocks",
    "rans_decode",
    "rans_encode",
    "reset_launches",
    "unpack_blocks",
]
