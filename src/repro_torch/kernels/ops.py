"""Public wrappers of the CUDA kernels (port of `repro/kernels/ops.py`).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, and then:
  * on CPU tensors, returns the plain version (`kernels/ref.py`);
  * on CUDA tensors, launches its kernel on the current stream, adds one to
    its plain-integer `launches` count, and raises if the launch failed.
There is no fallback from a CUDA tensor to the plain version.

B10's wrappers also take `meta` tensors (the dry run, `launch/dryrun.py`):
they return outputs of the right shape and dtype, launch nothing, count no
launch, and report the kernel's work to `META_COST`'s callbacks
(`launch/hlo_analysis.py: analyze_program`). No CPU or CUDA tensor takes
that form.

uint32 data travels as int32 tensors holding the same bits (ROADMAP C1).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core import bits
from repro_torch.core.algorithms import nuq
from repro_torch.kernels import (
    bitpack, bitunpack, delta_nuq, dict_hash, flash_attn, frame_compact, rans, ref,
)


def _check(t: torch.Tensor, name: str, ndim: int, device: torch.device,
           dtype: torch.dtype = torch.int32, meta: bool = False) -> None:
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
    if t.device.type not in (("cpu", "cuda", "meta") if meta else ("cpu", "cuda")):
        raise ValueError(f"{name}: unsupported device {t.device}")


def pack_blocks(codes: torch.Tensor, bitlen: torch.Tensor,
                block: int = bitpack.DEFAULT_BLOCK, out_words: Optional[int] = None):
    """Pack int32[N, 2] codes with int32[N] bitlens (0..64) into per-block
    word-aligned bitstreams: (words int32[N/block, out_words], nbits
    int32[N/block]). `out_words` defaults to 2*block+1 (the Pallas kernel's
    width); the executor passes lanes*B*2+2 (the frame's `bits.pack_bits`)."""
    out_words = _check_pack(codes, bitlen, block, out_words)
    if codes.device.type == "cpu":
        return ref.pack_blocks_ref(codes, bitlen, block, out_words)
    words, nbits = _pack_outputs(codes, block, out_words)
    bitpack.launch(codes, bitlen, words, nbits, block)
    pack_blocks.launches += 1
    return words, nbits


def pack_blocks_meta7(codes: torch.Tensor, bitlen: torch.Tensor, block: int,
                      out_words: Optional[int] = None):
    """`pack_blocks` and `pack_meta7_blocks` of the same bit lengths in one
    launch: (words int32[N/block, out_words], nbits int32[N/block], meta
    int32[N/block, 7*block/32]). `block` must be a multiple of 32, so that
    each block's metadata row is whole words (the executor's `_meta7_ok`)."""
    out_words = _check_pack(codes, bitlen, block, out_words)
    if block % 32:
        raise ValueError(f"block={block} must be a multiple of 32")
    rows = bitlen.view(-1, block)
    if codes.device.type == "cpu":
        return (*ref.pack_blocks_ref(codes, bitlen, block, out_words), ref.pack_meta7_ref(rows))
    words, nbits = _pack_outputs(codes, block, out_words)
    meta = torch.empty((rows.shape[0], 7 * block // 32), dtype=torch.int32, device=codes.device)
    bitpack.launch(codes, bitlen, words, nbits, block, meta)
    pack_blocks_meta7.launches += 1
    return words, nbits, meta


def _check_pack(codes: torch.Tensor, bitlen: torch.Tensor, block: int,
                out_words: Optional[int]) -> int:
    """B1's input checks; returns the row width."""
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
    return out_words


def _pack_outputs(codes: torch.Tensor, block: int, out_words: int):
    nb = codes.shape[0] // block
    return (torch.empty((nb, out_words), dtype=torch.int32, device=codes.device),
            torch.empty((nb,), dtype=torch.int32, device=codes.device))


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
    if n == 0:
        return payload, torch.zeros((), dtype=torch.int32, device=dev)
    total = torch.empty((1,), dtype=torch.int32, device=dev)  # the kernel writes it
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


def _check_dict_chunk(table, valid, ts, clock, shape, idx_bits: int, dev) -> None:
    c, lanes, b = shape[:3]
    _check(table, "table", 2, dev)
    _check(valid, "valid", 2, dev, torch.uint8)
    _check(ts, "ts", 2, dev)
    _check(clock, "clock", 1, dev)
    if not 1 <= idx_bits <= 31:
        raise ValueError(f"idx_bits must be in [1, 31], got {idx_bits}")
    want = (lanes, 1 << idx_bits)
    if table.shape != want or valid.shape != want or ts.shape != want or clock.shape != (lanes,):
        raise ValueError(
            f"table {tuple(table.shape)}, valid {tuple(valid.shape)}, ts {tuple(ts.shape)} and "
            f"clock {tuple(clock.shape)} must be {want} and ({lanes},) for idx_bits={idx_bits}")
    if not dict_hash.chunk_kernel_for(idx_bits, b, "frozen", None):
        raise ValueError(
            f"a table of 2^{idx_bits} slots with blocks of {b} tuples per lane does not fit in "
            f"one CTA's shared memory ({dict_hash.MAX_SMEM_BYTES} bytes)")
    if c * b > 2**31 - 1:
        raise ValueError(f"{c} blocks x {b} tuples exceed the kernels' int32 positions")


def dict_chunk_encode(blocks: torch.Tensor, table: torch.Tensor, valid: torch.Tensor,
                      ts: torch.Tensor, clock: torch.Tensor, idx_bits: int = 12):
    """Tdic32's frozen, private-state encode of C blocks int32[C, L, B]
    from the state (table int32, valid uint8, ts int32 [L, 2^idx_bits],
    clock int32[L]), the table frozen per block: (codes int32[C, L, B, 2],
    bitlen int32[C, L, B], table, valid, ts, clock), the state as C block
    encodes and merges leave it. On CUDA one launch of the codec-form
    kernel for the chunk; raises outside `dict_hash.chunk_kernel_for`'s
    shared-memory rule on either device."""
    dev = blocks.device
    _check(blocks, "blocks", 3, dev)
    c, lanes, b = blocks.shape
    _check_dict_chunk(table, valid, ts, clock, blocks.shape, idx_bits, dev)
    if dev.type == "cpu":
        return ref.dict_chunk_encode_ref(blocks, table, valid, ts, clock, idx_bits)
    codes = torch.empty((c, lanes, b, 2), dtype=torch.int32, device=dev)
    bitlen = torch.empty((c, lanes, b), dtype=torch.int32, device=dev)
    state = (table, valid, ts, clock)
    if c * b * lanes == 0:  # nothing to walk: the state stays as it was
        return (codes, bitlen, *(t.clone() for t in state))
    out_state = tuple(torch.empty_like(t) for t in state)
    dict_hash.launch_chunk_encode(blocks, state, idx_bits, codes, bitlen, out_state)
    dict_chunk_encode.launches += 1
    return (codes, bitlen, *out_state)


def dict_chunk_decode(codes: torch.Tensor, table: torch.Tensor, valid: torch.Tensor,
                      ts: torch.Tensor, clock: torch.Tensor, idx_bits: int = 12):
    """`dict_chunk_encode`'s inverse: codes int32[C, L, B, 2] (symbol
    slots) and the state -> (values int32[C, L, B], table, valid, ts,
    clock). On CUDA one launch of the codec-form decode kernel."""
    dev = codes.device
    _check(codes, "codes", 4, dev)
    c, lanes, b, two = codes.shape
    if two != 2:
        raise ValueError(f"codes must be (C, L, B, 2) symbol slots, got {tuple(codes.shape)}")
    _check_dict_chunk(table, valid, ts, clock, codes.shape, idx_bits, dev)
    if dev.type == "cpu":
        return ref.dict_chunk_decode_ref(codes, table, valid, ts, clock, idx_bits)
    values = torch.empty((c, lanes, b), dtype=torch.int32, device=dev)
    state = (table, valid, ts, clock)
    if c * b * lanes == 0:
        return (values, *(t.clone() for t in state))
    out_state = tuple(torch.empty_like(t) for t in state)
    dict_hash.launch_chunk_decode(codes, state, idx_bits, values, out_state)
    dict_chunk_decode.launches += 1
    return (values, *out_state)


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


def rans_section_encode(data: torch.Tensor, freqs: torch.Tensor):
    """B8's section form: a section's bytes uint8[n] under one frequency
    table int32[256] -> (states int32[C, 8], counts int32[C, 8], words
    int32[n // 2 + 1], total int64 0-d tensor), C = ceil(n / 4096): the
    E = total u16s of the stream, in (chunk, lane) order and each lane's in
    row order, packed two to a word, low half first, in words[:ceil(E/2)]
    (the odd pad half zero; words after those are not part of the result).
    What `assemble_stream(*rans_encode(...))` gives on the section's chunk
    grid. On CUDA two kernel launches around a `torch.cumsum`, no sync."""
    dev = data.device
    _check(data, "data", 1, dev, torch.uint8)
    _check(freqs, "freqs", 1, dev)
    if freqs.shape[0] != 256:
        raise ValueError(f"freqs must have 256 entries, got {tuple(freqs.shape)}")
    if dev.type == "cpu":
        return ref.rans_section_encode_ref(data, freqs)
    n = data.numel()
    c = -(-n // rans.CHUNK_BYTES)
    states = torch.empty((c, rans.N_LANES), dtype=torch.int32, device=dev)
    counts = torch.empty((c, rans.N_LANES), dtype=torch.int32, device=dev)
    words = torch.empty((rans.section_words(n),), dtype=torch.int32, device=dev)
    if n == 0:
        return states, counts, words, torch.zeros((), dtype=torch.int64, device=dev)
    total = rans.launch_section_encode(data, freqs, states, counts, words)
    rans_section_encode.launches += 1
    return states, counts, words, total


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


def rans_section_decode(words: torch.Tensor, total: int, freqs: torch.Tensor,
                        states: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """B9's section form: a section's packed stream words int32[ceil(total
    / 2)] (two u16 to a word, low half first, as in the frame), its table
    int32[256], lane states and lane counts int32[C, 8] -> its n bytes
    uint8[n], C = ceil(n / 4096). Each lane starts at the exclusive sum of
    the counts before it; reads behave as over the `total` u16s zero-padded
    to `rans.decode_cap(C)` entries (so the odd pad half reads 0). What
    `rans_decode` gives on the unpacked stream and the section's chunk grid,
    narrowed to bytes. The table must be one the decoder accepts
    (non-negative, summing to 4096), as `entropy.decode_section` checks. On
    CUDA one kernel launch after a `torch.cumsum`, no sync."""
    dev = words.device
    _check(words, "words", 1, dev)
    _check(freqs, "freqs", 1, dev)
    _check(states, "states", 2, dev)
    _check(counts, "counts", 2, dev)
    total, n = int(total), int(n)
    c = -(-n // rans.CHUNK_BYTES)
    if n < 0 or states.shape != (c, rans.N_LANES) or counts.shape != states.shape:
        raise ValueError(f"states {tuple(states.shape)} and counts {tuple(counts.shape)} must be "
                         f"({c}, {rans.N_LANES}) for n={n}")
    if freqs.shape[0] != 256:
        raise ValueError(f"freqs must have 256 entries, got {tuple(freqs.shape)}")
    if total < 0 or words.numel() != (total + 1) // 2:
        raise ValueError(f"words has {words.numel()} entries for a stream of {total} u16s")
    cap = rans.decode_cap(c)
    if total > cap:
        raise ValueError(f"a stream of {total} u16s exceeds the decoder's {cap} entries for {c} chunks")
    if dev.type == "cpu":
        return ref.rans_section_decode_ref(words, total, freqs, states, counts, n)
    out = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    rans.launch_section_decode(words, total, freqs, states, counts, out)
    rans_section_decode.launches += 1
    return out


def _check_qbits(qbits: int) -> None:
    top = nuq.MAX_TABLE_BITS + 1
    if not 2 <= qbits <= top:
        raise ValueError(f"qbits must be in [2, {top}] (a sign bit and a tabled magnitude), got {qbits}")


def _check_tiles(t: torch.Tensor, name: str, sublanes: int, t_tile: int) -> None:
    s, n = t.shape
    if sublanes < 1 or t_tile < 1 or s % sublanes or n % t_tile:
        raise ValueError(f"{name} {tuple(t.shape)} must tile by (sublanes={sublanes}, t_tile={t_tile})")


def adpcm_encode(x: torch.Tensor, qbits: int = 8, dmax: float = 1.0, mu: float = 255.0,
                 sublanes: int = delta_nuq.DEFAULT_SUBLANES, t_tile: int = delta_nuq.DEFAULT_T):
    """Block ADPCM encode, the Pallas contract: x float32[S, T] substreams
    -> codes int32[S, T] (uint32 bits; code[:, 0] of each t_tile tile is
    the bit-cast raw sample). S % sublanes == 0 and T % t_tile == 0."""
    dev = x.device
    _check(x, "x", 2, dev, torch.float32)
    _check_qbits(qbits)
    _check_tiles(x, "x", sublanes, t_tile)
    if dev.type == "cpu":
        return ref.delta_nuq_encode_ref(x, qbits, dmax, mu, t_tile)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, False, dev)
    codes = torch.empty(x.shape, dtype=torch.int32, device=dev)
    delta_nuq.launch_tile_encode(x, t_tile, dmax, thr, dec, qbits, codes)
    adpcm_encode.launches += 1
    return codes


def adpcm_decode(codes: torch.Tensor, qbits: int = 8, dmax: float = 1.0, mu: float = 255.0,
                 sublanes: int = delta_nuq.DEFAULT_SUBLANES, t_tile: int = delta_nuq.DEFAULT_T):
    """Block ADPCM decode, the Pallas contract: codes int32[S, T] ->
    float32[S, T], a running float32 sum per tile."""
    dev = codes.device
    _check(codes, "codes", 2, dev)
    _check_qbits(qbits)
    _check_tiles(codes, "codes", sublanes, t_tile)
    if dev.type == "cpu":
        return ref.delta_nuq_decode_ref(codes, qbits, dmax, mu, t_tile)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, False, dev)
    x = torch.empty(codes.shape, dtype=torch.float32, device=dev)
    delta_nuq.launch_tile_decode(codes, t_tile, thr, dec, qbits, x)
    adpcm_decode.launches += 1
    return x


def _check_lane_state(xhat: torch.Tensor, init: torch.Tensor, lanes: int, dev) -> None:
    _check(xhat, "xhat", 1, dev, torch.float32)
    _check(init, "init", 1, dev, torch.bool)
    if xhat.shape[0] != lanes or init.shape[0] != lanes:
        raise ValueError(f"xhat {tuple(xhat.shape)} and init {tuple(init.shape)} must hold {lanes} lanes")


def _lane_encode(blocks, xhat, init, qbits, vmax, dmax, mu, width, kernel: str):
    dev = blocks.device
    _check(blocks, "blocks", 3, dev)
    c, lanes, b = blocks.shape
    _check_lane_state(xhat, init, lanes, dev)
    _check_qbits(qbits)
    if dev.type == "cpu":
        return ref.adpcm_lane_encode_ref(blocks, xhat, init, qbits, vmax, dmax, mu, width)
    codes = torch.empty((c, lanes, b, 2), dtype=torch.int32, device=dev)
    bitlen = torch.empty((c, lanes, b), dtype=torch.int32, device=dev)
    if c * b == 0:  # nothing to walk: the state stays as it was
        return codes, bitlen, xhat.clone(), init.clone()
    if lanes > 65535:
        raise ValueError(f"{lanes} lanes exceed the launch grid's 65535")
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, True, dev)
    xhat, init = xhat.clone(), init.clone()
    launch = (delta_nuq.launch_lane_encode if kernel == delta_nuq.SPECULATIVE_ENCODE
              else delta_nuq.launch_lane_encode_serial)
    launch(blocks, xhat, init.view(torch.uint8), vmax, dmax, thr, dec, qbits, width, codes, bitlen)
    WRAPPERS[kernel].launches += 1
    return codes, bitlen, xhat, init


def adpcm_lane_encode(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                      qbits: int, vmax: float, dmax: float, mu: float, width: int):
    """The ADPCM codec's encode of C blocks int32[C, L, B] as one per-lane
    walk of each lane's C*B tuples, from the state (xhat float32[L], init
    bool[L]): (codes int32[C, L, B, 2], bitlen int32[C, L, B], xhat, init).
    `width` is the bitlen of a quantized symbol; a fresh lane's first
    symbol is its raw tuple at 32 bits. On CUDA, the speculative segmented
    kernel, for every parameter set."""
    return _lane_encode(blocks, xhat, init, qbits, vmax, dmax, mu, width,
                        delta_nuq.SPECULATIVE_ENCODE)


def adpcm_lane_encode_serial(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                             qbits: int, vmax: float, dmax: float, mu: float, width: int):
    """`adpcm_lane_encode` on the serial kernel (one thread per lane), the
    card-side oracle of the speculative one; no path calls it."""
    return _lane_encode(blocks, xhat, init, qbits, vmax, dmax, mu, width, delta_nuq.SERIAL_ENCODE)


def _lane_decode(codes, xhat, init, qbits, vmax, dmax, mu, serial: bool):
    dev = codes.device
    _check(codes, "codes", 4, dev)
    c, lanes, b, two = codes.shape
    if two != 2:
        raise ValueError(f"codes must be (C, L, B, 2) symbol slots, got {tuple(codes.shape)}")
    _check_lane_state(xhat, init, lanes, dev)
    _check_qbits(qbits)
    if dev.type == "cpu":
        return ref.adpcm_lane_decode_ref(codes, xhat, init, qbits, vmax, dmax, mu)
    out = torch.empty((c, lanes, b), dtype=torch.int32, device=dev)
    if c * b == 0:
        return out, xhat.clone(), init.clone()
    if lanes > 65535:
        raise ValueError(f"{lanes} lanes exceed the launch grid's 65535")
    kernel = delta_nuq.SERIAL_DECODE if serial else delta_nuq.lane_decode_kernel(qbits, vmax, dmax, mu)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, True, dev)
    xhat, init = xhat.clone(), init.clone()
    launch = (delta_nuq.launch_lane_decode if kernel == delta_nuq.SCAN_DECODE
              else delta_nuq.launch_lane_decode_serial)
    launch(codes, xhat, init.view(torch.uint8), vmax, thr, dec, qbits, out)
    WRAPPERS[kernel].launches += 1
    return out, xhat, init


def adpcm_lane_decode(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                      qbits: int, vmax: float, dmax: float, mu: float):
    """The ADPCM codec's decode of C blocks' codes int32[C, L, B, 2] (word
    0) as one per-lane walk from the state: (values int32[C, L, B] uint32
    bits, xhat, init).

    On CUDA, `delta_nuq.lane_decode_kernel` picks the kernel: inside its
    integer rule the clamp-add scan (counted here), outside it the serial
    walk (counted as `adpcm_lane_decode_serial`)."""
    return _lane_decode(codes, xhat, init, qbits, vmax, dmax, mu, serial=False)


def adpcm_lane_decode_serial(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                             qbits: int, vmax: float, dmax: float, mu: float):
    """`adpcm_lane_decode` on the serial kernel, for any parameters."""
    return _lane_decode(codes, xhat, init, qbits, vmax, dmax, mu, serial=True)


_FLASH_DTYPES = (torch.bfloat16, torch.float32)


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int], softcap: Optional[float]) -> None:
    dev = q.device
    _check(q, "q", 4, dev, q.dtype, meta=True)
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    _check(k, "k", 4, dev, q.dtype, meta=True)
    _check(v, "v", 4, dev, q.dtype, meta=True)
    b, sq, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} disagree")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if not 1 <= dh <= flash_attn.MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {flash_attn.MAX_HEAD_DIM}], got {dh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not (math.isfinite(softcap) and softcap > 0):
        raise ValueError(f"softcap must be None or a finite value > 0, got {softcap}")
    if dev.type == "cuda" and (b > 65535 or kv > 65535):
        raise ValueError(f"batch {b} and kv heads {kv} must each be <= 65535 (the launch grid)")


#: callbacks (name, flops over the unmasked pairs, flops over every pair,
#: bytes, transcendentals) of B10's meta form
META_COST: list = []


def _flash_meta(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
                causal: bool, lse: bool):
    """B10 on `meta` tensors: the outputs' shapes and dtypes, nothing
    launched or counted; its flops (QK^T and PV over the unmasked pairs,
    `flash_attn.flops`), bytes (q, k, v read once, out and lse written
    once) and exponentials (one per unmasked pair) reported to
    `META_COST`."""
    b, sq, h, dh = q.shape
    out = torch.empty_like(q)
    lse_t = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if lse else None
    flops = flash_attn.flops(b, sq, k.shape[1], h, dh, window, causal)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out)) + (4 * b * h * sq if lse else 0)
    for fn in META_COST:
        fn(name, float(flops), 4.0 * b * h * dh * sq * k.shape[1], float(nbytes), float(flops // (4 * dh)))
    return (out, lse_t) if lse else out


def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """`flash_attn.kernel_for` on the inputs (shapes already checked)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    groups = q.shape[2] // k.shape[2]
    return flash_attn.kernel_for(q.dtype, q.shape[3], groups, aligned, q.shape[1] * groups)


def _flash_launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int], causal: bool, softcap: Optional[float],
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `kernel` and count the launch on the wrapper of its form:
    the kernel's own without `lse`, its lse form's (`_LSE_FORM`) with it."""
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        if lse is not None:
            lse.fill_(-float("inf"))
        return out.zero_()
    launch = flash_attn.launch_tc if kernel == flash_attn.TENSOR_CORE else flash_attn.launch
    launch(q, k, v, out, window, causal, lse, softcap)
    WRAPPERS[kernel if lse is None else _LSE_FORM[kernel]].launches += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None, causal: bool = True,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """GQA flash attention forward, the Pallas contract (`flash_fwd`): q
    (B, Sq, H, Dh) against k/v (B, Sk, K, Dh) at positions arange(Sq) x
    arange(Sk), causal and/or a sliding window (keys > q_pos - window),
    float32 softmax, the output (B, Sq, H, Dh) in q's dtype. All three
    bfloat16 or all float32, H % K == 0, 1 <= Dh <= 256; any Sq and Sk.
    `softcap` (None, or finite and > 0) caps each unmasked key's scaled
    score s to softcap * tanh(s / softcap), as the reference's blocked scan
    does.

    On CUDA, `flash_attn.kernel_for` picks the kernel (the cap does not):
    bfloat16 with Dh a multiple of 16 and H / K <= 64 runs on the tensor
    cores (counted as `flash_attention_fwd_tc`), the rest on the FMA kernel
    (counted here). A refused launch raises; neither kernel stands in for
    the other."""
    _check_flash(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_reference(q, k, v, window, causal, softcap)
    if q.device.type == "meta":
        return _flash_meta("flash_attention_fwd", q, k, v, window, causal, lse=False)
    return _flash_launch(_flash_kernel(q, k, v), q, k, v, window, causal, softcap)


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            window: Optional[int] = None, causal: bool = True,
                            softcap: Optional[float] = None):
    """`flash_attention_fwd` that also returns each query row's log-sum-exp
    of its scaled, capped, masked scores: (out (B, Sq, H, Dh) in q's dtype, lse
    float32 (B, H, Sq)), the training forward's residual (the reference's
    `_flash_core_fwd`). The same kernel as `flash_attention_fwd` runs, by
    `flash_attn.kernel_for`, writing lse beside out; out is bit for bit
    what `flash_attention_fwd` gives. The tensor-core kernel's launches in
    this form are counted here, the FMA kernel's on
    `flash_attention_fwd_lse_fma`."""
    _check_flash(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_reference_lse(q, k, v, window, causal, softcap)
    if q.device.type == "meta":
        return _flash_meta("flash_attention_fwd_lse", q, k, v, window, causal, lse=True)
    return _flash_lse_launch(_flash_kernel(q, k, v), q, k, v, window, causal, softcap)


def flash_attention_fwd_lse_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                window: Optional[int] = None, causal: bool = True,
                                softcap: Optional[float] = None):
    """`flash_attention_fwd_lse` on the FMA kernel alone, whatever
    `flash_attn.kernel_for` would pick (the float32 training forward's
    kernel). On CPU tensors, the plain version."""
    _check_flash(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_reference_lse(q, k, v, window, causal, softcap)
    if q.device.type == "meta":
        return _flash_meta("flash_attention_fwd_lse_fma", q, k, v, window, causal, lse=True)
    return _flash_lse_launch(flash_attn.FMA, q, k, v, window, causal, softcap)


def _flash_lse_launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int], causal: bool, softcap: Optional[float]):
    """(out, lse float32 (B, H, Sq)) from `kernel`."""
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _flash_launch(kernel, q, k, v, window, causal, softcap, lse), lse


def flash_attention_fwd_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: Optional[int] = None, causal: bool = True,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """`flash_attention_fwd` on the tensor-core kernel alone: raises
    ValueError for inputs outside `flash_attn.kernel_for`'s rule. On CPU
    tensors inside the rule, the plain version."""
    _check_flash(q, k, v, window, softcap)
    if q.device.type == "meta":
        return _flash_meta("flash_attention_fwd_tc", q, k, v, window, causal, lse=False)
    if _flash_kernel(q, k, v) != flash_attn.TENSOR_CORE:
        raise ValueError(
            f"{q.dtype} q {tuple(q.shape)} against {k.shape[2]} kv heads is outside the "
            "tensor-core kernel's rule (bfloat16, head_dim % 16 == 0, H / K <= 64, 16-byte aligned)")
    if q.device.type == "cpu":
        return ref.flash_reference(q, k, v, window, causal, softcap)
    return _flash_launch(flash_attn.TENSOR_CORE, q, k, v, window, causal, softcap)


#: the kernel wrappers, by kernel name
WRAPPERS = {
    "pack_blocks": pack_blocks,
    "pack_blocks_meta7": pack_blocks_meta7,
    "unpack_blocks": unpack_blocks,
    "compact_blocks": compact_blocks,
    "pack_meta7_blocks": pack_meta7_blocks,
    "dict_probe": dict_probe,
    "dict_chunk_encode": dict_chunk_encode,
    "dict_chunk_decode": dict_chunk_decode,
    "rans_encode": rans_encode,
    "rans_section_encode": rans_section_encode,
    "rans_decode": rans_decode,
    "rans_section_decode": rans_section_decode,
    "adpcm_encode": adpcm_encode,
    "adpcm_decode": adpcm_decode,
    "adpcm_lane_encode": adpcm_lane_encode,
    "adpcm_lane_encode_serial": adpcm_lane_encode_serial,
    "adpcm_lane_decode": adpcm_lane_decode,
    "adpcm_lane_decode_serial": adpcm_lane_decode_serial,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_fwd_tc": flash_attention_fwd_tc,
    "flash_attention_fwd_lse": flash_attention_fwd_lse,
    "flash_attention_fwd_lse_fma": flash_attention_fwd_lse_fma,
}
#: B10's kernels -> the wrapper that counts their launches in the lse form
_LSE_FORM = {flash_attn.TENSOR_CORE: "flash_attention_fwd_lse", flash_attn.FMA: "flash_attention_fwd_lse_fma"}
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
    "adpcm_decode",
    "adpcm_encode",
    "adpcm_lane_decode",
    "adpcm_lane_decode_serial",
    "adpcm_lane_encode",
    "adpcm_lane_encode_serial",
    "compact_blocks",
    "dict_chunk_decode",
    "dict_chunk_encode",
    "dict_probe",
    "flash_attention_fwd",
    "flash_attention_fwd_lse",
    "flash_attention_fwd_lse_fma",
    "flash_attention_fwd_tc",
    "launch_counts",
    "pack_blocks",
    "pack_blocks_meta7",
    "pack_meta7_blocks",
    "rans_decode",
    "rans_encode",
    "rans_section_decode",
    "rans_section_encode",
    "reset_launches",
    "unpack_blocks",
]
