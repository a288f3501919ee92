"""Bit-level utilities for stream compression, in PyTorch (port of
`repro/core/bits.py`).

Two halves, as in the reference:

  * **Device ops** on tensors: bit lengths, shifts and masks, the carry-free
    packer (`pack_bits`), its inverse (`extract_bits`, `unpack_symbols`),
    compaction of per-block word buffers (`compact_payload`) and the 7-bit
    metadata packer (`pack_meta7`). Every emitted symbol owns a *disjoint*
    bit range, so integer ADD of the shifted contributions is exactly
    bitwise OR; the scatter-add below is the data-parallel form of the
    sequential bit append. These are the plain versions of the CUDA kernels
    in `repro_torch/csrc/` (`repro_torch/kernels/ops.py` dispatches).
  * **Host side** in numpy, byte-identical to the reference: CRC32C, the
    `FrameError` family, `Frame` (de)serialization, `FrameStream` resync.

Word representation: torch's `uint32` lacks shifts, `+` and comparisons, so
uint32 words cross every function boundary here as `torch.int32` tensors
holding the same bit pattern. The arithmetic inside runs on `int64` with
values in [0, 2^32), where every shift by 0..32 is defined. Helpers named
`_u`/`_i32` convert between the two; `u32_tensor`/`u32_numpy` convert to and
from numpy `uint32` arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

M32 = 0xFFFFFFFF


# ======================================================================
# uint32 words as int32 tensors
# ======================================================================


def _u(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or int64 value) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & M32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same low 32 bits."""
    t = t & M32
    return (t - ((t & 0x80000000) << 1)).to(torch.int32)


def u32_tensor(a, device: Union[str, torch.device]) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor (same bits) on `device`."""
    arr = np.ascontiguousarray(np.asarray(a, np.uint32))
    if not arr.flags.writeable:  # torch tensors must own writable memory
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bit patterns -> numpy uint32 array (host copy)."""
    return t.detach().to("cpu", torch.int32).contiguous().numpy().view(np.uint32)


def _shift_amount(s, like: torch.Tensor) -> torch.Tensor:
    if isinstance(s, torch.Tensor):
        return s.to(device=like.device, dtype=torch.int64)
    return torch.full((), int(s), dtype=torch.int64, device=like.device)


# ======================================================================
# Device ops (plain versions; int64 arithmetic, int32 words at the edges)
# ======================================================================


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Number of significant bits in each uint32 (0 for 0), as int32."""
    v = _u(v)
    n = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for shift in (16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        n = torch.where(big, n + shift, n)
        v = torch.where(big, v >> shift, v)
    return (n + (v > 0).to(torch.int64)).to(torch.int32)


def _safe_rshift(x: torch.Tensor, s) -> torch.Tensor:
    """x >> s on int64 values in [0, 2^32), with s possibly >= 32 (gives 0)."""
    s = _shift_amount(s, x)
    return torch.where(s >= 32, torch.zeros_like(x), x >> s.clamp(0, 31))


def _safe_lshift(x: torch.Tensor, s) -> torch.Tensor:
    """(x << s) mod 2^32 on int64 values, with s possibly >= 32 (gives 0)."""
    s = _shift_amount(s, x)
    return torch.where(s >= 32, torch.zeros_like(x), (x << s.clamp(0, 31)) & M32)


def mask_bits(nbits) -> torch.Tensor:
    """Low-`nbits` mask as int64 in [0, 2^32); nbits >= 32 gives all ones."""
    if not isinstance(nbits, torch.Tensor):
        nbits = torch.tensor(nbits, dtype=torch.int64)
    return (1 << nbits.to(torch.int64).clamp(0, 32)) - 1


def code64_shift(c0: torch.Tensor, c1: torch.Tensor, s: torch.Tensor):
    """Shift the 64-bit code (c0 low word, c1 high word; int64 values in
    [0, 2^32)) left by s (0..31). Returns the int64 words (lo, mid, hi) of
    the 96-bit result."""
    s = s.to(torch.int64)
    r = 32 - s
    lo = _safe_lshift(c0, s)
    mid = _safe_rshift(c0, r) | _safe_lshift(c1, s)
    hi = _safe_rshift(c1, r)
    return lo, mid, hi


def pack_bits(codes: torch.Tensor, bitlen: torch.Tensor, out_words: int):
    """Pack variable-length codes into a dense bitstream (batched).

    Args:
      codes: int32[..., N, 2] — low/high words of each symbol's code.
      bitlen: int[..., N] — valid bits per symbol (0 = not emitted).
      out_words: static size of the output word buffer (worst case).

    Returns:
      words: int32[..., out_words] — packed bitstream, LSB-first in words.
      total_bits: int32[...].
      offsets: int32[..., N] — bit offset of each symbol.

    Contributions past `out_words` are dropped, as the reference's
    `.at[].add(mode="drop")`: they land in one spill word that is cut off.
    """
    bl = bitlen.to(torch.int64)
    offsets = torch.cumsum(bl, dim=-1) - bl
    total_bits = bl.sum(dim=-1)
    c = _u(codes)
    c0 = c[..., 0] & mask_bits(bl.clamp(max=32))
    c1 = c[..., 1] & mask_bits((bl - 32).clamp(min=0))
    w = offsets >> 5
    lo, mid, hi = code64_shift(c0, c1, offsets & 31)
    emit = bl > 0
    buf = torch.zeros(
        bl.shape[:-1] + (out_words + 1,), dtype=torch.int64, device=bl.device
    )
    for k, part in enumerate((lo, mid, hi)):
        idx = torch.clamp(w + k, max=out_words)  # out of range -> spill word
        buf.scatter_add_(-1, idx, torch.where(emit, part, torch.zeros_like(part)))
    words = _i32(buf[..., :out_words])
    return words, total_bits.to(torch.int32), offsets.to(torch.int32)


def extract_bits(words: torch.Tensor, offsets: torch.Tensor, nbits: torch.Tensor):
    """Extract `nbits`-long fields at `offsets` from packed bitstreams.

    `words` int32[..., W], `offsets`/`nbits` int[..., N] (nbits 0..64).
    Returns int32[..., N, 2] codes (low/high words). Reads past the end see
    the last word, then zeros, as the reference's clipped gather does."""
    wu = _u(words)
    n = wu.shape[-1]
    off = offsets.to(torch.int64)
    nb = nbits.to(torch.int64)
    w = off >> 5
    s = off & 31

    def gather(k: int) -> torch.Tensor:
        g = torch.gather(wu, -1, torch.clamp(w + k, 0, n - 1))
        return g if k == 0 else torch.where(w + k < n, g, torch.zeros_like(g))

    g0, g1, g2 = gather(0), gather(1), gather(2)
    r = 32 - s
    lo = _safe_rshift(g0, s) | _safe_lshift(g1, r)
    hi = _safe_rshift(g1, s) | _safe_lshift(g2, r)
    lo = lo & mask_bits(nb.clamp(max=32))
    hi = hi & mask_bits((nb - 32).clamp(min=0))
    return _i32(torch.stack([lo, hi], dim=-1))


def unpack_symbols(words: torch.Tensor, bitlen: torch.Tensor):
    """Reassemble `(codes, offsets)` from dense word streams (batched): an
    exclusive cumsum of `bitlen` gives every symbol's bit offset, then a
    3-word gather/shift (`extract_bits`) rebuilds each int32[2] code.
    0-bit slots come back as zero codes."""
    bl = bitlen.to(torch.int64)
    offsets = torch.cumsum(bl, dim=-1) - bl
    return extract_bits(words, offsets, bl), offsets.to(torch.int32)


def block_word_counts(nbits: torch.Tensor):
    """Per-block used-word counts `ceil(nbits/32)` and their exclusive
    prefix offsets (blocks start word-aligned on the wire)."""
    nw = (nbits.to(torch.int64) + 31) // 32
    offsets = torch.cumsum(nw, dim=0) - nw
    return nw, offsets


def compact_payload(words: torch.Tensor, nbits: torch.Tensor):
    """Gather-compact per-block worst-case word buffers into one payload.

    Args:
      words: int32[n, OW] — stacked per-block word buffers.
      nbits: int[n] — per-block bit counts.

    Returns:
      payload: int32[n*OW] — block b's live prefix at its exclusive-prefix
        word offset; zero past `total_words`.
      total_words: int32 scalar tensor.

    Every output word binary-searches the offset stream for its source
    block; `right=True` makes zero-width blocks transparent (equal offsets
    resolve to the last, the only word-owning, block at that position)."""
    n, ow = words.shape
    nw, offsets = block_word_counts(nbits)
    total = nw.sum()
    cap = n * ow
    if cap == 0:
        return torch.zeros(0, dtype=torch.int32, device=words.device), total.to(torch.int32)
    i = torch.arange(cap, dtype=torch.int64, device=words.device)
    b = torch.searchsorted(offsets, i, right=True) - 1
    src = torch.clamp(b * ow + (i - offsets[b.clamp(min=0)]), 0, cap - 1)
    flat = words.reshape(-1)
    payload = torch.where(i < total, flat[src], torch.zeros_like(flat[src]))
    return payload, total.to(torch.int32)


def pack_meta7(bitlen: torch.Tensor) -> torch.Tensor:
    """Pack 0..64 bitlens at 7 bits each into uint32 words (batched).

    int[..., S] -> int32[..., ceil(7S/32)], bit-identical to the host's
    `_pack_bitlens` on every row: symbol j's field sits at bit 7j, and the
    fields are disjoint, so ADD == OR within each word."""
    s_count = bitlen.shape[-1]
    mw = (7 * s_count + 31) // 32
    lead = bitlen.shape[:-1]
    if s_count == 0:
        return torch.zeros(lead + (0,), dtype=torch.int32, device=bitlen.device)
    off = torch.arange(s_count, dtype=torch.int64, device=bitlen.device) * 7
    w = (off >> 5).expand(lead + (s_count,))
    v = (bitlen.to(torch.int64) & 0x7F) << (off & 31)  # <= 38 significant bits
    acc = torch.zeros(lead + (mw + 1,), dtype=torch.int64, device=bitlen.device)
    acc.scatter_add_(-1, w, v & M32)
    acc.scatter_add_(-1, w + 1, v >> 32)
    return _i32(acc[..., :mw])


def zigzag_encode(d: torch.Tensor) -> torch.Tensor:
    """Map signed int32 deltas to uint32 bit patterns (int32 tensor) so
    small magnitudes are small."""
    d = d.to(torch.int32)
    return (d << 1) ^ (d >> 31)


def zigzag_decode(z: torch.Tensor) -> torch.Tensor:
    """Inverse of `zigzag_encode`: uint32 bit patterns -> signed int32."""
    z = z.to(torch.int32)
    return ((z >> 1) & 0x7FFFFFFF) ^ (-(z & 1))


# ======================================================================
# CRC-32C (Castagnoli) — frame integrity checksums (DESIGN.md §18)
#
# zlib/binascii only ship the ISO-HDLC polynomial, so the Castagnoli CRC
# is implemented here: a 256-entry reflected table drives both a scalar
# byte loop (small buffers) and a chunk-parallel numpy path (large ones).
# The parallel path exploits that the table update is GF(2)-linear in the
# register: split the buffer into 2^k equal chunks, run every chunk's
# table loop in lock-step over the byte columns, then fold adjacent
# remainders with cached zero-byte shift operators
# (`rem(A||B) = S_{|B|}(rem(A)) ^ rem(B)`), and finally add the affine
# init/xorout terms (`crc = S_len(0xFFFFFFFF) ^ rem ^ 0xFFFFFFFF`).
# ======================================================================

_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _crc32c_make_table() -> np.ndarray:
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(_CRC32C_POLY), crc >> 1)
    return crc.astype(np.uint32)


_CRC_TABLE: np.ndarray = _crc32c_make_table()
_CRC_TABLE_LIST: Tuple[int, ...] = tuple(int(x) for x in _CRC_TABLE)


def _crc32c_slice_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Slicing-by-4 tables: T_k advances T_{k-1}'s entries one zero byte."""
    t0 = _CRC_TABLE
    tabs = [t0]
    for _ in range(3):
        prev = tabs[-1]
        tabs.append(
            (
                (prev >> np.uint32(8))
                ^ t0[(prev & np.uint32(0xFF)).astype(np.intp)]
            ).astype(np.uint32)
        )
    return tabs[0], tabs[1], tabs[2], tabs[3]


_CRC_SLICE_TABLES = _crc32c_slice_tables()


def _crc_op_apply(op: np.ndarray, x: int) -> int:
    """Apply a GF(2)-linear register operator (32 basis images) to x."""
    r = 0
    j = 0
    while x:
        if x & 1:
            r ^= int(op[j])
        x >>= 1
        j += 1
    return r


def _crc_op_tables(nbytes: int) -> np.ndarray:
    """The shift-by-`nbytes` operator as 4x256 byte-lookup tables, so it
    applies to register vectors with 4 gathers instead of 32 bit tests."""
    tabs = _CRC_OP_TABLE_CACHE.get(nbytes)
    if tabs is not None:
        return tabs
    op = _crc_shift_op(nbytes)
    bvals = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), np.uint32)
    for k in range(4):
        acc = np.zeros(256, np.uint32)
        for j in range(8):
            acc ^= np.where((bvals >> np.uint32(j)) & np.uint32(1), op[8 * k + j], np.uint32(0))
        tabs[k] = acc
    _CRC_OP_TABLE_CACHE[nbytes] = tabs
    return tabs


def _crc_op_apply_vec(nbytes: int, v: np.ndarray) -> np.ndarray:
    """Advance every register in `v` past `nbytes` zero bytes (vectorized)."""
    tabs = _crc_op_tables(nbytes)
    m = np.uint32(0xFF)
    return (
        tabs[0][(v & m).astype(np.intp)]
        ^ tabs[1][((v >> np.uint32(8)) & m).astype(np.intp)]
        ^ tabs[2][((v >> np.uint32(16)) & m).astype(np.intp)]
        ^ tabs[3][(v >> np.uint32(24)).astype(np.intp)]
    )


def _crc_op_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Operator composition a∘b (apply b first, then a)."""
    return np.array([_crc_op_apply(a, int(b[j])) for j in range(32)], np.uint32)


def _crc_shift1() -> np.ndarray:
    # register image of one zero byte: r -> (r >> 8) ^ T[r & 0xFF]
    basis = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    return ((basis >> np.uint32(8)) ^ _CRC_TABLE[basis & np.uint32(0xFF)]).astype(
        np.uint32
    )


_CRC_SHIFT_CACHE: Dict[int, np.ndarray] = {}
_CRC_OP_TABLE_CACHE: Dict[int, np.ndarray] = {}


def _crc_shift_op(nbytes: int) -> np.ndarray:
    """Operator advancing the CRC register past `nbytes` zero bytes."""
    op = _CRC_SHIFT_CACHE.get(nbytes)
    if op is not None:
        return op
    if nbytes == 0:
        op = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    elif nbytes == 1:
        op = _crc_shift1()
    elif nbytes % 2 == 0:
        half = _crc_shift_op(nbytes // 2)
        op = _crc_op_compose(half, half)
    else:
        op = _crc_op_compose(_crc_shift_op(nbytes - 1), _crc_shift1())
    _CRC_SHIFT_CACHE[nbytes] = op
    return op


def _crc32c_update(crc: int, data: bytes) -> int:
    """Raw register update (no init/xorout) over `data`."""
    tab = _CRC_TABLE_LIST
    for b in data:
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return crc


def crc32c(data: Union[bytes, bytearray, memoryview, np.ndarray]) -> int:
    """CRC-32C (Castagnoli) of `data`; crc32c(b"123456789") == 0xE3069283.

    Buffers up to 2 KiB take the scalar table loop; larger ones run the
    chunk-parallel numpy path (identical result, validated in tests).
    """
    if isinstance(data, np.ndarray):
        b = np.ascontiguousarray(data).view(np.uint8).ravel()
    else:
        b = np.frombuffer(data, np.uint8)
    n = int(b.size)
    if n == 0:
        return 0
    if n <= 2048:
        return _crc32c_update(0xFFFFFFFF, b.tobytes()) ^ 0xFFFFFFFF
    # front-pad with zero bytes — no-ops for the init-0 remainder since
    # T[0] == 0 — so the chunk count is an exact power of two and the
    # fold tree stays balanced
    ncols = 64
    chunks = (n + ncols - 1) // ncols
    n_chunks = 1 << (chunks - 1).bit_length()
    padded = np.zeros(n_chunks * ncols, np.uint8)
    padded[-n:] = b
    # slicing-by-4 over contiguous little-endian word columns: 4 bytes per
    # register step, intp gather indices (uint32 ones gather ~3x slower)
    words = np.ascontiguousarray(padded.view("<u4").reshape(n_chunks, ncols // 4).T)
    r = np.zeros(n_chunks, np.uint32)
    t0, t1, t2, t3 = _CRC_SLICE_TABLES
    m = np.uint32(0xFF)
    for j in range(ncols // 4):
        e = r ^ words[j]
        r = (
            t3[(e & m).astype(np.intp)]
            ^ t2[((e >> np.uint32(8)) & m).astype(np.intp)]
            ^ t1[((e >> np.uint32(16)) & m).astype(np.intp)]
            ^ t0[(e >> np.uint32(24)).astype(np.intp)]
        )
    span = ncols
    while r.size > 1:
        r = _crc_op_apply_vec(span, r[0::2]) ^ r[1::2]
        span *= 2
    rem = int(r[0])
    return _crc_op_apply(_crc_shift_op(n), 0xFFFFFFFF) ^ rem ^ 0xFFFFFFFF


# ======================================================================
# Wire-frame error family (DESIGN.md §18)
#
# Every parse/decode failure surfaces as one of these — single-line,
# actionable, and typed so collectors can choose between resync
# (truncation/corruption) and rejection (version/feature skew). All are
# ValueError subclasses: pre-existing callers that catch ValueError keep
# working unchanged.
# ======================================================================


class FrameError(ValueError):
    """Base of the wire-frame error family; message is one actionable line."""


class FrameTruncatedError(FrameError):
    """The buffer disagrees with the header-declared layout length."""


class FrameHeaderError(FrameError):
    """Bad magic, unsupported version, or self-inconsistent header fields."""


class FrameFeatureError(FrameHeaderError):
    """The frame uses feature bits this build does not understand."""


class FrameIntegrityError(FrameError):
    """A section's stored CRC32C does not match its serialized bytes."""


class FrameDecodeError(FrameError):
    """The frame parsed but cannot be decoded here (codec/dict mismatch)."""


def _check_crc(section: str, stored: int, data: bytes) -> None:
    got = crc32c(data)
    if got != stored:
        raise FrameIntegrityError(
            f"frame integrity: {section} section CRC32C mismatch (stored "
            f"0x{stored:08x}, computed 0x{got:08x}); the frame is corrupt — "
            "discard it and resync"
        )


# ======================================================================
# Wire format (DESIGN.md §10)
#
# A Frame is the self-describing egress unit: header (codec id, block
# shape, counts) + per-block bit counts and valid-tuple counts + the
# per-symbol bitlen stream (7 bits/symbol, bitlens are 0..64) + the
# word-aligned concatenation of the per-block packed payloads. The bitlen
# stream is what makes decode embarrassingly parallel (EDPC-style
# decoupled dataflow): its exclusive cumsum yields every symbol's bit
# offset without parsing a single prefix, at a metadata cost of
# 7 bits/tuple that `Frame.wire_bytes` reports honestly.
#
# All serialization is host-side numpy on explicit little-endian uint32
# words; device code only ever sees the unpacked arrays. The port writes
# and reads the dict-id, CRC and entropy features; the rANS stage itself
# (`core/entropy.py`) runs on a device.
# ======================================================================

FRAME_MAGIC = 0x43535746  # "CSWF"
FRAME_VERSION = 1
_HDR_WORDS = 12
#: header word 1 = version (low 16 bits) | feature bits (high 16 bits).
#: A frame without features serializes word 1 as exactly FRAME_VERSION,
#: byte-identical to pre-feature builds; decoders reject unknown bits
#: instead of mis-parsing the body they gate.
FEATURE_ENTROPY = 1 << 16  # body is [counts | entropy blob], not [counts | meta | payload]
FEATURE_DICT = 1 << 17  # a dict-id blob follows the block counts (trained dictionary)
FEATURE_CRC = 1 << 18  # a per-section CRC32C trailer ends the frame (DESIGN.md §18)
_KNOWN_FEATURES = FEATURE_ENTROPY | FEATURE_DICT | FEATURE_CRC

#: serialized sections covered by the integrity trailer, in layout order;
#: absent sections checksum the empty string (CRC 0).
_CRC_SECTIONS = ("header", "counts", "dict", "meta", "payload")
_CRC_TRAILER_WORDS = len(_CRC_SECTIONS)
INTEGRITY_KINDS = ("crc32c",)


def _pack_dict_id(dict_id: Tuple[str, int]) -> np.ndarray:
    """Serialize (topic, version) as uint32 words: [nwords, version,
    topic_len, topic utf-8 zero-padded to word alignment]. Self-sizing via
    word 0, so the section can grow without a frame version bump."""
    topic, version = dict_id
    tb = topic.encode("utf-8")
    pad_words = (len(tb) + 3) // 4
    words = np.zeros(3 + pad_words, np.uint32)
    words[0] = 3 + pad_words
    words[1] = version
    words[2] = len(tb)
    if tb:
        words[3:] = np.frombuffer(tb + b"\x00" * (4 * pad_words - len(tb)), "<u4")
    return words


def _unpack_dict_id(words: np.ndarray) -> Tuple[str, int]:
    """Inverse of `_pack_dict_id`; the caller has validated the size."""
    tlen = int(words[2])
    topic = words[3:].astype("<u4").tobytes()[:tlen].decode("utf-8")
    return (topic, int(words[1]))


def _dict_id_words(dict_id: Optional[Tuple[str, int]]) -> int:
    """Serialized word count of the dict-id section (0 when absent)."""
    if dict_id is None:
        return 0
    return 3 + (len(dict_id[0].encode("utf-8")) + 3) // 4


def _pack_bitlens(bitlen: np.ndarray) -> np.ndarray:
    """Pack 0..64 bitlens at 7 bits each into uint32 words (host-side)."""
    bl = np.ascontiguousarray(bitlen, np.int64).ravel()
    n = bl.size
    nwords = int((7 * n + 31) // 32)
    if n == 0:
        return np.zeros(0, np.uint32)
    off = np.arange(n, dtype=np.int64) * 7
    w = off >> 5
    s = (off & 31).astype(np.uint64)
    v = (bl.astype(np.uint64) & 0x7F) << s  # up to 38 significant bits
    acc = np.zeros(nwords + 1, np.uint64)
    # fields are bit-disjoint, so ADD == OR within each word
    np.add.at(acc, w, v & 0xFFFFFFFF)
    np.add.at(acc, w + 1, v >> 32)
    return (acc[:nwords] & 0xFFFFFFFF).astype(np.uint32)


def _unpack_bitlens(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of `_pack_bitlens`: n 7-bit fields from uint32 words."""
    if n == 0:
        return np.zeros(0, np.int32)
    w64 = np.concatenate([words.astype(np.uint64), np.zeros(1, np.uint64)])
    off = np.arange(n, dtype=np.int64) * 7
    w = off >> 5
    s = (off & 31).astype(np.uint64)
    v = (w64[w] >> s) | (w64[w + 1] << (np.uint64(32) - s) & np.uint64(0xFFFFFFFFFFFFFFFF))
    return (v & 0x7F).astype(np.int32)


@dataclasses.dataclass
class Frame:
    """One stream's framed bitstream: header + metadata + payload.

    Blocks are, in order: `n_full` full blocks of shape (lanes, per_lane),
    an optional tail block of shape (lanes, tail_per_lane), and an optional
    flush mini-block of shape (lanes, flush_slots) holding the codec's
    trailing state symbols (e.g. RLE's open run). Each block's payload
    starts word-aligned; `block_bits[b]` is its bit count and
    `block_valid[b]` how many of its tuples are real (pads are a flat
    row-major suffix, the flush block carries no tuples at all).
    """

    codec_id: int
    lanes: int
    per_lane: int  # tuples per lane of a full block (0 if no full blocks)
    n_full: int
    tail_per_lane: int  # 0 = no tail block
    flush_slots: int  # per-lane slots of the flush mini-block (0 = none)
    n_valid: int  # real tuples across the whole frame
    block_bits: np.ndarray  # uint32[n_blocks]
    block_valid: np.ndarray  # uint32[n_blocks]
    bitlen: np.ndarray  # int32[n_symbols], stream order
    payload: np.ndarray  # uint32[payload_words]
    #: already-serialized 7-bit bitlen stream (uint32 words). Set when the
    #: metadata arrived wire-shaped (device compaction, or `from_bytes`);
    #: `to_bytes` then reuses it instead of re-packing `bitlen`. Must stay
    #: consistent with `bitlen` — both come from the same source.
    packed_meta: Optional[np.ndarray] = None
    #: rANS stage-2 blob (uint32 words, `core.entropy.encode_blob`). When
    #: set, serialization carries the blob INSTEAD of the raw metadata +
    #: payload sections and raises FEATURE_ENTROPY in the version word;
    #: the in-memory fields above always stay in raw form so decoders and
    #: the executor never see entropy-coded bytes.
    entropy: Optional[np.ndarray] = None
    #: trained-dictionary reference `(topic, version)`. When set, the frame
    #: raises FEATURE_DICT and carries a self-sizing dict-id section right
    #: after the block counts (outside the entropy blob); decode seeds the
    #: codec state from the registry's matching TrainedDict instead of the
    #: cold table. `None` keeps the frame byte-identical to frames without
    #: a dictionary.
    dict_id: Optional[Tuple[str, int]] = None
    #: integrity kind ("crc32c" or None). When set, the frame raises
    #: FEATURE_CRC and `to_bytes` appends a 5-word trailer of per-section
    #: CRC32C checksums (header, counts, dict-id, meta/blob, payload; an
    #: absent section checksums as 0); `from_bytes` verifies every section
    #: before trusting the body and re-stamps the field so reserialization
    #: round-trips. `None` keeps the frame byte-identical to integrity-off
    #: builds.
    integrity: Optional[str] = None

    # ------------------------------------------------------------ shapes --
    @property
    def n_blocks(self) -> int:
        return self.n_full + (1 if self.tail_per_lane else 0) + (1 if self.flush_slots else 0)

    def block_shapes(self):
        """(lanes, B) of every block, in stream order."""
        shapes = [(self.lanes, self.per_lane)] * self.n_full
        if self.tail_per_lane:
            shapes.append((self.lanes, self.tail_per_lane))
        if self.flush_slots:
            shapes.append((self.lanes, self.flush_slots))
        return shapes

    @property
    def n_symbols(self) -> int:
        return self.lanes * (
            self.n_full * self.per_lane + self.tail_per_lane + self.flush_slots
        )

    def block_words(self) -> np.ndarray:
        """Word count of each block's payload segment (int64[n_blocks])."""
        return (np.asarray(self.block_bits, np.int64) + 31) // 32

    @property
    def payload_bits(self) -> int:
        return int(np.asarray(self.block_bits, np.int64).sum())

    @property
    def wire_bytes(self) -> int:
        """Total serialized size (header + metadata + payload, or header +
        entropy blob), computed in O(1) — must equal len(self.to_bytes())."""
        dw = _dict_id_words(self.dict_id)
        cw = _CRC_TRAILER_WORDS if self.integrity is not None else 0
        if self.entropy is not None:
            return 4 * (_HDR_WORDS + 2 * self.n_blocks + dw + self.entropy.size + cw)
        meta_words = (7 * self.n_symbols + 31) // 32
        return 4 * (
            _HDR_WORDS + 2 * self.n_blocks + dw + meta_words + self.payload.size + cw
        )

    # ------------------------------------------------------- entropy stage --
    def apply_entropy(self, device: Union[None, str, torch.device] = None) -> "Frame":
        """Attach the rANS stage-2 blob, in place, coding on `device` (CUDA
        when None, or raise).

        Entropy-codes the 7-bit metadata stream and the compacted payload
        into `self.entropy`; the raw fields are kept untouched so the
        decode executor is oblivious to the stage. Idempotent."""
        if self.entropy is None:
            from repro_torch.core import entropy as _entropy

            dev = resolve_device(device)
            meta = self.packed_meta
            if meta is None:
                meta = _pack_bitlens(self.bitlen)
                self.packed_meta = meta
            self.entropy = _entropy.encode_blob(
                meta, np.ascontiguousarray(self.payload, np.uint32), dev
            )
        return self

    # ----------------------------------------------------------- serialize --
    def _section_bytes(self) -> Tuple[bytes, bytes, bytes, bytes, bytes]:
        """The five serialized sections (header, counts, dict, meta/blob,
        payload) as little-endian bytes; absent sections are empty."""
        dict_sec = (
            b"" if self.dict_id is None
            else _pack_dict_id(self.dict_id).astype("<u4").tobytes()
        )
        dict_bit = FEATURE_DICT if self.dict_id is not None else 0
        crc_bit = FEATURE_CRC if self.integrity is not None else 0
        counts_sec = (
            np.ascontiguousarray(self.block_bits, np.uint32).astype("<u4").tobytes()
            + np.ascontiguousarray(self.block_valid, np.uint32).astype("<u4").tobytes()
        )
        if self.entropy is not None:
            feature_bits = FEATURE_ENTROPY | dict_bit | crc_bit
            meta_size, payload_size = self.entropy.size, 0
            meta_sec = np.ascontiguousarray(self.entropy, np.uint32).astype("<u4").tobytes()
            payload_sec = b""
        else:
            meta = self.packed_meta
            if meta is None:
                meta = _pack_bitlens(self.bitlen)
            feature_bits = dict_bit | crc_bit
            meta_size, payload_size = meta.size, self.payload.size
            meta_sec = meta.astype("<u4").tobytes()
            payload_sec = np.ascontiguousarray(self.payload, np.uint32).astype("<u4").tobytes()
        header = np.array(
            [
                FRAME_MAGIC,
                FRAME_VERSION | feature_bits,
                self.codec_id,
                self.lanes,
                self.per_lane,
                self.n_full,
                self.tail_per_lane,
                self.flush_slots,
                self.n_valid,
                self.n_blocks,
                meta_size,
                payload_size,
            ],
            np.uint32,
        )
        return (header.astype("<u4").tobytes(), counts_sec, dict_sec, meta_sec, payload_sec)

    def to_bytes(self) -> bytes:
        if self.integrity is not None and self.integrity not in INTEGRITY_KINDS:
            raise ValueError(
                f"unknown frame integrity kind {self.integrity!r} "
                f"(known: {', '.join(INTEGRITY_KINDS)})"
            )
        secs = self._section_bytes()
        if self.integrity is None:
            return b"".join(secs)
        trailer = np.array([crc32c(s) for s in secs], np.uint32)
        return b"".join(secs) + trailer.astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, buf: bytes, device: Union[None, str, torch.device] = None) -> "Frame":
        """Parse one serialized frame. `device` is used only by entropy
        frames, whose blob is decoded there (CUDA when None, or raise)."""
        buf = bytes(buf)
        if len(buf) < 4 * _HDR_WORDS:
            raise FrameTruncatedError(
                f"frame truncated: {len(buf)} bytes is shorter than the "
                f"{4 * _HDR_WORDS}-byte header; wait for more data or resync"
            )
        if len(buf) % 4:
            raise FrameTruncatedError(
                f"frame truncated: {len(buf)} bytes is not uint32-word-aligned; "
                "the tail was cut mid-word — resync to the next header"
            )
        head = np.frombuffer(buf[: 4 * _HDR_WORDS], dtype="<u4")
        if int(head[0]) != FRAME_MAGIC:
            raise FrameHeaderError("not a CStream frame (bad magic)")
        version = int(head[1]) & 0xFFFF
        features = int(head[1]) & 0xFFFF0000
        if version != FRAME_VERSION:
            raise FrameHeaderError(f"unsupported frame version {version}")
        unknown = features & ~_KNOWN_FEATURES
        if unknown:
            raise FrameFeatureError(
                f"frame uses unknown feature bits 0x{unknown:08x} (this "
                f"build understands 0x{_KNOWN_FEATURES:08x}: entropy, dict, "
                "crc); decode with a newer build"
            )
        has_entropy = bool(features & FEATURE_ENTROPY)
        has_dict = bool(features & FEATURE_DICT)
        has_crc = bool(features & FEATURE_CRC)
        dev = resolve_device(device) if has_entropy else None
        nb, meta_words, payload_words = int(head[9]), int(head[10]), int(head[11])
        crc_words = _CRC_TRAILER_WORDS if has_crc else 0
        body = np.frombuffer(buf[4 * _HDR_WORDS :], dtype="<u4")
        if has_crc:
            # the header CRC is verified FIRST, from the fixed-size trailer
            # at the buffer's end, so a flipped header bit reports as
            # corruption instead of deriving nonsense section sizes below
            if body.size < crc_words:
                raise FrameTruncatedError(
                    "frame truncated: the integrity trailer is missing; "
                    "wait for more data or resync"
                )
            _check_crc("header", int(body[body.size - crc_words]), buf[: 4 * _HDR_WORDS])
        sec_words = body.size - crc_words
        # with FEATURE_ENTROPY, header word 10 is the blob size and word 11
        # must be zero: the raw sections are inside the blob
        if has_entropy and payload_words != 0:
            raise FrameHeaderError(
                "frame header inconsistent: entropy frames carry no raw "
                "payload section"
            )
        dict_id: Optional[Tuple[str, int]] = None
        dict_words = 0
        if has_dict:
            # the dict-id section self-sizes via its leading word, between
            # the block counts and the meta/blob sections
            if sec_words < 2 * nb + 3:
                raise FrameTruncatedError(
                    "frame length mismatch: body too short for the declared "
                    "dict-id section"
                )
            dict_words = int(body[2 * nb])
            tlen = int(body[2 * nb + 2])
            if dict_words < 3 or dict_words != 3 + (tlen + 3) // 4:
                raise FrameHeaderError("frame header inconsistent: dict-id section")
        if sec_words != 2 * nb + dict_words + meta_words + payload_words:
            raise FrameTruncatedError(
                f"frame length mismatch: body carries {sec_words} words, the "
                f"header declares {2 * nb + dict_words + meta_words + payload_words}; "
                "the frame was truncated or the stream lost sync"
            )
        if has_crc:
            # remaining sections, each against its stored trailer word, before
            # any of their content is trusted
            trailer = body[sec_words:]
            off = 4 * _HDR_WORDS
            for name, words, stored in zip(
                _CRC_SECTIONS[1:], [2 * nb, dict_words, meta_words, payload_words], trailer[1:]
            ):
                _check_crc(name, int(stored), buf[off : off + 4 * words])
                off += 4 * words
        if has_dict:
            try:
                dict_id = _unpack_dict_id(body[2 * nb : 2 * nb + dict_words])
            except UnicodeDecodeError as exc:
                raise FrameHeaderError(
                    "frame header inconsistent: dict-id topic is not valid "
                    "utf-8; the frame is corrupt — discard it and resync"
                ) from exc
        meta_at = 2 * nb + dict_words
        meta = body[meta_at : meta_at + meta_words].astype(np.uint32)
        frame = cls(
            codec_id=int(head[2]),
            lanes=int(head[3]),
            per_lane=int(head[4]),
            n_full=int(head[5]),
            tail_per_lane=int(head[6]),
            flush_slots=int(head[7]),
            n_valid=int(head[8]),
            block_bits=body[:nb].astype(np.uint32),
            block_valid=body[nb : 2 * nb].astype(np.uint32),
            bitlen=np.zeros(0, np.int32),
            payload=body[meta_at + meta_words : sec_words].astype(np.uint32),
            dict_id=dict_id,
            integrity="crc32c" if has_crc else None,
        )
        # header self-consistency: every derived size must match the declared
        # section lengths, so a tampered/corrupt header is rejected here (the
        # parser's FrameError contract) instead of escaping as an IndexError
        if frame.n_blocks != nb:
            raise FrameHeaderError(
                f"frame header inconsistent: {nb} blocks declared, shape "
                f"fields imply {frame.n_blocks}"
            )
        if has_entropy:
            from repro_torch.core import entropy as _entropy

            blob = meta  # word-10 section is the blob on this path
            try:
                meta, frame.payload = _entropy.decode_blob(
                    blob,
                    (7 * frame.n_symbols + 31) // 32,
                    int(frame.block_words().sum()),
                    dev,
                )
            except FrameError:
                raise
            except Exception as exc:
                msg = str(exc).replace("\n", " ")
                raise FrameDecodeError(
                    f"frame entropy blob undecodable ({type(exc).__name__}: "
                    f"{msg}); the frame is corrupt — discard it and resync"
                ) from exc
            frame.entropy = blob
        elif (7 * frame.n_symbols + 31) // 32 != meta_words:
            raise FrameHeaderError("frame header inconsistent: bitlen metadata size")
        elif int(frame.block_words().sum()) != payload_words:
            raise FrameHeaderError("frame header inconsistent: payload size")
        frame.bitlen = _unpack_bitlens(meta, frame.n_symbols)
        frame.packed_meta = meta  # reserialization reuses the parsed stream
        return frame

    # ------------------------------------------------- compacted fast path --
    @classmethod
    def from_compacted(
        cls,
        *,
        codec_id: int,
        lanes: int,
        per_lane: int,
        n_full: int,
        tail_per_lane: int,
        flush_slots: int,
        n_valid: int,
        block_bits: np.ndarray,
        block_valid: np.ndarray,
        payload: np.ndarray,
        bitlen: Optional[np.ndarray] = None,
        packed_meta: Optional[np.ndarray] = None,
        integrity: Optional[str] = None,
    ) -> "Frame":
        """Zero-copy framing for payloads that arrive already wire-shaped.

        The device-resident compaction path (DESIGN.md §13) hands over the
        exact concatenated payload words and (when geometry allows) the
        7-bit-packed bitlen stream; this constructor does header math and
        consistency checks ONLY — no per-block slicing or concatenation
        loop (that is `build_frame`, which survives as the oracle the
        equality tests compare against). Pass `packed_meta` to skip
        metadata re-packing at serialization; `bitlen` is then unpacked
        from it (one vectorized pass) for the decode side."""
        frame = cls(
            codec_id=codec_id,
            lanes=lanes,
            per_lane=per_lane,
            n_full=n_full,
            tail_per_lane=tail_per_lane,
            flush_slots=flush_slots,
            n_valid=n_valid,
            block_bits=np.ascontiguousarray(block_bits, np.uint32),
            block_valid=np.ascontiguousarray(block_valid, np.uint32),
            bitlen=np.zeros(0, np.int32),
            payload=np.ascontiguousarray(payload, np.uint32),
            packed_meta=(
                None if packed_meta is None
                else np.ascontiguousarray(packed_meta, np.uint32)
            ),
            integrity=integrity,
        )
        ns = frame.n_symbols
        if bitlen is None:
            if frame.packed_meta is None:
                raise ValueError("from_compacted needs bitlen or packed_meta")
            bitlen = _unpack_bitlens(frame.packed_meta, ns)
        frame.bitlen = np.ascontiguousarray(bitlen, np.int32).ravel()
        # consistency: the compacted parts must agree with the header math,
        # exactly as from_bytes validates a parsed frame
        if frame.block_bits.size != frame.n_blocks:
            raise ValueError(
                f"from_compacted: {frame.block_bits.size} block bit counts "
                f"for {frame.n_blocks} blocks"
            )
        if frame.block_valid.size != frame.n_blocks:
            raise ValueError(
                f"from_compacted: {frame.block_valid.size} block valid counts "
                f"for {frame.n_blocks} blocks"
            )
        if frame.bitlen.size != ns:
            raise ValueError(
                f"from_compacted: {frame.bitlen.size} bitlens for {ns} symbols"
            )
        if frame.packed_meta is not None and frame.packed_meta.size != (
            7 * ns + 31
        ) // 32:
            raise ValueError("from_compacted: packed_meta size mismatch")
        if int(frame.block_words().sum()) != frame.payload.size:
            raise ValueError(
                f"from_compacted: payload has {frame.payload.size} words, "
                f"block bit counts imply {int(frame.block_words().sum())}"
            )
        return frame


def parse_frame(buf: bytes, device: Union[None, str, torch.device] = None) -> Frame:
    """Parse one serialized frame; every failure raises a `FrameError`.

    The collector-side entry point: unlike calling `Frame.from_bytes`
    directly in older builds, no raw numpy/struct error (misaligned slice,
    short buffer, corrupt section) ever escapes — body-length mismatches
    and corruption all surface as single-line, typed, actionable errors.
    `device` decodes entropy frames (CUDA when None); a missing device is
    the entry points' RuntimeError, raised before parsing, not a frame
    error."""
    head = bytes(buf[:8])
    if (device is None and len(head) == 8
            and int.from_bytes(head[4:], "little") & FEATURE_ENTROPY):
        device = resolve_device(None)
    try:
        return Frame.from_bytes(buf, device)
    except FrameError:
        raise
    except Exception as exc:  # defensive: the parser's error contract
        msg = str(exc).replace("\n", " ")
        raise FrameError(
            f"frame unparseable ({type(exc).__name__}: {msg}); "
            "discard it and resync"
        ) from exc


_MAGIC_BYTES = FRAME_MAGIC.to_bytes(4, "little")
_MAX_SANE_FRAME_WORDS = 1 << 28  # 1 GiB: anything larger is stream garbage


class FrameStream:
    """Collector-side frame scanner with corruption resync (DESIGN.md §18).

    Feed raw bytes — possibly containing corrupt frames, truncated spans,
    or interleaved garbage — and `frames()` yields every parseable frame
    in order. On a bad frame the scanner records the typed error and hunts
    for the next FRAME_MAGIC occurrence, so one corrupt frame never kills
    the stream. Each `frames()` call rescans the full buffer from the
    start and resets `errors` / `resyncs` / `frames_ok`.
    """

    def __init__(self, buf: bytes = b"") -> None:
        self._buf = bytearray()
        self.errors: List[Tuple[int, FrameError]] = []  # (byte offset, error)
        self.resyncs = 0
        self.frames_ok = 0
        if buf:
            self.feed(buf)

    def feed(self, data: bytes) -> "FrameStream":
        self._buf += data
        return self

    def _declared_words(self, off: int) -> Optional[int]:
        """Total frame length (words) declared by a plausible header at
        `off`, or None when no sane frame can start there."""
        buf = self._buf
        if off + 4 * _HDR_WORDS > len(buf):
            return None
        if bytes(buf[off : off + 4]) != _MAGIC_BYTES:
            return None
        head = np.frombuffer(bytes(buf[off : off + 4 * _HDR_WORDS]), dtype="<u4")
        if int(head[1]) & 0xFFFF != FRAME_VERSION:
            return None
        features = int(head[1]) & 0xFFFF0000
        if features & ~_KNOWN_FEATURES:
            return None
        nb, meta_words, payload_words = int(head[9]), int(head[10]), int(head[11])
        total = _HDR_WORDS + 2 * nb + meta_words + payload_words
        if features & FEATURE_DICT:
            peek = off + 4 * (_HDR_WORDS + 2 * nb)
            if peek + 4 > len(buf):
                return None
            dict_words = int.from_bytes(buf[peek : peek + 4], "little")
            if not 3 <= dict_words <= 1 << 16:
                return None
            total += dict_words
        if features & FEATURE_CRC:
            total += _CRC_TRAILER_WORDS
        if total > _MAX_SANE_FRAME_WORDS:
            return None
        return total

    def frames(self) -> Iterator[Frame]:
        """Yield the parseable frames, skipping and recording corrupt spans."""
        self.errors = []
        self.resyncs = 0
        self.frames_ok = 0
        buf, n = self._buf, len(self._buf)
        off = 0
        while off + 4 * _HDR_WORDS <= n:
            words = self._declared_words(off)
            if words is not None and off + 4 * words <= n:
                try:
                    frame = parse_frame(bytes(buf[off : off + 4 * words]))
                    self.frames_ok += 1
                    yield frame
                    off += 4 * words
                    continue
                except FrameError as exc:
                    self.errors.append((off, exc))
            elif words is not None:
                self.errors.append((
                    off,
                    FrameTruncatedError(
                        f"frame at byte {off} declares {4 * words} bytes but "
                        f"only {n - off} remain; the tail was truncated"
                    ),
                ))
            elif bytes(buf[off : off + 4]) == _MAGIC_BYTES:
                self.errors.append((
                    off,
                    FrameHeaderError(
                        f"implausible frame header at byte {off}; scanning on"
                    ),
                ))
            # resync: hunt for the next magic occurrence past this offset
            nxt = buf.find(_MAGIC_BYTES, off + 1)
            if nxt < 0:
                break
            off = nxt
            self.resyncs += 1


def build_frame(
    codec_id: int,
    lanes: int,
    per_lane: int,
    n_full: int,
    tail_per_lane: int,
    flush_slots: int,
    n_valid: int,
    blocks,
) -> Frame:
    """Assemble a Frame from per-block `(words, nbits, bitlen)` triples.

    `words` may be the executor's fixed worst-case buffer; only the used
    prefix (ceil(nbits/32) words) enters the payload, so the wire carries
    no worst-case padding. Output arrays are pre-sized from the vectorized
    count math and filled in place (no list-append + concatenate pass)."""
    blocks = list(blocks)
    block_bits = np.fromiter(
        (int(b[1]) for b in blocks), np.uint32, count=len(blocks)
    )
    block_valid = np.fromiter(
        (int(b[3]) for b in blocks), np.uint32, count=len(blocks)
    )
    used = (block_bits.astype(np.int64) + 31) // 32
    word_off = np.concatenate([[0], np.cumsum(used)])
    sym_counts = np.fromiter(
        (np.asarray(b[2]).size for b in blocks), np.int64, count=len(blocks)
    )
    sym_off = np.concatenate([[0], np.cumsum(sym_counts)])
    payload = np.zeros(int(word_off[-1]), np.uint32)
    bitlen = np.zeros(int(sym_off[-1]), np.int32)
    for b, (words, _, bl, _) in enumerate(blocks):
        payload[word_off[b] : word_off[b + 1]] = np.asarray(
            words[: used[b]], np.uint32
        )
        bitlen[sym_off[b] : sym_off[b + 1]] = np.asarray(bl, np.int32).ravel()
    return Frame(
        codec_id=codec_id,
        lanes=lanes,
        per_lane=per_lane,
        n_full=n_full,
        tail_per_lane=tail_per_lane,
        flush_slots=flush_slots,
        n_valid=n_valid,
        block_bits=block_bits,
        block_valid=block_valid,
        bitlen=bitlen,
        payload=payload,
    )
