"""Optional second compression stage: interleaved rANS over frame bytes
(port of `repro/core/entropy.py`).

The wire layout and the arithmetic are the reference's, byte for byte:

  * a section's bytes split into CHUNK_BYTES chunks, each coded by N_LANES
    interleaved rANS coders (lane j owns bytes j, j+N, j+2N, ... of its
    chunk), rows walked in reverse on encode so decode runs forward;
  * one frequency table per section, quantized to 2^PROB_BITS from a byte
    histogram (`quantize_freqs`, integer-exact);
  * every (chunk, lane) stream's u16 count travels with the section, so
    the decoder derives each lane's absolute start offset with one
    exclusive cumsum and all lanes decode in parallel;
  * a raw fallback (`[0]` + the raw words) when coding would not shrink
    the section.

The device half runs on torch tensors: the encode is B8's section form
(`kernels/ops.py` `rans_section_encode`: the section's bytes in, lane
states, lane counts and the packed u16 stream out; on CUDA two launches
for the whole section), the decode B9's section form
(`rans_section_decode`: the packed stream words as they sit in the frame,
lane states and lane counts in, the section's bytes out; on CUDA one
launch after a `torch.cumsum`); on the CPU their plain versions in
`kernels/ref.py`, batched over chunks as the reference's `vmap` of
`encode_rows`/`decode_rows` is. The coder's constants, tables, chunk grid
and stream assembly come from `kernels/rans.py`. The host half (u16
packing of the table and counts, section and blob layout, validation) is
numpy.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.kernels import ops
from repro_torch.kernels.rans import (  # noqa: F401  (the coder's constants, re-exported)
    CHUNK_BYTES,
    N_LANES,
    PROB_BITS,
    PROB_SCALE,
    RANS_L,
    ROWS,
    assemble_stream,
    chunk_grid,
    cum_freqs,
    decode_cap,
    lane_offsets,
    slot_table,
)

ENTROPY_KIND_RANS = 1  # blob kind word

DeviceLike = Union[str, torch.device]


# ------------------------------------------------------------------ tables --
def quantize_freqs(hist: torch.Tensor) -> torch.Tensor:
    """Quantize a 256-bin byte histogram to frequencies summing to 2^12
    (int64[256]).

    Every present symbol gets frequency >= 1 and the sum is exactly
    PROB_SCALE. Integer-exact: counts are first downscaled below 2^17, and
    the remainder goes to the first most probable symbol (`argmax` breaks
    ties toward the lowest index, as `jnp.argmax` does)."""
    hist = hist.to(torch.int64)
    total = hist.sum()
    down = (bits.bit_length(total).to(torch.int64) - 17).clamp(min=0)
    scaled = torch.where(hist > 0, (hist >> down).clamp(min=1), torch.zeros_like(hist))
    t2 = scaled.sum().clamp(min=1)
    budget = PROB_SCALE - (hist > 0).sum()
    q = (scaled * budget) // t2 + (scaled > 0).to(torch.int64)
    return q.index_add(0, torch.argmax(q).reshape(1), (PROB_SCALE - q.sum()).reshape(1))


def _histogram(data: torch.Tensor) -> torch.Tensor:
    """Byte histogram (int64[256]) of the real bytes (uint8); integer
    bincount, exact on every device."""
    return torch.bincount(data, minlength=256)


# ----------------------------------------------------- section (de)coders --
def section_grid(data: np.ndarray, device: torch.device):
    """A section's bytes (uint8[n], n > 0) as the contract kernel's chunk
    grid on `device`: (syms int32[C, ROWS, N_LANES], zero past byte n; mask
    bool[C, ROWS, N_LANES], true on the n real bytes; freqs int32[256],
    one quantized table over all bytes), C = ceil(n / 4096)."""
    dev_bytes = torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(device)
    syms, mask = chunk_grid(dev_bytes)
    return syms, mask, quantize_freqs(_histogram(dev_bytes)).to(torch.int32)


def _encode_device(data: np.ndarray, device: torch.device):
    """Encode a section's bytes (uint8[n], n > 0) on `device`: one table
    over all bytes, then B8's section form for all chunks. Returns (freqs,
    lane states, lane counts, the packed u16 stream words, its u16 count)."""
    dev_bytes = torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(device)
    freqs = quantize_freqs(_histogram(dev_bytes)).to(torch.int32)
    states, counts, words, total = ops.rans_section_encode(dev_bytes, freqs)
    e = int(total)
    return (
        bits.u32_numpy(freqs),
        bits.u32_numpy(states).reshape(-1),
        counts.cpu().numpy().astype(np.uint32).reshape(-1),
        bits.u32_numpy(words[: (e + 1) // 2]),
        e,
    )


def _decode_device(stream_words: np.ndarray, total: int, freqs: np.ndarray, states: np.ndarray,
                   counts: np.ndarray, n: int, device: torch.device) -> np.ndarray:
    """Decode `n` bytes of a section on `device` with B9's section form:
    the packed stream words uploaded as they are, the table, lane states
    and lane counts in one more upload; every (chunk, lane) starts at its
    exclusive-cumsum offset; reads clip to the reference's cap of
    `next_pow2(nchunks) * CHUNK_BYTES` entries."""
    nchunks = states.shape[0]
    small = torch.from_numpy(np.concatenate([
        freqs.astype(np.int32), np.ascontiguousarray(states, np.uint32).view(np.int32).reshape(-1),
        counts.astype(np.int32).reshape(-1)])).to(device)
    tab, st, cnt = small.split([256, 8 * nchunks, 8 * nchunks])
    data = ops.rans_section_decode(
        bits.u32_tensor(stream_words, device), total, tab,
        st.view(nchunks, N_LANES), cnt.view(nchunks, N_LANES), n,
    )
    return data.cpu().numpy()


def _words_to_bytes(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(words, np.uint32).astype("<u4").view(np.uint8)


def _bytes_to_words(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b, np.uint8).view("<u4").astype(np.uint32)


def _pack_u16(vals: np.ndarray) -> np.ndarray:
    """Pack u16 values (held in uint32) two per word, little halves first."""
    v = np.ascontiguousarray(vals, np.uint32)
    if v.size % 2:
        v = np.concatenate([v, np.zeros(1, np.uint32)])
    return (v[0::2] | (v[1::2] << np.uint32(16))).astype(np.uint32)


def _unpack_u16(words: np.ndarray, n: int) -> np.ndarray:
    w = np.ascontiguousarray(words, np.uint32)
    out = np.empty(2 * w.size, np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out[:n]


def encode_section(raw_words: np.ndarray, device: DeviceLike) -> np.ndarray:
    """Serialize one frame section (uint32 words) with the rANS stage.

    Returns the self-describing section words: `[1, n_u16, n_chunks]` +
    128-word table (256 x 16-bit freqs) + per-chunk lane states + packed
    per-chunk lane counts + packed u16 stream — or `[0]` + the raw words
    verbatim when encoding would not shrink the section."""
    raw_words = np.ascontiguousarray(raw_words, np.uint32)
    raw = np.concatenate([np.zeros(1, np.uint32), raw_words])
    n = 4 * raw_words.size
    if n == 0:
        return raw
    freqs, states, counts, stream_words, n_u16 = _encode_device(
        _words_to_bytes(raw_words), torch.device(device)
    )
    enc = np.concatenate(
        [
            np.array([ENTROPY_KIND_RANS, n_u16, -(-n // CHUNK_BYTES)], np.uint32),
            _pack_u16(freqs),
            states,
            _pack_u16(counts),
            stream_words,
        ]
    )
    return enc if enc.size < raw.size else raw


def decode_section(section: np.ndarray, raw_word_count: int,
                   device: DeviceLike) -> Tuple[np.ndarray, int]:
    """Inverse of `encode_section`. `raw_word_count` is the section's raw
    size, recomputed by the caller from the frame header (it never travels
    in the blob). Returns `(raw_words, section_words_consumed)`."""
    section = np.ascontiguousarray(section, np.uint32)
    if section.size < 1:
        raise ValueError("frame entropy section truncated (missing flag word)")
    flag = int(section[0])
    if flag == 0:
        if section.size < 1 + raw_word_count:
            raise ValueError("frame entropy section truncated (raw fallback)")
        return section[1 : 1 + raw_word_count].copy(), 1 + raw_word_count
    if flag != ENTROPY_KIND_RANS:
        raise ValueError(f"frame entropy section has unknown coder kind {flag}")
    if section.size < 3:
        raise ValueError("frame entropy section truncated (missing counts)")
    total, nchunks = int(section[1]), int(section[2])
    expect = -(-(4 * raw_word_count) // CHUNK_BYTES)
    if nchunks != expect:
        raise ValueError(
            f"frame entropy section inconsistent: {nchunks} chunks for "
            f"{raw_word_count} raw words (expected {expect})"
        )
    stream_words = -(-total // 2)
    p = 3
    end = p + 128 + 8 * nchunks + 4 * nchunks + stream_words
    if section.size < end:
        raise ValueError("frame entropy section truncated (stream)")
    freqs = _unpack_u16(section[p : p + 128], 256).astype(np.int32)
    p += 128
    if int(freqs.sum()) != PROB_SCALE:
        raise ValueError(
            "frame entropy section invalid: frequency table does not sum "
            f"to {PROB_SCALE}"
        )
    states = section[p : p + 8 * nchunks].reshape(nchunks, N_LANES)
    p += 8 * nchunks
    counts = _unpack_u16(section[p : p + 4 * nchunks], 8 * nchunks).reshape(
        nchunks, N_LANES
    )
    p += 4 * nchunks
    stream = section[p : p + stream_words]
    p += stream_words
    if int(counts.sum()) != total:
        raise ValueError(
            "frame entropy section inconsistent: lane counts vs stream size"
        )
    if nchunks == 0:
        return np.zeros(0, np.uint32), p
    data = _decode_device(stream, total, freqs, states, counts, 4 * raw_word_count,
                          torch.device(device))
    return _bytes_to_words(data), p


# ------------------------------------------------------------- frame blob --
def encode_blob(packed_meta: np.ndarray, payload: np.ndarray, device: DeviceLike) -> np.ndarray:
    """Entropy-code a frame's two sections into one self-describing blob:
    `[kind, n_lanes]` + encoded metadata section + encoded payload
    section. Section raw sizes are NOT stored — the decoder recomputes
    them from the frame header."""
    return np.concatenate(
        [
            np.array([ENTROPY_KIND_RANS, N_LANES], np.uint32),
            encode_section(packed_meta, device),
            encode_section(payload, device),
        ]
    )


def decode_blob(blob: np.ndarray, meta_words: int, payload_words: int,
                device: DeviceLike) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of `encode_blob`: returns `(packed_meta, payload)`."""
    blob = np.ascontiguousarray(blob, np.uint32)
    if blob.size < 2:
        raise ValueError("frame entropy blob truncated (missing kind header)")
    if int(blob[0]) != ENTROPY_KIND_RANS or int(blob[1]) != N_LANES:
        raise ValueError(
            f"frame entropy blob has unsupported coder kind {int(blob[0])} "
            f"/ {int(blob[1])} lanes (this build: kind {ENTROPY_KIND_RANS}, "
            f"{N_LANES} lanes)"
        )
    meta, used = decode_section(blob[2:], meta_words, device)
    payload, used2 = decode_section(blob[2 + used :], payload_words, device)
    if 2 + used + used2 != blob.size:
        raise ValueError(
            f"frame entropy blob length mismatch: {blob.size} words, "
            f"sections consumed {2 + used + used2}"
        )
    return meta, payload
