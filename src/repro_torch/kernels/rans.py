"""B8 and B9: the interleaved rANS entropy stage on the card (port of
`repro/kernels/rans.py`; CUDA sources `csrc/rans.cu`, `csrc/rans_section.cu`).

  * `launch_encode` — every chunk's (T, 8) byte grid encoded in one launch,
    one thread per (chunk, lane), rows walked in reverse (the Pallas
    contract's int32 grids and per-step flags and values).
  * `launch_section_encode` — B8's section form, what the entropy stage
    runs: a section's bytes to lane states, lane counts and the packed u16
    stream, in two launches around a `torch.cumsum` of the counts.
  * `launch_decode` — the forward decode, each lane from its absolute
    offset into the shared u16 stream (the Pallas contract's int32 grids).
  * `launch_section_decode` — B9's section form, what the entropy stage
    runs: a section's packed stream words, lane states and lane counts to
    its bytes, in one launch after a `torch.cumsum` of the counts.

The coder's constants, its two tables (`cum_freqs`, `slot_table`), the
section's chunk grid (`chunk_grid`), the decoder's stream length
(`decode_cap`) and the stream assembly from per-step emissions
(`assemble_stream`, `lane_offsets`) live here, below the wrappers
(`kernels/ops.py`), the plain versions (`kernels/ref.py`) and the section
coder (`core/entropy.py`). The public wrappers are `ops.rans_encode`,
`ops.rans_section_encode`, `ops.rans_decode` and `ops.rans_section_decode`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS  # 4096: fixed table denominator
RANS_L = 1 << 16  # lower bound of the state interval (16-bit renorm)
N_LANES = 8  # interleaved coders per chunk
CHUNK_BYTES = 4096  # bytes per independently-decodable chunk
ROWS = CHUNK_BYTES // N_LANES  # scan steps per chunk


def cum_freqs(freqs: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative frequencies (int64[256])."""
    f = freqs.to(torch.int64)
    return torch.cumsum(f, 0) - f


def slot_table(freqs: torch.Tensor) -> torch.Tensor:
    """slot -> symbol lookup (int64[PROB_SCALE]) from the frequency table:
    the last symbol whose cumulative start is <= the slot."""
    slots = torch.arange(PROB_SCALE, dtype=torch.int64, device=freqs.device)
    return torch.searchsorted(cum_freqs(freqs), slots, right=True) - 1


def chunk_grid(data: torch.Tensor):
    """A section's bytes (uint8[n], n > 0) as the coder's chunk grid: (syms
    int32[C, ROWS, N_LANES], zero past byte n; mask bool[C, ROWS, N_LANES],
    true on the n real bytes), C = ceil(n / CHUNK_BYTES). The reference pads
    to a power-of-two chunk count; the padding chunks are fully masked,
    emit nothing and are dropped."""
    n = data.numel()
    nchunks = -(-n // CHUNK_BYTES)
    flat = torch.zeros(nchunks * CHUNK_BYTES, dtype=torch.int32, device=data.device)
    flat[:n] = data.to(torch.int32)
    mask = (torch.arange(flat.numel(), device=data.device) < n).reshape(nchunks, ROWS, N_LANES)
    return flat.reshape(nchunks, ROWS, N_LANES), mask


def lane_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Each (chunk, lane) stream's absolute start in the u16 stream, the
    exclusive cumsum of the lane counts in (chunk, lane) order: int32[C, N]."""
    cflat = counts.reshape(-1).to(torch.int64)
    return (torch.cumsum(cflat, 0) - cflat).reshape(counts.shape).to(torch.int32)


def assemble_stream(flags: torch.Tensor, vals: torch.Tensor):
    """The u16 stream from B8's per-step outputs (C, T, N): every emission
    scattered at its lane's offset plus its rank within the lane. Returns
    (stream int32[total], counts int32[C, N] u16s per lane stream)."""
    counts = flags.sum(dim=1, dtype=torch.int32)
    off = lane_offsets(counts).to(torch.int64).unsqueeze(1)
    rank = torch.cumsum(flags, dim=1).to(torch.int64) - flags
    spill = flags.numel()  # one slot past any emission, for non-emitters
    pos = torch.where(flags > 0, off + rank, spill)
    stream = torch.zeros(spill + 1, dtype=torch.int32, device=flags.device)
    stream.scatter_(0, pos.reshape(-1), vals.reshape(-1))
    return stream[: int(counts.sum())], counts


def packed_words(stream: torch.Tensor) -> torch.Tensor:
    """u16 values (int32[E]) packed two to a word, low half first, the odd
    pad half zero: int32[ceil(E/2)], the section's stream words."""
    u = torch.zeros(2 * ((stream.numel() + 1) // 2), dtype=torch.int64, device=stream.device)
    u[: stream.numel()] = stream.to(torch.int64) & 0xFFFF
    return (u[0::2] | (u[1::2] << 16)).to(torch.int32)


def decode_cap(nchunks: int) -> int:
    """The reference decoder's stream length, `next_pow2(C) * CHUNK_BYTES`
    u16 entries; reads clip to its last entry."""
    return (1 << max(nchunks - 1, 0).bit_length()) * CHUNK_BYTES


def section_words(n: int) -> int:
    """Words of the section form's stream buffer for n bytes: room for one
    u16 per byte, the most a section can emit, and the odd pad half."""
    return n // 2 + 1


def launch_encode(syms: torch.Tensor, mask: torch.Tensor, freqs: torch.Tensor,
                  cums: torch.Tensor, states: torch.Tensor, flags: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """syms int32[C, T, 8], mask uint8[C, T, 8], freqs/cums int32[256] ->
    states int32[C, 8], flags/vals int32[C, T, 8]."""
    chunks, t_rows, _ = syms.shape
    lib = build.library()
    err = lib.repro_rans_encode(
        syms.data_ptr(), mask.data_ptr(), freqs.data_ptr(), cums.data_ptr(), chunks, t_rows,
        states.data_ptr(), flags.data_ptr(), vals.data_ptr(),
        torch.cuda.current_stream(syms.device).cuda_stream,
    )
    build.check(err, "rans_encode")


def launch_section_encode(data: torch.Tensor, freqs: torch.Tensor, states: torch.Tensor,
                          counts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """data uint8[n], freqs int32[256] -> states/counts int32[C, 8], words
    int32[section_words(n)] (the packed stream in its first ceil(E/2)
    words); returns E as an int64 0-d tensor on the device. The walk writes
    each lane's emissions into a (C*8, 512) u16 scratch; `torch.cumsum`
    gives the lanes' ends; the copy moves each lane's run to its offset."""
    n = data.numel()
    lib = build.library()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    scratch = torch.empty((counts.numel(), ROWS), dtype=torch.int16, device=data.device)
    counts64 = torch.empty((counts.numel(),), dtype=torch.int64, device=data.device)
    err = lib.repro_rans_section_walk(
        data.data_ptr(), n, freqs.data_ptr(), states.data_ptr(), counts.data_ptr(),
        counts64.data_ptr(), scratch.data_ptr(), stream,
    )
    build.check(err, "rans_section_walk")
    ends = torch.cumsum(counts64, 0)
    err = lib.repro_rans_section_copy(
        scratch.data_ptr(), counts.data_ptr(), ends.data_ptr(), counts.numel(), words.data_ptr(),
        stream,
    )
    build.check(err, "rans_section_copy")
    return ends[-1]


def launch_decode(stream: torch.Tensor, cap: int, freqs: torch.Tensor, cums: torch.Tensor,
                  lut: torch.Tensor, states: torch.Tensor, offsets: torch.Tensor,
                  mask: torch.Tensor, syms: torch.Tensor) -> None:
    """stream int32[S] (u16 values; zero past S up to `cap`), freqs/cums
    int32[256], lut int32[4096], states/offsets int32[C, 8], mask uint8
    [C, T, 8] -> syms int32[C, T, 8]."""
    chunks, t_rows, _ = mask.shape
    lib = build.library()
    err = lib.repro_rans_decode(
        stream.data_ptr(), stream.numel(), cap, freqs.data_ptr(), cums.data_ptr(),
        lut.data_ptr(), states.data_ptr(), offsets.data_ptr(), mask.data_ptr(), chunks,
        t_rows, syms.data_ptr(), torch.cuda.current_stream(mask.device).cuda_stream,
    )
    build.check(err, "rans_decode")


def launch_section_decode(words: torch.Tensor, total: int, freqs: torch.Tensor,
                          states: torch.Tensor, counts: torch.Tensor, out: torch.Tensor) -> None:
    """words int32[ceil(total/2)] (the packed stream), freqs int32[256],
    states/counts int32[C, 8] -> out uint8[n], C = ceil(n / 4096); reads as
    over the stream zero-padded to `decode_cap(C)` entries. `torch.cumsum`
    gives the lanes' ends in int32, as the reference's decoder takes them,
    and the kernel each lane's offset from its end."""
    lib = build.library()
    ends = torch.cumsum(counts.reshape(-1), 0, dtype=torch.int32)
    err = lib.repro_rans_section_decode(
        words.data_ptr(), total, decode_cap(states.shape[0]), freqs.data_ptr(), states.data_ptr(),
        counts.data_ptr(), ends.data_ptr(), out.numel(), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    build.check(err, "rans_section_decode")
