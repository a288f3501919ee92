"""B8 and B9: the interleaved rANS entropy stage on the card (port of
`repro/kernels/rans.py`; CUDA source `csrc/rans.cu`).

  * `launch_encode` — every chunk's (T, 8) byte grid encoded in one launch,
    one thread per (chunk, lane), rows walked in reverse.
  * `launch_decode` — the forward decode, each lane from its absolute
    offset into the shared u16 stream.

The coder's constants and its two tables (`cum_freqs`, `slot_table`) live
here, below both the wrappers (`kernels/ops.py`), the plain versions
(`kernels/ref.py`) and the section coder (`core/entropy.py`). The public
wrappers are `ops.rans_encode` and `ops.rans_decode`; they compute the
tables as the Pallas wrappers do, and the kernels read them into shared
memory.
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
