"""B3 and B4: device-resident frame compaction on the card (port of
`repro/kernels/frame_compact.py`; CUDA source `csrc/frame_compact.cu`).

  * `launch_compact` — every block's live ceil(nbits/32)-word prefix at its
    exclusive-prefix-sum offset in one payload, zeros past `total`.
  * `launch_meta7` — per-block bit lengths at 7 bits per symbol.

`ops.compact_blocks` and `ops.pack_meta7_blocks` are the public wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def launch_compact(words: torch.Tensor, nbits: torch.Tensor, payload: torch.Tensor,
                   total: torch.Tensor) -> None:
    """words int32[n, OW], nbits int32[n] -> payload int32[n*OW], total int32[1]."""
    n, ow = words.shape
    lib = build.library()
    err = lib.repro_compact_blocks(
        words.data_ptr(), nbits.data_ptr(), n, ow, payload.data_ptr(), total.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    build.check(err, "compact_blocks")


def launch_meta7(bitlen: torch.Tensor, out: torch.Tensor) -> None:
    """bitlen int32[n, S] -> out int32[n, ceil(7S/32)]."""
    n, symbols = bitlen.shape
    lib = build.library()
    err = lib.repro_pack_meta7_blocks(
        bitlen.data_ptr(), n, symbols, out.shape[1], out.data_ptr(),
        torch.cuda.current_stream(bitlen.device).cuda_stream,
    )
    build.check(err, "pack_meta7_blocks")
