"""B1: block-local bitstream packing on the card (port of
`repro/kernels/bitpack.py`; CUDA source `csrc/bitpack.cu`).

One CTA of 256 threads packs one block. Each thread owns 8 consecutive
symbols of a round of 2,048 and issues all its loads at once (16-byte
loads where the block size is a multiple of 4 and the tensors are
aligned, else scalar ones); a scan of its lengths in registers and one
block scan of the thread totals give every symbol its bit offset; each
symbol ORs its words into a shared-memory copy of the row (shared
atomicOr: the fields are disjoint), which goes out with 16-byte stores,
the zero tail straight from registers. Blocks of more than 2,048 symbols
take rounds with a running carry. A row whose copy does not fit shared
memory (~58,000 words) takes the kernel's unstaged instance, which ORs into
the zeroed row in device memory.

With `meta` the same launch also packs the block's bit lengths at 7 bits
each (B4's work, for blocks of a multiple of 32 symbols): each group of 4
threads turns its 32 loaded lengths into 7 metadata words by one shuffle.

`launch` runs the kernel on validated CUDA tensors; `ops.pack_blocks` and
`ops.pack_blocks_meta7` are the public wrappers (checks, allocation, the
CPU plain version, the launch count). The reference's default kernel block
is kept.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

DEFAULT_BLOCK = 256


def words_per_block(block: int) -> int:
    return 2 * block + 1  # worst case: 64 bits/symbol + spill word


def launch(codes: torch.Tensor, bitlen: torch.Tensor, words: torch.Tensor,
           nbits: torch.Tensor, block: int, meta: Optional[torch.Tensor] = None) -> None:
    """codes int32[N, 2], bitlen int32[N] -> words int32[N/block, OW],
    nbits int32[N/block] (all contiguous, on one CUDA device); with `meta`
    (int32[N/block, 7*block/32], block % 32 == 0) also the 7-bit lengths."""
    lib = build.library()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    args = (codes.data_ptr(), bitlen.data_ptr(), words.shape[0], block, words.shape[1],
            words.data_ptr(), nbits.data_ptr())
    if meta is None:
        build.check(lib.repro_pack_blocks(*args, stream), "pack_blocks")
    else:
        build.check(lib.repro_pack_blocks_meta7(*args, meta.data_ptr(), stream), "pack_blocks_meta7")
