"""B2: block-local bitstream unpacking on the card (port of
`repro/kernels/bitunpack.py`; CUDA source `csrc/bitunpack.cu`).

One CTA of 256 threads unpacks one block. Each thread loads the lengths of
8 consecutive symbols of a round of 2,048 with one speculative 16-byte
quad of the row; a scan of the lengths in registers and one block scan
give the offsets, which go to shared memory with the row's live words
only (the words a window can read); then each thread extracts pairs of
symbols spread over the threads, so a warp's 16-byte stores of two codes
are contiguous. Blocks of more than 2,048 symbols take rounds with a
running carry. A row whose copy does not fit shared memory (~58,000 words)
takes the kernel's unstaged instance, whose windows read the row in device
memory.

`launch` runs the kernel on validated CUDA tensors; `ops.unpack_blocks` is
the public wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

def launch(words: torch.Tensor, bitlen: torch.Tensor, codes: torch.Tensor) -> None:
    """words int32[nb, W], bitlen int32[nb*S] -> codes int32[nb*S, 2]."""
    nb, in_words = words.shape
    lib = build.library()
    err = lib.repro_unpack_blocks(
        words.data_ptr(), nb, in_words, bitlen.data_ptr(), bitlen.shape[0] // max(nb, 1),
        codes.data_ptr(), torch.cuda.current_stream(words.device).cuda_stream,
    )
    build.check(err, "unpack_blocks")
