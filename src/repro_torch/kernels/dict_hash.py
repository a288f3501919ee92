"""B5: the Tdic32 dictionary probe on the card (port of
`repro/kernels/dict_hash.py`; CUDA source `csrc/dict_probe.cu`).

`launch` runs the kernel on validated CUDA tensors; `ops.dict_probe` is the
public wrapper. `hash_host` is the host twin of the kernel's slot hash;
`hash_tensor` and `symbols` are its hash and symbol format on tensors,
shared by the plain version (`ref.probe_ref`) and the codec.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.kernels import build

KNUTH = 2654435761  # Knuth multiplicative hash constant


def hash_host(values: np.ndarray, idx_bits: int = 12) -> np.ndarray:
    """Host-side twin of the kernel's slot hash (training / table fills):
    `(v * KNUTH) >> (32 - idx_bits)` in uint32, as int64 slot indices."""
    v = np.asarray(values, dtype=np.uint32)
    return ((v * np.uint32(KNUTH)) >> np.uint32(32 - idx_bits)).astype(np.int64)


def launch(x: torch.Tensor, table: torch.Tensor, valid: torch.Tensor, idx_bits: int,
           c0: torch.Tensor, c1: torch.Tensor, bitlen: torch.Tensor) -> None:
    """x int32[L, N], table int32[L, 2^idx_bits], valid uint8[L, 2^idx_bits]
    -> c0, c1, bitlen int32[L, N] (all contiguous, on one CUDA device)."""
    lanes, n = x.shape
    lib = build.library()
    err = lib.repro_dict_probe(
        x.data_ptr(), table.data_ptr(), valid.data_ptr(), lanes, n, idx_bits,
        c0.data_ptr(), c1.data_ptr(), bitlen.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "dict_probe")


def hash_tensor(x: torch.Tensor, idx_bits: int) -> torch.Tensor:
    """The slot hash on tensors: uint32 words (int32 bits) -> int64 slots
    in [0, 2^idx_bits). The 64-bit product of two uint32 would overflow
    int64, so KNUTH is split in 16-bit halves and the product is exact."""
    xu = bits._u(x)
    prod = xu * (KNUTH & 0xFFFF) + (((xu * (KNUTH >> 16)) & 0xFFFF) << 16)
    return (prod & bits.M32) >> (32 - idx_bits)


def symbols(hit: torch.Tensor, h: torch.Tensor, x: torch.Tensor, idx_bits: int):
    """Tdic32 symbol slots (c0, c1, bitlen), int32: a hit is the flag bit
    and the slot index, `1 | h << 1` in 1+idx_bits bits; a miss is the
    33-bit literal `x << 1`."""
    xu = bits._u(x)
    c0 = torch.where(hit, 1 | (h << 1), (xu << 1) & bits.M32)
    c1 = torch.where(hit, torch.zeros_like(xu), xu >> 31)
    blen = torch.where(hit, torch.full_like(xu, 1 + idx_bits), torch.full_like(xu, 33))
    return bits._i32(c0), bits._i32(c1), blen.to(torch.int32)
