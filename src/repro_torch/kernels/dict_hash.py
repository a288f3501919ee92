"""B5: the Tdic32 dictionary probe on the card (port of
`repro/kernels/dict_hash.py`), in two forms:
  * the Pallas contract, one probe of a block against a frozen table
    (`launch`, CUDA source `csrc/dict_probe.cu`, wrapper `ops.dict_probe`);
  * the codec form (`csrc/dict_chunk.cu`): a whole chunk of frozen-mode,
    private-state blocks walked on the card, each block probed against the
    table its predecessors left and then merged into it, encode and decode
    (`launch_chunk_encode`, `launch_chunk_decode`, wrappers
    `ops.dict_chunk_encode`, `ops.dict_chunk_decode`). `chunk_kernel_for`
    is the rule the codec routes by.

`hash_host` is the host twin of the kernels' slot hash; `hash_tensor`,
`symbols`, `unsymbol` and `merge_updates` are the hash, the symbol format
and the last-writer-wins merge on tensors, shared by the plain versions
(`ref.probe_ref`, `ref.dict_chunk_encode_ref`, `ref.dict_chunk_decode_ref`)
and the codec's per-block walk.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.kernels import build

KNUTH = 2654435761  # Knuth multiplicative hash constant
#: blocks in flight in the codec-form kernels' shared ring (dict_chunk.cu kStages)
CHUNK_STAGES = 4
#: shared memory one CTA may hold on an H100 (227 KB)
MAX_SMEM_BYTES = 232448


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


def unsymbol(codes: torch.Tensor, idx_bits: int):
    """(hit, table index int64, literal int64 in [0, 2^32)) of symbol slots
    int32[..., 2]."""
    c0, c1 = bits._u(codes[..., 0]), bits._u(codes[..., 1])
    hit = (c0 & 1) == 1
    idx = (c0 >> 1) & ((1 << idx_bits) - 1)
    literal = ((c0 >> 1) | (c1 << 31)) & bits.M32
    return hit, idx, literal


def merge_updates(state: Dict[str, torch.Tensor], h: torch.Tensor, x: torch.Tensor,
                  idx_bits: int) -> Dict[str, torch.Tensor]:
    """Deterministic last-writer-wins merge of one block's updates into a
    Tdic32 state (table int32, valid bool, ts int32 [L, 2^idx_bits], clock
    int32[L]): x int32[L, B] at slots h int64[L, B].

    Each slot's winner is the last position that hashed to it
    (`scatter_reduce` amax, init -1: exact on every device). The writes
    then gather from the winners, one per slot, so no scatter ever sees
    duplicate indices."""
    lanes, b = x.shape
    pos = torch.arange(b, device=x.device).expand(lanes, b)
    winner = torch.full((lanes, 1 << idx_bits), -1, dtype=torch.int64, device=x.device)
    winner.scatter_reduce_(1, h, pos, reduce="amax", include_self=True)
    won = winner >= 0
    at = winner.clamp(min=0)
    return {
        "table": torch.where(won, x.gather(1, at), state["table"]),
        "valid": state["valid"] | won,
        "ts": torch.where(won, (state["clock"][:, None] + at).to(torch.int32), state["ts"]),
        "clock": state["clock"] + b,
    }


def chunk_smem_bytes(idx_bits: int, b: int, decode: bool) -> int:
    """Shared memory of one CTA of the codec-form kernels: the lane's table,
    timestamps and winners (4 bytes a slot each) and valid mask (1), the
    ring of CHUNK_STAGES blocks of input (4 bytes a tuple to encode, 8 to
    decode) and, to decode, the block's values (dict_chunk.cu smem_bytes)."""
    per_tuple = CHUNK_STAGES * 8 + 4 if decode else CHUNK_STAGES * 4
    return 13 * (1 << idx_bits) + per_tuple * b


def chunk_kernel_for(idx_bits: int, b: int, mode: str,
                     merge: Optional[Callable[[Any], Any]]) -> bool:
    """Whether Tdic32 walks a chunk of blocks of `b` tuples per lane on the
    codec-form kernels (`ops.dict_chunk_encode` / `dict_chunk_decode`):
    frozen mode, no per-block merge (private state), and a table and ring
    that fit in one CTA's shared memory in both directions (b up to 4,977
    at idx_bits 12, 3,498 at 13 and 540 at 14; never idx_bits 15 or more).
    Otherwise the codec walks block by block: exact mode updates the table
    per tuple, and the shared-state strategy merges the lanes' tables after
    every block, which a CTA per lane cannot see."""
    return (mode == "frozen" and merge is None and 1 <= idx_bits <= 31
            and chunk_smem_bytes(idx_bits, b, decode=True) <= MAX_SMEM_BYTES)


def _state_ptrs(table, valid, ts, clock):
    return table.data_ptr(), valid.data_ptr(), ts.data_ptr(), clock.data_ptr()


def launch_chunk_encode(blocks: torch.Tensor, state: tuple, idx_bits: int,
                        codes: torch.Tensor, bitlen: torch.Tensor, out_state: tuple) -> None:
    """blocks int32[C, L, B] and the state (table int32, valid uint8, ts
    int32 [L, 2^idx_bits], clock int32[L]) -> codes int32[C, L, B, 2],
    bitlen int32[C, L, B] and the state after the chunk in `out_state`
    (all contiguous, on one CUDA device, the outputs aliasing no input)."""
    c, lanes, b = blocks.shape
    err = build.library().repro_dict_chunk_encode(
        blocks.data_ptr(), *_state_ptrs(*state), c, lanes, b, idx_bits,
        codes.data_ptr(), bitlen.data_ptr(), *_state_ptrs(*out_state),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    build.check(err, "dict_chunk_encode")


def launch_chunk_decode(codes: torch.Tensor, state: tuple, idx_bits: int,
                        values: torch.Tensor, out_state: tuple) -> None:
    """codes int32[C, L, B, 2] and the state -> values int32[C, L, B] and
    the state after the chunk in `out_state`."""
    c, lanes, b, _ = codes.shape
    err = build.library().repro_dict_chunk_decode(
        codes.data_ptr(), *_state_ptrs(*state), c, lanes, b, idx_bits,
        values.data_ptr(), *_state_ptrs(*out_state),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    build.check(err, "dict_chunk_decode")
