"""Tdic32: lossless dictionary-state codec (port of
`repro/core/algorithms/dictionary.py`; LZ4-like hash table, paper §3.1.4).

Two execution fidelities, as in the reference:

  * ``mode='frozen'`` — lookups hit the table frozen at micro-batch start;
    updates are merged once at batch end with deterministic
    last-writer-wins. The table freezes per block, never per chunk. A
    chunk of blocks (`encode_blocks`/`decode_blocks`) with private state
    is walked on the card in one launch per direction, B5's codec form
    (`ops.dict_chunk_encode`/`dict_chunk_decode`, under the rule
    `dict_hash.chunk_kernel_for`); under the shared-state strategy, or
    with a table too large for the kernels' shared memory, block by block
    (`encode_each_block`/`decode_each_block`: B5's probe, `ops.dict_probe`,
    one launch per block for all lanes, and the merge in torch ops), as a
    single block (`encode`/`decode`, the executor's tail) always is.
  * ``mode='exact'`` — the per-tuple semantics: the table is updated after
    every tuple. The reference runs it as a `lax.scan`; here it is a plain
    per-tuple loop of tensor ops on both devices (a serial CUDA kernel for
    it is later work).

Symbol format (LSB-first): flag bit (1 = hit) then either the table index
(idx_bits) or the 32-bit literal. The state is uint32 table words (int32
bits), a bool valid mask, int32 write timestamps for the shared-state
merge, and an int32 per-lane clock. `seed_dictionary` starts every stream
from a trained per-topic table (`core/dictstore.py`): seeded slots enter
valid with write stamp 0, so the first write to one wins as it would on an
empty slot, and a slot never written keeps its seed.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register
from repro_torch.kernels import dict_hash, ops


@register("tdic32")
class Tdic32(Codec):
    # not maskable: decode replays table inserts from decoded symbols; pad
    # symbols must travel so the replayed table matches the encoder's
    meta = CodecMeta(
        "tdic32", lossy=False, stateful=True, state_kind="dictionary",
        aligned=False, maskable=False,
    )
    state_dtypes = {
        "table": np.dtype(np.uint32),
        "valid": np.dtype(np.bool_),
        "ts": np.dtype(np.int32),
        "clock": np.dtype(np.int32),
    }
    def __init__(self, idx_bits: int = 12, mode: str = "frozen"):
        assert mode in ("frozen", "exact")
        self.idx_bits = idx_bits
        self.table_size = 1 << idx_bits
        self.mode = mode

    def seed_dictionary(self, trained) -> "Tdic32":
        """Start every stream from a trained per-topic table (dictstore).

        The seed arrays (numpy, as the reference keeps them) and the id
        become instance attributes, so a dispatch signature over
        `vars(codec)` separates seeded codecs by dictionary content, and an
        unseeded codec keeps its attributes and signature unchanged."""
        if trained.idx_bits != self.idx_bits:
            raise ValueError(
                f"trained dictionary '{trained.ref}' was built with "
                f"idx_bits={trained.idx_bits}, codec has idx_bits={self.idx_bits}"
            )
        self.dict_topic = trained.topic
        self.dict_version = int(trained.version)
        self.dict_id = trained.ref
        self.dict_hash = trained.content_hash
        self._seed_table = trained.table
        self._seed_valid = trained.valid
        self._seed_ts = trained.ts
        return self

    def init_state(self, lanes: int, device: torch.device):
        """The stream's first state: the seed table broadcast over the
        lanes (valid and stamps from the artifact, clock 0), or the cold
        state for an unseeded codec."""
        seed = getattr(self, "_seed_table", None)
        if seed is None:
            return self.cold_state(lanes, device)

        def lanes_of(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            row = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            return row.to(device, dtype).expand(lanes, self.table_size).contiguous()

        return {
            "table": lanes_of(seed, torch.int32),
            "valid": lanes_of(self._seed_valid, torch.bool),
            "ts": lanes_of(self._seed_ts, torch.int32),
            "clock": torch.zeros((lanes,), dtype=torch.int32, device=device),
        }

    def cold_state(self, lanes: int, device: torch.device):
        """The unseeded state: empty table, clock 0."""
        return {
            "table": torch.zeros((lanes, self.table_size), dtype=torch.int32, device=device),
            "valid": torch.zeros((lanes, self.table_size), dtype=torch.bool, device=device),
            # write timestamps: let the shared-state strategy merge tables
            # with true last-writer-wins semantics (decoder-replayable)
            "ts": torch.full((lanes, self.table_size), -1, dtype=torch.int32, device=device),
            "clock": torch.zeros((lanes,), dtype=torch.int32, device=device),
        }

    def _hash(self, x: torch.Tensor) -> torch.Tensor:
        return dict_hash.hash_tensor(x, self.idx_bits)

    # ------------------------------------------------------------- frozen --
    def _encode_frozen(self, state, x):
        c0, c1, blen = ops.dict_probe(
            x, state["table"], state["valid"].view(torch.uint8), self.idx_bits
        )
        new_state = dict_hash.merge_updates(state, self._hash(x), x, self.idx_bits)
        return new_state, Encoded(torch.stack([c0, c1], dim=-1), blen)

    def _decode_frozen(self, state, enc):
        hit, idx, literal = dict_hash.unsymbol(enc.codes, self.idx_bits)
        entry = bits._u(state["table"].gather(1, idx))
        x = bits._i32(torch.where(hit, entry, literal))
        return dict_hash.merge_updates(state, self._hash(x), x, self.idx_bits), x

    # -------------------------------------------------------------- exact --
    def _exact_walk(self, state, b: int, step):
        """Per-tuple table updates: `step(t, table, valid)` returns the
        tuple column written at t (int32[L]); the table, valid mask and
        timestamps take it at its slot, one write per lane."""
        table, valid, ts = (state[k].clone() for k in ("table", "valid", "ts"))
        lane = torch.arange(table.shape[0], device=table.device)
        for t in range(b):
            xt = step(t, table, valid)
            h = self._hash(xt)
            table[lane, h] = xt
            valid[lane, h] = True
            ts[lane, h] = state["clock"] + t
        return {"table": table, "valid": valid, "ts": ts, "clock": state["clock"] + b}

    def _encode_exact(self, state, x):
        lanes, b = x.shape
        h = self._hash(x)
        lane = torch.arange(lanes, device=x.device)
        hit = torch.zeros((lanes, b), dtype=torch.bool, device=x.device)

        def step(t, table, valid):
            hit[:, t] = valid[lane, h[:, t]] & (table[lane, h[:, t]] == x[:, t])
            return x[:, t]

        new_state = self._exact_walk(state, b, step)
        c0, c1, blen = dict_hash.symbols(hit, h, x, self.idx_bits)
        return new_state, Encoded(torch.stack([c0, c1], dim=-1), blen)

    def _decode_exact(self, state, enc):
        lanes, b = enc.bitlen.shape
        hit, idx, literal = dict_hash.unsymbol(enc.codes, self.idx_bits)
        literal = bits._i32(literal)
        lane = torch.arange(lanes, device=literal.device)
        x = torch.empty_like(literal)

        def step(t, table, valid):
            x[:, t] = torch.where(hit[:, t], table[lane, idx[:, t]], literal[:, t])
            return x[:, t]

        return self._exact_walk(state, b, step), x

    # -------------------------------------------------------------- public --
    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        x = x.to(torch.int32).contiguous()
        return self._encode_frozen(state, x) if self.mode == "frozen" else self._encode_exact(state, x)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        return self._decode_frozen(state, enc) if self.mode == "frozen" else self._decode_exact(state, enc)

    @staticmethod
    def kernel_state(state) -> tuple:
        """The state as the chunk kernels take it (valid as uint8 bytes)."""
        return (state["table"].contiguous(), state["valid"].contiguous().view(torch.uint8),
                state["ts"].contiguous(), state["clock"].contiguous())

    @staticmethod
    def codec_state(table, valid, ts, clock):
        """`kernel_state`'s inverse."""
        return {"table": table, "valid": valid.view(torch.bool), "ts": ts, "clock": clock}

    def encode_blocks(self, state: Any, blocks: torch.Tensor,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, Encoded]:
        """Encode C consecutive blocks `(C, L, B)` with the table frozen per
        block: the symbols and state of C `encode` calls, each followed by
        `merge` (the shared-state strategy's cross-lane merge, or None).
        Inside `dict_hash.chunk_kernel_for` one `ops.dict_chunk_encode`
        call; outside it `encode_each_block`."""
        blocks = blocks.to(torch.int32).contiguous()
        if not dict_hash.chunk_kernel_for(self.idx_bits, blocks.shape[2], self.mode, merge):
            return self.encode_each_block(state, blocks, merge)
        codes, bitlen, *st = ops.dict_chunk_encode(blocks, *self.kernel_state(state), self.idx_bits)
        return self.codec_state(*st), Encoded(codes, bitlen)

    def decode_blocks(self, state: Any, enc: Encoded,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, torch.Tensor]:
        """`encode_blocks`'s inverse with the same `merge`: codes
        `(C, L, B, 2)`, bitlen `(C, L, B)` -> values `(C, L, B)`; inside the
        rule one `ops.dict_chunk_decode` call, outside it
        `decode_each_block`."""
        if not dict_hash.chunk_kernel_for(self.idx_bits, enc.codes.shape[2], self.mode, merge):
            return self.decode_each_block(state, enc, merge)
        codes = enc.codes.to(torch.int32).contiguous()
        x, *st = ops.dict_chunk_decode(codes, *self.kernel_state(state), self.idx_bits)
        return self.codec_state(*st), x

    def encode_each_block(self, state: Any, blocks: torch.Tensor,
                          merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, Encoded]:
        """`encode_blocks` one block at a time, any mode and merge: one
        `encode` call per block, then `merge` on the state."""
        codes, bitlen = [], []
        for blk in blocks:
            state, enc = self.encode(state, blk)
            state = state if merge is None else merge(state)
            codes.append(enc.codes)
            bitlen.append(enc.bitlen)
        return state, Encoded(torch.stack(codes), torch.stack(bitlen))

    def decode_each_block(self, state: Any, enc: Encoded,
                          merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, torch.Tensor]:
        """`decode_blocks` one block at a time: `encode_each_block`'s
        inverse."""
        xs = []
        for codes, bitlen in zip(enc.codes, enc.bitlen):
            state, x = self.decode(state, Encoded(codes, bitlen))
            state = state if merge is None else merge(state)
            xs.append(x)
        return state, torch.stack(xs)
