"""Executor layer — blocked executors for both directions (port of
`repro/core/pipeline.py`, solo paths).

`BlockedExecutor` owns what compression and decompression share: the codec,
the resolved execution plan, block shaping and chunking. On top of it:

  * `CompressionPipeline` — encode + bit-pack. Execution paths:
      - **fused** (default for lazy execution): a chunk of C blocks
        `(C, lanes, B)` is encoded on the device in one codec call
        (`Codec.encode_blocks`), then two kernel launches make its egress
        wire-shaped: `pack_blocks_meta7` writes `(C, OW)` words, `(C,)` bit
        counts and the 7-bit metadata (`pack_blocks` alone where a block's
        symbols are not a multiple of 32, and the metadata travels as raw
        bit lengths), `compact_blocks` the compacted payload and its word
        total. One `.item()` sync per
        chunk fetches the live prefix, double-buffered so chunk k+1 is
        already enqueued when chunk k syncs.
      - **dispatch** (the `eager` strategy): one step per block.
    The tail that does not fill a block is edge-padded and packed as one
    smaller block; `collect_payload=True` keeps each block's wire
    contribution so `frame_from` can assemble the `bits.Frame`.
  * `DecompressionPipeline` — frame -> staged `(n, OW)` blocks ->
    `unpack_blocks` per chunk -> `Codec.decode_blocks`, with the
    quarantine latch of the reference.

Pad symbols of the tail block are dropped from the bitstream only for
`meta.maskable` codecs; codecs whose decoder replays state from the symbols
(delta_leb128, tdic32, rle) ship them, and the frame's valid counts trim
them after decode.

Under the shared-state strategy a dictionary codec's lanes merge their
tables after every block, in both directions (`merge_shared_dictionary`,
handed to the codec's chunk walk as a callable). Stream-scope codecs (rle)
decode in two passes: every block is unpacked, then one expansion decodes
the whole symbol stream, flush mini-block included. With
`entropy="rans"` the marshalled frame carries the rANS blob, coded on the
pipeline's device (B8's and B9's section forms), and parsing decodes it
there.

A codec seeded with a trained dictionary stamps its `(topic, version)` on
every frame it marshals (FEATURE_DICT), and decode seeds its state from the
dictionary the frame names, resolved through `core/dictstore.py`.

Every entry point runs on `torch.device("cuda")` unless the caller passes
`device="cpu"`; with no device and no GPU it raises. On the CPU the kernel
wrappers run their plain versions; on the card they launch the CUDA kernels.
Gang execution waits for ROADMAP A6; `dispatch_signature`, the key a gang
would stack streams by, is here already for the job API's `Plan`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.algorithms import (
    Codec,
    Encoded,
    WIRE_CODEC_IDS,
    WIRE_CODEC_NAMES,
    make_codec,
)
from repro_torch.core.calibration import calibrated_kwargs
from repro_torch.core.device import resolve_device
from repro_torch.core.strategies import (
    ExecutionPlan,
    ExecutionStrategy,
    SpecLike,
    StateStrategy,
    plan_execution,
)
from repro_torch.kernels import ops

#: scan length used when force-fusing a stream whose plan is per-block
#: dispatch (the eager Fig 10b breakdown replay)
_FORCED_FUSE_CHUNK = 128

#: spec fields that name features this port does not have yet:
#: (field, is-requested test, what it needs). `adaptive` and `dictionary`
#: are not read here, as in the reference: the job API's `negotiate` builds
#: the seeded codec and the tier plans
_UNPORTED_FIELDS = (
    ("gang", bool, "gang execution (ROADMAP A6)"),
    ("devices", lambda v: v > 0, "sharded fleets (ROADMAP A9)"),
)


def refuse_unported(config: SpecLike) -> None:
    """Raise a one-line NotImplementedError naming the ROADMAP item when a
    spec asks for a feature the port does not have yet."""
    for field, requested, what in _UNPORTED_FIELDS:
        value = getattr(config, field, None)
        if value is not None and requested(value):
            raise NotImplementedError(
                f"JobSpec.{field}={value!r} needs {what}, which repro_torch "
                "does not have yet; run this job on repro"
            )


def codec_align(codec: Codec) -> int:
    """Per-lane tuple alignment a codec requires (policy input).

    PLA fits superwindows of 2W tuples; every other codec packs any shape."""
    return 2 * codec.window if codec.name == "pla" else 1


def dispatch_signature(
    codec: Codec,
    lanes: int,
    per_lane: int,
    dtype: str = "uint32",
    entropy: str = "none",
    integrity: str = "none",
) -> Tuple[Any, ...]:
    """Gang dispatch signature: streams stack into one dispatch only when
    codec (resolved and calibrated parameters included), block geometry,
    dtype, entropy stage and integrity mode all match. Array-valued codec
    attributes (numpy or torch) hash by (dtype, shape, bytes), as the
    reference hashes its arrays, so the tuple equals the reference's."""
    parts: List[Any] = [codec.name, lanes, per_lane, dtype, entropy, integrity]
    for k, v in sorted(vars(codec).items()):
        if isinstance(v, (bool, int, float, str)):
            parts.append((k, v))
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            parts.append((k, (str(a.dtype), a.shape, a.tobytes())))
        else:
            # refuse rather than hash object identity: a repr/pointer key
            # would make identical streams silently never gang
            raise TypeError(
                f"codec param {k!r} of {codec.name!r} has unhashable type "
                f"{type(v).__name__} for gang signatures"
            )
    return tuple(parts)


# ------------------------------------------------------- shared-state merge --
def lww_select(tables: torch.Tensor, valids: torch.Tensor, tss: torch.Tensor):
    """Last-writer-wins slot selection over group axis 0.

    Given per-group dictionary views `(G, TS)`, returns the merged
    `(table, valid, ts)` rows `(TS,)`: each slot takes the entry with the
    newest write timestamp (invalid slots never win). Equal timestamps are
    common (every lane shares one clock), so ties go to the LOWEST group,
    as the reference's `jnp.argmax` does; the tie-break is spelled out as a
    min over the tied groups rather than left to an argmax."""
    key = torch.where(valids, tss, torch.full_like(tss, -1))
    groups = torch.arange(key.shape[0], device=key.device)[:, None]
    tied = key == key.max(dim=0, keepdim=True).values
    best = torch.where(tied, groups, key.shape[0]).amin(dim=0)
    slot = torch.arange(key.shape[1], device=key.device)
    return tables[best, slot], valids.any(dim=0), key[best, slot]


def merge_shared_dictionary(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Deterministic cross-lane dictionary merge (shared-state strategy):
    every lane converges to the last-writer-wins table and the newest
    clock after every micro-batch block. Decoder-replayable."""
    lanes, ts_size = state["table"].shape
    table, valid, ts = lww_select(state["table"], state["valid"], state["ts"])
    return {
        "table": table.expand(lanes, ts_size).contiguous(),
        "valid": valid.expand(lanes, ts_size).contiguous(),
        "ts": ts.expand(lanes, ts_size).contiguous(),
        "clock": state["clock"].max().expand(lanes).contiguous(),
    }


# ------------------------------------------------------------ shaped stream --
@dataclasses.dataclass
class ShapedStream:
    """Block view of a value stream: full blocks + optional masked tail."""

    blocks: np.ndarray  # uint32[n_full, lanes, B]
    tail: Optional[np.ndarray]  # uint32[lanes, B_tail] or None
    tail_mask: Optional[np.ndarray]  # bool[lanes, B_tail], True = real tuple
    n_valid: int  # real (unpadded) tuples across blocks + tail

    @property
    def n_blocks(self) -> int:
        return len(self.blocks) + (1 if self.tail is not None else 0)


@dataclasses.dataclass
class BlockPayload:
    """One block's wire contribution: packed words + per-symbol bitlens."""

    words: np.ndarray  # uint32[<=out_words] (worst-case buffer; prefix used)
    nbits: int
    bitlen: np.ndarray  # int32[lanes * B]
    valid: int  # real tuples in this block (0 for the flush mini-block)


@dataclasses.dataclass
class CompactedPayload:
    """One execution's egress, fetched wire-shaped: every block's live word
    prefix at its exclusive-prefix-sum offset, and the per-symbol bitlens
    packed at 7 bits/symbol — `Frame.from_compacted` then does header math
    only."""

    block_bits: np.ndarray  # int64[n_blocks (+tail +flush)]
    block_valid: np.ndarray  # int64[n_blocks], real tuples per block
    sym_counts: np.ndarray  # int64[n_blocks], symbol slots per block
    payload: np.ndarray  # uint32 — exact wire payload, stream order
    bitlen: np.ndarray  # int32[n_symbols] (decode-ready, unpacked)
    packed_meta: Optional[np.ndarray]  # uint32 — wire 7-bit metadata stream
    d2h_bytes: int  # payload + metadata + counter bytes fetched from the device


@dataclasses.dataclass
class ExecutionResult:
    """What one execution pass produced: bits per block + measured wall."""

    per_block_bits: np.ndarray  # float[n_blocks (+1 flush)] (pad masked)
    wall_s: float
    n_tuples: int  # real tuples compressed
    state: Any  # final codec state (for session reuse)
    compacted: Optional[CompactedPayload] = None  # compacted egress (default)
    legacy_payload: Optional[List[BlockPayload]] = None  # compact=False path
    flush_slots: int = 0  # per-lane slots of the flush mini-block


@dataclasses.dataclass
class DecompressionResult:
    """One frame's reconstruction + measured decode wall time."""

    values: np.ndarray  # uint32[n_valid]
    wall_s: float
    n_tuples: int


# ------------------------------------------------------------- egress sink --
class _EgressSink:
    """Assembles a `CompactedPayload` from double-buffered device fetches.

    `put_*` enqueues one unit's device tensors and fetches the PREVIOUS
    unit: by the time unit k's `.item()` forces a sync, unit k+1's launches
    are already queued, so the device computes ahead of the host copies.

    Stream-order contract: 7-bit-packed metadata units (full blocks) must
    all arrive before raw-bitlen units (tail/flush), and every packed unit
    must cover a multiple of 32 symbols, so the packed segments splice into
    the frame's global metadata stream without re-alignment.
    """

    def __init__(self):
        self._pending = None
        self.block_bits: List[int] = []
        self.block_valid: List[int] = []
        self.sym_counts: List[int] = []
        self.segments: List[np.ndarray] = []
        self.metas: List[np.ndarray] = []
        self.meta_symbols = 0
        self.raw_bitlens: List[np.ndarray] = []
        self.d2h_bytes = 0

    def add_unit(
        self,
        seg: np.ndarray,
        bits_list,
        valids,
        syms: int,
        meta: Optional[np.ndarray] = None,
        raw: Optional[np.ndarray] = None,
        extra_bytes: int = 0,
    ) -> None:
        """Record one fetched unit (`seg` exact payload words for `len(bits_list)`
        blocks of `syms` symbols each, plus its packed or raw metadata)."""
        self.segments.append(seg)
        self.block_bits.extend(int(b) for b in bits_list)
        self.block_valid.extend(int(v) for v in valids)
        self.sym_counts.extend([syms] * len(bits_list))
        meta_bytes = 0
        if meta is not None:
            if self.raw_bitlens:
                raise RuntimeError("packed metadata arrived after raw metadata")
            self.metas.append(meta.reshape(-1))
            self.meta_symbols += syms * len(bits_list)
            meta_bytes = meta.nbytes
        if raw is not None:
            r = np.asarray(raw, np.int32).reshape(-1)
            self.raw_bitlens.append(r)
            meta_bytes = r.nbytes
        self.d2h_bytes += seg.nbytes + meta_bytes + extra_bytes

    def put_chunk(self, tb, payload, total, meta, packed: bool, syms: int, valid: int):
        """One fused chunk: tb int32[C], payload int32[C*OW] (compacted,
        `total` words live), meta int32[C, MW] packed or int32[C, syms] raw."""
        self._flip(("chunk", tb, payload, total, meta, packed, syms, valid))

    def put_block(self, tb, words, blen, packed: bool, syms: int, valid: int):
        """One single-block unit (eager block / tail / flush): tb scalar,
        words int32[OW] worst-case (the host slices the live prefix), blen
        packed int32[MW] or raw int32[...]."""
        self._flip(("block", tb, words, blen, packed, syms, valid))

    def _flip(self, item) -> None:
        prev, self._pending = self._pending, item
        if prev is not None:
            self._fetch(prev)

    def flush_pending(self) -> None:
        if self._pending is not None:
            self._fetch(self._pending)
            self._pending = None

    @staticmethod
    def _meta_np(meta: torch.Tensor, packed: bool) -> np.ndarray:
        return bits.u32_numpy(meta) if packed else meta.cpu().numpy()

    def _fetch(self, item) -> None:
        if item[0] == "chunk":
            _, tb, payload, total, meta, packed, syms, valid = item
            tw = int(total.item())  # syncs THIS unit only
            seg = bits.u32_numpy(payload[:tw])  # only the live words travel
            tb_np = tb.cpu().numpy().astype(np.int64)
            meta_np = self._meta_np(meta, packed)
            self.add_unit(
                seg,
                tb_np,
                [valid] * tb_np.size,
                syms,
                meta=meta_np if packed else None,
                raw=None if packed else meta_np,
                extra_bytes=4 * tb_np.size + 4,
            )
        else:
            _, tb, words, blen, packed, syms, valid = item
            tbi = int(tb.item())
            seg = bits.u32_numpy(words[: (tbi + 31) // 32])
            blen_np = self._meta_np(blen, packed)
            self.add_unit(
                seg,
                [tbi],
                [valid],
                syms,
                meta=blen_np if packed else None,
                raw=None if packed else blen_np,
                extra_bytes=4,
            )

    def finish(self) -> CompactedPayload:
        self.flush_pending()
        payload = (
            np.concatenate(self.segments) if self.segments else np.zeros(0, np.uint32)
        )
        raw = (
            np.concatenate(self.raw_bitlens)
            if self.raw_bitlens
            else np.zeros(0, np.int32)
        )
        if self.metas:
            meta_cat = np.concatenate(self.metas)
            # packed units cover whole 32-symbol multiples, so the host-
            # packed raw tail splices in word-aligned
            if self.meta_symbols % 32:
                raise RuntimeError("packed metadata units must cover 32-symbol multiples")
            packed_meta = np.concatenate([meta_cat, bits._pack_bitlens(raw)])
            bitlen = np.concatenate(
                [bits._unpack_bitlens(meta_cat, self.meta_symbols), raw]
            )
        else:
            packed_meta = None
            bitlen = raw
        return CompactedPayload(
            block_bits=np.asarray(self.block_bits, np.int64),
            block_valid=np.asarray(self.block_valid, np.int64),
            sym_counts=np.asarray(self.sym_counts, np.int64),
            payload=payload,
            bitlen=bitlen,
            packed_meta=packed_meta,
            d2h_bytes=self.d2h_bytes,
        )


# --------------------------------------------------------- blocked executor --
class BlockedExecutor:
    """Codec + plan + block shaping + chunking (both directions)."""

    def __init__(
        self,
        config: SpecLike,
        sample: Optional[np.ndarray] = None,
        codec: Optional[Codec] = None,
        plan: Optional[ExecutionPlan] = None,
        device: Union[None, str, torch.device] = None,
    ):
        """`config` is any spec carrier with the EngineConfig attribute
        surface — `EngineConfig` or `repro_torch.api.JobSpec`. A given
        `plan`/`codec` is consumed as-is; otherwise both are derived here.
        `device` defaults to CUDA (and raises without a GPU)."""
        refuse_unported(config)
        self.device = resolve_device(device)
        self.config = config
        if codec is None:
            kwargs = dict(config.codec_kwargs)
            if config.calibrate and sample is not None:
                for k, v in calibrated_kwargs(config.codec, sample).items():
                    kwargs.setdefault(k, v)
            codec = make_codec(config.codec, **kwargs)
        self.codec: Codec = codec
        align = codec_align(self.codec)
        self.plan: ExecutionPlan = (
            plan if plan is not None else plan_execution(config, codec_align=align)
        )
        self._align = align
        #: stage-2 entropy coder applied at frame marshal ("none" | "rans")
        self.entropy: str = getattr(config, "entropy", None) or "none"
        #: wire integrity stamped at frame marshal ("none" | "crc32c")
        self.integrity: str = getattr(config, "integrity", None) or "none"
        #: the per-block state merge of the shared-state strategy, or None
        self.merge: Optional[Callable[[Any], Any]] = (
            merge_shared_dictionary
            if config.state == StateStrategy.SHARED
            and self.codec.meta.state_kind == "dictionary"
            else None
        )

    # ------------------------------------------------------------- plumbing
    def init_state(self, lanes: Optional[int] = None) -> Any:
        return self.codec.init_state(
            self.config.lanes if lanes is None else lanes, self.device
        )

    @property
    def block_tuples(self) -> int:
        return self.plan.block_tuples

    @property
    def align(self) -> int:
        """Per-lane tuple alignment the codec requires (PLA superwindows)."""
        return self._align

    def _merge_if_shared(self, state: Any) -> Any:
        return state if self.merge is None else self.merge(state)

    def warmup(self) -> None:
        """Build and load the CUDA kernels before a timed region (a no-op
        on the CPU): the first call compiles them with nvcc."""
        if self.device.type == "cuda":
            from repro_torch.kernels import build

            build.library()

    # --------------------------------------------------------------- shaping
    def shape_blocks(self, values: np.ndarray) -> ShapedStream:
        """Cut a flat uint32 stream into (lanes, B) blocks.

        The tail that does not fill a whole block becomes a smaller aligned
        block, edge-padded (repeat of the last value) with a mask marking the
        real tuples."""
        values = np.ascontiguousarray(values, np.uint32).ravel()
        bt = self.block_tuples
        lanes = self.config.lanes
        n_full = len(values) // bt
        blocks = values[: n_full * bt].reshape(n_full, lanes, bt // lanes)
        rem = len(values) - n_full * bt
        if rem == 0:
            # n_full == 0 is the legitimate empty stream: zero blocks, zero
            # valid tuples; the frame decodes back to an empty array
            return ShapedStream(blocks, None, None, n_full * bt)
        unit = lanes * self._align
        padded = ((rem + unit - 1) // unit) * unit
        tail_vals = np.full(padded, values[-1], np.uint32)
        tail_vals[:rem] = values[n_full * bt :]
        mask = np.zeros(padded, bool)
        mask[:rem] = True
        tail = tail_vals.reshape(lanes, padded // lanes)
        tail_mask = mask.reshape(lanes, padded // lanes)
        return ShapedStream(blocks, tail, tail_mask, n_full * bt + rem)

    def _chunks(self, n_blocks: int, chunk: Optional[int] = None):
        c = chunk or max(self.plan.scan_chunk, 1)
        return [(i, min(c, n_blocks - i)) for i in range(0, n_blocks, c)]


# ------------------------------------------------------ compression pipeline --
class CompressionPipeline(BlockedExecutor):
    """Ingress executor: encode + bit-pack + fused/dispatch execution paths."""

    def __init__(
        self,
        config: SpecLike,
        sample: Optional[np.ndarray] = None,
        codec: Optional[Codec] = None,
        plan: Optional[ExecutionPlan] = None,
        device: Union[None, str, torch.device] = None,
    ):
        super().__init__(config, sample=sample, codec=codec, plan=plan, device=device)
        probe = self.codec.flush(self.init_state())
        self._has_flush = probe is not None
        self._flush_slots = 0 if probe is None else int(probe.bitlen.shape[1])
        #: full blocks' symbol count divides the word size, so per-block
        #: 7-bit metadata packs on device and splices into the frame's
        #: global stream without re-alignment; odd geometries fall back to
        #: raw int32 bitlen transfer
        self._meta7_ok = self.plan.block_tuples % 32 == 0

    # -------------------------------------------------------------- core step
    def _pack(self, enc: Encoded, n_blocks: int, meta7: bool = False):
        """Pack `n_blocks` blocks of encoder output (leading dims flatten to
        n_blocks * S symbols) with the B1 kernel at the frame's width
        OW = 2S+2: (words int32[n, OW], nbits int32[n], bitlen int32[n, S]).
        With `meta7` (S % 32 == 0) the same launch also packs the bit
        lengths at 7 bits (`ops.pack_blocks_meta7`), returned in place of
        `bitlen` as int32[n, 7S/32]."""
        bitlen = enc.bitlen.reshape(n_blocks, -1).to(torch.int32).contiguous()
        s = bitlen.shape[1]
        codes = enc.codes.reshape(n_blocks * s, 2).contiguous()
        if meta7:
            return ops.pack_blocks_meta7(codes, bitlen.reshape(-1), block=s, out_words=2 * s + 2)
        words, nbits = ops.pack_blocks(codes, bitlen.reshape(-1), block=s, out_words=2 * s + 2)
        return words, nbits, bitlen

    def step(self, state: Any, block: torch.Tensor):
        """Encode one micro-batch block (lanes, B) and pack its bitstream."""
        return self.masked_step(state, block, None)

    def masked_step(self, state: Any, block: torch.Tensor, mask: Optional[torch.Tensor]):
        """`step` with pad slots (mask == False) dropped from the bitstream
        when the codec allows it (`meta.maskable`); non-maskable codecs ship
        their pad symbols so the decoder's state replay stays exact.
        Returns (state, words int32[OW], nbits, bitlen int32[lanes*B])."""
        state, enc = self.codec.encode(state, block)
        state = self._merge_if_shared(state)
        if mask is not None and self.codec.meta.maskable:
            enc = Encoded(enc.codes, torch.where(mask, enc.bitlen, torch.zeros_like(enc.bitlen)))
        words, nbits, bitlen = self._pack(enc, 1)
        return state, words[0], nbits[0], bitlen[0]

    def encode_chunk(self, state: Any, blocks: torch.Tensor):
        """Encode and pack C full blocks `(C, lanes, B)` in one codec call and
        one B1 launch: (state, words int32[C, OW], nbits int32[C],
        bitlen int32[C, lanes*B])."""
        state, enc = self.codec.encode_blocks(state, blocks, self.merge)
        words, nbits, bitlen = self._pack(enc, blocks.shape[0])
        return state, words, nbits, bitlen

    def _encode_chunk_meta(self, state: Any, blocks: torch.Tensor):
        """`encode_chunk` with the metadata the frame takes: under
        `_meta7_ok` the 7-bit packed bit lengths from the same B1 launch
        (B4 fused in), else the raw int32 bit lengths. Returns (state,
        words, nbits, meta)."""
        state, enc = self.codec.encode_blocks(state, blocks, self.merge)
        return (state, *self._pack(enc, blocks.shape[0], meta7=self._meta7_ok))

    def egress_chunk(self, state: Any, blocks: torch.Tensor):
        """`encode_chunk` + B3 compaction + B4 metadata packing (in B1's
        launch): the chunk's egress leaves the device wire-shaped. Returns
        (state, nbits, payload int32[C*OW], total, meta)."""
        state, words, nbits, meta = self._encode_chunk_meta(state, blocks)
        payload, total = ops.compact_blocks(words, nbits)
        return state, nbits, payload, total, meta

    # ------------------------------------------------------------- finalize
    def _pack_flush(self, state: Any):
        """Pack the codec's trailing state symbols (`Codec.flush`):
        (words int32[OW], nbits, bitlen int32[lanes, slots])."""
        enc = self.codec.flush(state)
        words, nbits, _ = self._pack(enc, 1)
        return words[0], nbits[0], enc.bitlen

    @property
    def flush_slots(self) -> int:
        """Per-lane symbol slots the flush mini-block occupies (0 = none)."""
        return self._flush_slots

    # -------------------------------------------------------- execution paths
    def run_fused(self, blocks_dev: torch.Tensor, state: Any,
                  chunk: Optional[int] = None, collect: bool = False):
        """Chunked execution: (state, per-chunk bits, words, bitlens)."""
        bits_out, words_out, blen_out = [], [], []
        for start, length in self._chunks(blocks_dev.shape[0], chunk):
            state, words, tb, blen = self.encode_chunk(state, blocks_dev[start : start + length])
            bits_out.append(tb)
            words_out.append(words)
            blen_out.append(blen if collect else None)
        return state, bits_out, words_out, blen_out

    def run_dispatch(self, blocks_dev: torch.Tensor, state: Any):
        """Per-block dispatch loop (eager strategy / Fig 10b baseline)."""
        bits_out, words_out, blen_out = [], [], []
        for i in range(blocks_dev.shape[0]):
            state, words, tb, blen = self.step(state, blocks_dev[i])
            bits_out.append(tb)
            words_out.append(words)
            blen_out.append(blen)
        return state, bits_out, words_out, blen_out

    def _stage(self, shaped: ShapedStream):
        blocks_dev = bits.u32_tensor(shaped.blocks, self.device) if len(shaped.blocks) else None
        tail_dev = mask_dev = None
        if shaped.tail is not None:
            tail_dev = bits.u32_tensor(shaped.tail, self.device)
            mask_dev = torch.from_numpy(shaped.tail_mask).to(self.device)
        return blocks_dev, tail_dev, mask_dev

    def execute(
        self,
        shaped: ShapedStream,
        state: Any = None,
        fused: Optional[bool] = None,
        warmup: bool = True,
        chunk: Optional[int] = None,
        finalize: bool = True,
        collect_payload: bool = False,
        compact: bool = True,
    ) -> ExecutionResult:
        """Run one shaped stream through the codec; measure wall time.

        `fused=None` follows the plan (lazy -> fused chunks, eager ->
        dispatch loop); pass an explicit bool to force a path. `chunk`
        overrides the plan's fusion length. `finalize=True` closes the
        stream (packs `Codec.flush`'s trailing symbols, if any).
        `collect_payload=True` keeps every block's wire contribution for
        `frame_from` — by default through the device compaction path;
        `compact=False` keeps the legacy worst-case-buffer collection as the
        measurable baseline and the `build_frame` oracle input."""
        if fused is True and chunk is None and self.plan.scan_chunk <= 1:
            chunk = _FORCED_FUSE_CHUNK
        if fused is None:
            fused = self.plan.execution == ExecutionStrategy.LAZY
        if warmup:
            self.warmup()
        if collect_payload and compact:
            return self._execute_egress(
                shaped, state=state, fused=fused, chunk=chunk, finalize=finalize
            )
        blocks_dev, tail_dev, mask_dev = self._stage(shaped)
        if state is None:
            state = self.init_state()
        bits_acc: List[Any] = []
        words_acc: List[Any] = []
        blen_acc: List[Any] = []
        flush_out = None
        t0 = time.perf_counter()
        if blocks_dev is not None:
            if fused:
                state, bits_acc, words_acc, blen_acc = self.run_fused(
                    blocks_dev, state, chunk, collect=collect_payload
                )
            else:
                state, bits_acc, words_acc, blen_acc = self.run_dispatch(blocks_dev, state)
        if tail_dev is not None:
            state, twords, tb, tblen = self.masked_step(state, tail_dev, mask_dev)
            bits_acc.append(tb)
            words_acc.append(twords)
            blen_acc.append(tblen)
        if finalize and self._has_flush:
            flush_out = self._pack_flush(state)
            bits_acc.append(flush_out[1])
        per_block = (
            np.concatenate(
                [np.atleast_1d(b.cpu().numpy()).astype(np.float64) for b in bits_acc]
            )
            if bits_acc
            else np.zeros(0, np.float64)
        )
        wall = time.perf_counter() - t0

        payload = None
        flush_slots = self.flush_slots if (finalize and self._has_flush) else 0
        if collect_payload:
            payload = self._collect_payload(shaped, words_acc, blen_acc, per_block, flush_out)
        return ExecutionResult(
            per_block_bits=per_block,
            wall_s=wall,
            n_tuples=shaped.n_valid,
            state=state,
            legacy_payload=payload,
            flush_slots=flush_slots,
        )

    def _execute_egress(
        self,
        shaped: ShapedStream,
        state: Any = None,
        fused: bool = True,
        chunk: Optional[int] = None,
        finalize: bool = True,
    ) -> ExecutionResult:
        """`execute` with the device compaction egress (the default
        `collect_payload` path): each fused chunk (or eager block) leaves the
        device wire-shaped and is fetched through the double-buffered
        `_EgressSink`. The wall includes the interleaved fetches."""
        blocks_dev, tail_dev, mask_dev = self._stage(shaped)
        if state is None:
            state = self.init_state()
        sink = _EgressSink()
        bt = self.block_tuples
        lanes = self.config.lanes
        rem = shaped.n_valid - len(shaped.blocks) * bt

        t0 = time.perf_counter()
        if blocks_dev is not None:
            if fused:
                for start, length in self._chunks(blocks_dev.shape[0], chunk):
                    state, tb, payload, total, meta = self.egress_chunk(
                        state, blocks_dev[start : start + length]
                    )
                    sink.put_chunk(
                        tb, payload, total, meta,
                        packed=self._meta7_ok, syms=bt, valid=bt,
                    )
            else:
                for i in range(blocks_dev.shape[0]):
                    state, words, tb, meta = self._encode_chunk_meta(state, blocks_dev[i : i + 1])
                    sink.put_block(
                        tb[0], words[0], meta[0], packed=self._meta7_ok, syms=bt, valid=bt
                    )
        if tail_dev is not None:
            state, twords, tb, tblen = self.masked_step(state, tail_dev, mask_dev)
            sink.put_block(
                tb, twords, tblen, packed=False,
                syms=int(tail_dev.shape[0] * tail_dev.shape[1]), valid=rem,
            )
        if finalize and self._has_flush:
            fw, fb, fblen = self._pack_flush(state)
            sink.put_block(
                fb, fw, fblen, packed=False, syms=lanes * self._flush_slots, valid=0
            )
        comp = sink.finish()
        wall = time.perf_counter() - t0

        flush_slots = self.flush_slots if (finalize and self._has_flush) else 0
        return ExecutionResult(
            per_block_bits=comp.block_bits.astype(np.float64),
            wall_s=wall,
            n_tuples=shaped.n_valid,
            state=state,
            compacted=comp,
            flush_slots=flush_slots,
        )

    # ------------------------------------------------------------- framing
    def _collect_payload(
        self, shaped: ShapedStream, words_acc, blen_acc, per_block: np.ndarray, flush_out
    ) -> List[BlockPayload]:
        """Host copies of every block's wire contribution (post-timing): the
        legacy (compact=False) egress, where every block's FULL worst-case
        word buffer and raw int32 bitlens cross device->host."""
        n_full = len(shaped.blocks)
        bt = self.block_tuples
        rem = shaped.n_valid - n_full * bt
        words_np: List[np.ndarray] = []
        blen_np: List[np.ndarray] = []
        for w, b in zip(words_acc, blen_acc):
            w = bits.u32_numpy(w)
            b = b.cpu().numpy().astype(np.int32)
            if w.ndim == 2:  # one fused chunk: (chunk, OW) / (chunk, L*B)
                words_np.extend(w)
                blen_np.extend(b)
            else:
                words_np.append(w)
                blen_np.append(b)
        payload = [
            BlockPayload(words_np[i], int(per_block[i]), blen_np[i], bt)
            for i in range(n_full)
        ]
        k = n_full
        if shaped.tail is not None:
            payload.append(BlockPayload(words_np[k], int(per_block[k]), blen_np[k], rem))
        if flush_out is not None:
            payload.append(BlockPayload(*self._flush_entry(flush_out)))
        return payload

    @staticmethod
    def _flush_entry(flush_out) -> tuple:
        """Canonical flush-mini-block entry (words, nbits, bitlen, valid=0)."""
        fw, fb, fblen = flush_out
        return (bits.u32_numpy(fw), int(fb), fblen.cpu().numpy().astype(np.int32).ravel(), 0)

    def _apply_wire_features(self, frame: bits.Frame) -> bits.Frame:
        """Apply the wire stages this pipeline negotiated to a marshalled
        frame: the dict id of a seeded codec, the rANS blob (coded on this
        pipeline's device), then the integrity flag, whose CRCs `to_bytes`
        computes over the final, post-entropy sections. The frame keeps its
        raw fields; only serialization changes."""
        topic = getattr(self.codec, "dict_topic", None)
        if topic is not None:
            frame.dict_id = (topic, self.codec.dict_version)
        if self.entropy == "rans":
            frame.apply_entropy(self.device)
        if self.integrity == "crc32c":
            frame.integrity = "crc32c"
        return frame

    def marshal_frame(
        self,
        blocks,
        per_lane: int,
        n_full: int,
        tail_per_lane: int,
        flush_slots: int,
        n_valid: int,
    ) -> bits.Frame:
        """Single authority for frame marshalling: codec id and lane count
        come from this pipeline's config, callers only supply the block
        geometry and the (words, nbits, bitlen, valid) entries."""
        return self._apply_wire_features(bits.build_frame(
            codec_id=WIRE_CODEC_IDS[self.codec.name],
            lanes=self.config.lanes,
            per_lane=per_lane,
            n_full=n_full,
            tail_per_lane=tail_per_lane,
            flush_slots=flush_slots,
            n_valid=n_valid,
            blocks=blocks,
        ))

    def marshal_compacted(
        self,
        *,
        per_lane: int,
        n_full: int,
        tail_per_lane: int,
        flush_slots: int,
        n_valid: int,
        block_bits,
        block_valid,
        payload,
        bitlen=None,
        packed_meta=None,
    ) -> bits.Frame:
        """`marshal_frame`'s compacted twin (`Frame.from_compacted`)."""
        return self._apply_wire_features(bits.Frame.from_compacted(
            codec_id=WIRE_CODEC_IDS[self.codec.name],
            lanes=self.config.lanes,
            per_lane=per_lane,
            n_full=n_full,
            tail_per_lane=tail_per_lane,
            flush_slots=flush_slots,
            n_valid=n_valid,
            block_bits=block_bits,
            block_valid=block_valid,
            payload=payload,
            bitlen=bitlen,
            packed_meta=packed_meta,
        ))

    def frame_from(self, shaped: ShapedStream, result: ExecutionResult) -> bits.Frame:
        """Assemble the wire-format frame from a `collect_payload` run:
        compacted results take `Frame.from_compacted` (header math only),
        legacy results go through `build_frame`."""
        geometry = dict(
            per_lane=self.block_tuples // self.config.lanes,
            n_full=len(shaped.blocks),
            tail_per_lane=0 if shaped.tail is None else shaped.tail.shape[1],
            flush_slots=result.flush_slots,
            n_valid=shaped.n_valid,
        )
        if result.compacted is not None:
            c = result.compacted
            return self.marshal_compacted(
                **geometry,
                block_bits=c.block_bits,
                block_valid=c.block_valid,
                payload=c.payload,
                bitlen=c.bitlen,
                packed_meta=c.packed_meta,
            )
        if result.legacy_payload is None:
            raise ValueError("execute(collect_payload=True) required for framing")
        return self.marshal_frame(
            blocks=[(p.words, p.nbits, p.bitlen, p.valid) for p in result.legacy_payload],
            **geometry,
        )

    def compress_to_frame(
        self, values: np.ndarray, state: Any = None, compact: bool = True
    ) -> bits.Frame:
        """One-call egress: shape, execute (fused per plan), finalize, frame."""
        shaped = self.shape_blocks(values)
        res = self.execute(shaped, state=state, collect_payload=True, compact=compact)
        return self.frame_from(shaped, res)


# ---------------------------------------------------- decompression pipeline --
class DecompressionPipeline(BlockedExecutor):
    """Egress executor: frame -> staged blocks -> chunked unpack + decode.

    Pass the SAME codec (or an identically configured one) that produced
    the frame: the frame header identifies the codec family."""

    def __init__(
        self,
        config: SpecLike,
        codec: Optional[Codec] = None,
        sample: Optional[np.ndarray] = None,
        plan: Optional[ExecutionPlan] = None,
        device: Union[None, str, torch.device] = None,
    ):
        super().__init__(config, sample=sample, codec=codec, plan=plan, device=device)
        #: poisoned-state latch: set to the first FrameError that made this
        #: decoder fail; further decode calls refuse until reset_quarantine()
        self.quarantined: Optional[bits.FrameError] = None

    # ------------------------------------------------------------ frame prep
    @staticmethod
    def _split_frame(frame: bits.Frame):
        """Frame -> (block shapes, stage(b0, b1)): `stage` returns blocks
        [b0, b1) (one shape) as uint32[n, OW] worst-case word buffers, the
        executor's fixed width OW = 2*L*B+2, and int32[n, L, B] bitlens."""
        shapes = frame.block_shapes()
        seg_words = frame.block_words()
        seg_starts = np.concatenate([[0], np.cumsum(seg_words)]).astype(np.int64)
        sym_counts = [L * B for (L, B) in shapes]
        sym_starts = np.concatenate([[0], np.cumsum(sym_counts)]).astype(np.int64)

        def stage(b0: int, b1: int) -> Tuple[np.ndarray, np.ndarray]:
            L, B = shapes[b0]
            n = b1 - b0
            words = np.zeros((n, L * B * 2 + 2), np.uint32)
            nw = seg_words[b0:b1]
            rows = np.repeat(np.arange(n), nw)
            cols = np.arange(int(nw.sum())) - np.repeat(seg_starts[b0:b1] - seg_starts[b0], nw)
            words[rows, cols] = frame.payload[seg_starts[b0] : seg_starts[b1]]
            bl = frame.bitlen[sym_starts[b0] : sym_starts[b1]].reshape(n, L, B)
            return words, bl

        return shapes, stage

    # ------------------------------------------------------------ decompress
    def decompress(self, frame: bits.Frame, warmup: bool = True) -> DecompressionResult:
        """Reconstruct a frame's stream.

        Decode failures latch the pipeline into quarantine: the first
        `bits.FrameError` is stored on ``quarantined`` and every later call
        refuses until `reset_quarantine` — a poisoned session must not keep
        emitting values from a stream whose framing it no longer trusts."""
        self._check_quarantine()
        try:
            return self._decompress(frame, warmup=warmup)
        except bits.FrameError as err:
            self.quarantined = err
            raise
        except (ValueError, IndexError, RuntimeError) as exc:
            # corrupt bodies surface as shape/index errors while staging
            msg = " ".join(str(exc).split())
            err = bits.FrameDecodeError(
                f"frame decode failed ({type(exc).__name__}: {msg}); "
                "discard the frame and resynchronize the stream"
            )
            self.quarantined = err
            raise err from exc

    def ingest(self, buf: Union[bytes, bytearray, memoryview]) -> DecompressionResult:
        """Parse raw wire bytes and decode them in one step. Parse-stage
        failures latch the same quarantine as decode-stage ones."""
        self._check_quarantine()
        try:
            frame = bits.parse_frame(buf, self.device)
        except bits.FrameError as err:
            self.quarantined = err
            raise
        return self.decompress(frame)

    def reset_quarantine(self) -> None:
        """Clear the poisoned-state latch once the stream is resynchronized."""
        self.quarantined = None

    def _check_quarantine(self) -> None:
        if self.quarantined is not None:
            raise bits.FrameDecodeError(
                f"decoder is quarantined after a poisoned frame ({self.quarantined}); "
                "resynchronize the stream and call reset_quarantine() to resume"
            )

    def _decompress(self, frame: bits.Frame, warmup: bool = True) -> DecompressionResult:
        want = WIRE_CODEC_IDS.get(self.codec.name)
        if frame.codec_id != want:
            raise bits.FrameDecodeError(
                f"frame codec id {frame.codec_id} "
                f"({WIRE_CODEC_NAMES.get(frame.codec_id, '?')}) != pipeline codec "
                f"{self.codec.name!r}"
            )
        if warmup:
            self.warmup()
        shapes, stage = self._split_frame(frame)
        n_full = frame.n_full
        # device prep, symmetric with execute's upload: the uniform full
        # blocks stacked for the chunk loop, the extras one by one
        full = None
        if n_full:
            words, bl = stage(0, n_full)
            full = (bits.u32_tensor(words, self.device), torch.from_numpy(bl).to(self.device))
        extras = []
        for b in range(n_full, len(shapes)):
            words, bl = stage(b, b + 1)
            extras.append((bits.u32_tensor(words, self.device), torch.from_numpy(bl).to(self.device)))

        t0 = time.perf_counter()
        outs = self._run_blocks(self._initial_state(frame, frame.lanes), frame.lanes, full, extras)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        values = self._assemble(frame, shapes, outs)
        return DecompressionResult(values=values, wall_s=wall, n_tuples=frame.n_valid)

    def _initial_state(self, frame: bits.Frame, lanes: int) -> Any:
        """Decode-side state from the frame's declared dictionary.

        A FEATURE_DICT frame names the `(topic, version)` its encoder was
        seeded with, so decode replays from the same table whichever
        dictionary (if any) this pipeline's codec carries. A plain frame
        decodes cold, so segments on both sides of a hot swap each get the
        seed their own header declares."""
        did = frame.dict_id
        codec_did = getattr(self.codec, "dict_topic", None)
        if did is None:
            if codec_did is not None:
                return self.codec.cold_state(lanes, self.device)
            return self.init_state(lanes)
        if codec_did == did[0] and getattr(self.codec, "dict_version", None) == did[1]:
            return self.init_state(lanes)  # the codec already carries this seed
        from repro_torch.core import dictstore

        try:
            trained = dictstore.resolve(did[0], did[1])
        except KeyError as e:
            raise bits.FrameDecodeError(
                f"frame references trained dictionary '{did[0]}:v{did[1]}' "
                f"which this registry cannot resolve ({e.args[0]}); publish it "
                f"or point CSTREAM_DICT_ROOT at the collector's registry"
            ) from e
        if self.codec.meta.state_kind != "dictionary":
            raise bits.FrameDecodeError(
                f"frame references trained dictionary '{trained.ref}' but "
                f"pipeline codec {self.codec.name!r} takes no dictionary"
            )
        if trained.idx_bits != self.codec.idx_bits:
            raise bits.FrameDecodeError(
                f"frame dictionary '{trained.ref}' has idx_bits="
                f"{trained.idx_bits}, decode codec has idx_bits={self.codec.idx_bits}"
            )
        return trained.seed_state(lanes, self.device)

    def _run_blocks(self, state: Any, lanes: int, full, extras):
        """One decode pass over the staged blocks (the timed region) from
        `state`, the codec's state before the frame's first block. Each
        unit (a chunk of full blocks, or one extra block) is unpacked by the
        B2 kernel. Block-scope codecs decode it right away, replaying state
        (and the shared merge) block after block: a list of int32[C, L, B].
        Stream-scope codecs collect every unit's symbols in temporal order
        per lane and expand them in one decode: int32[L, total slots]."""
        stream_scope = self.codec.meta.scope == "stream"
        units = []
        if full is not None:
            words, bl = full
            units = [
                (words[start : start + length], bl[start : start + length])
                for start, length in self._chunks(words.shape[0])
            ]
        outs: List[torch.Tensor] = []
        codes_l, blen_l = [], []
        for words, bl in units + list(extras):
            c, _, b = bl.shape
            codes = ops.unpack_blocks(words, bl.reshape(-1).contiguous()).view(c, lanes, b, 2)
            if stream_scope:
                codes_l.append(codes.permute(1, 0, 2, 3).reshape(lanes, c * b, 2))
                blen_l.append(bl.permute(1, 0, 2).reshape(lanes, c * b))
            else:
                state, x = self.codec.decode_blocks(state, Encoded(codes, bl), self.merge)
                outs.append(x)
        if not stream_scope:
            return outs
        _, x = self.codec.decode(
            None, Encoded(torch.cat(codes_l, dim=1), torch.cat(blen_l, dim=1))
        )
        return x

    @staticmethod
    def _assemble(frame: bits.Frame, shapes, outs) -> np.ndarray:
        """Trim per-block pads (flat row-major suffix) and re-flatten. The
        flush mini-block, if any, carries no tuples. `outs` is a list of
        per-unit (C, L, B) blocks, or a stream-scope codec's (L, slots)
        expansion, cut here into the blocks' (L, B) columns."""
        n_data = frame.n_full + (1 if frame.tail_per_lane else 0)
        if isinstance(outs, torch.Tensor):
            xs = bits.u32_numpy(outs)
            starts = np.concatenate([[0], np.cumsum([b for _, b in shapes])])
            rows = [xs[:, starts[i] : starts[i + 1]].ravel() for i in range(n_data)]
        else:
            rows = [r for x in outs for r in bits.u32_numpy(x).reshape(x.shape[0], -1)]
        pieces = [rows[b][: int(frame.block_valid[b])] for b in range(n_data)]
        values = np.concatenate(pieces) if pieces else np.zeros(0, np.uint32)
        return values.astype(np.uint32)[: frame.n_valid]
