"""Codec API (port of `repro/core/algorithms/base.py`).

  * Streams are `(lanes, B)` uint32 tuple arrays, carried as `torch.int32`
    tensors holding the uint32 bit patterns (see `repro_torch.core.bits`).
    `lanes` are parallel substreams, each with private state.
  * Encoders are shape-stable: every input tuple owns one output symbol slot
    `(codes[l, b, 2], bitlen[l, b])`. The bit-packer (`core/bits.py`, the
    CUDA kernels under `csrc/`) turns symbol slots into a dense bitstream.
  * Stateful codecs carry a dict of tensors with leading dim `lanes`;
    `decode` replays the same state evolution, so a decoder needs only the
    symbol stream. `flush` emits the trailing state (rle's open run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Encoded:
    """Shape-stable encoder output: one symbol slot per input tuple."""

    codes: torch.Tensor  # int32[..., L, B, 2] (low word, high word), LSB-first
    bitlen: torch.Tensor  # int32[..., L, B]     (0 => suppressed slot)

    @property
    def total_bits(self) -> torch.Tensor:
        """The sum of `bitlen`: a 0-d int64 tensor on `bitlen`'s device."""
        return self.bitlen.sum(dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class CodecMeta:
    name: str
    lossy: bool
    stateful: bool
    state_kind: str  # 'none' | 'value' | 'dictionary' | 'model'
    aligned: bool
    #: decode locality: 'block' codecs reconstruct each micro-batch block
    #: from its own symbols (+ replayed state); 'stream' codecs emit symbols
    #: whose expansion crosses block boundaries
    scope: str = "block"  # 'block' | 'stream'
    #: True if pad symbols may be dropped from the wire: the decoder never
    #: reads them and no state replay depends on them
    maskable: bool = True


class Codec:
    """Base class. Subclasses are immutable config holders; all methods are
    pure functions of (state, data) on tensors."""

    meta: CodecMeta
    #: numpy dtype of each state field, for `state_to_numpy`: uint32 fields
    #: travel as int32 tensors holding the same bits
    state_dtypes: Dict[str, np.dtype] = {}

    def init_state(self, lanes: int, device: torch.device) -> Any:
        return None

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        raise NotImplementedError

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        """Replays encoder state; returns reconstructed int32[L, B] bits."""
        raise NotImplementedError

    def flush(self, state: Any) -> Optional[Encoded]:
        """Final symbols for trailing state (None if the codec has none).
        Must not mutate `state`."""
        return None

    def encode_blocks(self, state: Any, blocks: torch.Tensor,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, Encoded]:
        """Encode C consecutive blocks `(C, L, B)` in one call.

        Lane l's symbols across the chunk are the encoding of its
        concatenated tuples `blocks.permute(1, 0, 2).reshape(L, C*B)`, which
        equals C sequential `encode` calls for every codec whose state is a
        per-lane recurrence over the tuple stream (raw32, tcomp32, leb128,
        delta_leb128, rle). `merge` is the shared-state strategy's cross-lane
        merge after every block; only codecs with dictionary state take one,
        and they override this form to walk their blocks (Tdic32)."""
        if merge is not None:
            raise ValueError(f"codec {self.name!r} has no per-block state merge")
        c, lanes, b = blocks.shape
        state, enc = self.encode(state, blocks.permute(1, 0, 2).reshape(lanes, c * b))
        return state, Encoded(
            enc.codes.reshape(lanes, c, b, 2).permute(1, 0, 2, 3),
            enc.bitlen.reshape(lanes, c, b).permute(1, 0, 2),
        )

    def decode_blocks(self, state: Any, enc: Encoded,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, torch.Tensor]:
        """Decode C consecutive blocks (`encode_blocks`'s inverse): codes
        `(C, L, B, 2)`, bitlen `(C, L, B)` -> values `(C, L, B)`."""
        if merge is not None:
            raise ValueError(f"codec {self.name!r} has no per-block state merge")
        c, lanes, b = enc.bitlen.shape
        flat = Encoded(
            enc.codes.permute(1, 0, 2, 3).reshape(lanes, c * b, 2),
            enc.bitlen.permute(1, 0, 2).reshape(lanes, c * b),
        )
        state, x = self.decode(state, flat)
        return state, x.reshape(lanes, c, b).permute(1, 0, 2)

    def error_bound(self) -> Optional[float]:
        """Max-abs reconstruction error this codec guarantees per tuple
        (0.0 for lossless codecs)."""
        return 0.0 if not self.meta.lossy else None

    # -- convenience ---------------------------------------------------------
    @property
    def name(self) -> str:
        return self.meta.name

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """Single-shot encode + flush + decode from fresh state, on `x`'s
        device: int32[L, B] bits in, the reconstruction's int32[L, B] bits
        out (a stream-scope decode's one value per slot trimmed to B)."""
        lanes = x.shape[0]
        st_e = self.init_state(lanes, x.device)
        st_d = self.init_state(lanes, x.device)
        st_e, enc = self.encode(st_e, x)
        tail = self.flush(st_e)
        if tail is not None:
            enc = Encoded(torch.cat([enc.codes, tail.codes], dim=1), torch.cat([enc.bitlen, tail.bitlen], dim=1))
        _, xhat = self.decode(st_d, enc)
        return xhat[:, : x.shape[1]]


_REGISTRY: Dict[str, Callable[..., Codec]] = {}

def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def codec_factory(name: str) -> Callable[..., Codec]:
    """The registered factory for a codec name (capability introspection)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def accepted_params(name: str) -> Tuple[str, ...]:
    """Parameter names a codec's factory accepts, introspected from its
    signature (codecs without an `__init__` accept none)."""
    import inspect

    factory = codec_factory(name)
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return ()
    return tuple(
        p.name
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    )


def check_codec_params(name: str, kwargs) -> None:
    """Raise ValueError naming the codec and its accepted parameters when
    `kwargs` contains names the factory does not take."""
    allowed = accepted_params(name)
    unknown = sorted(set(kwargs) - set(allowed))
    if unknown:
        raise ValueError(
            f"codec {name!r} does not accept parameter(s) "
            f"{', '.join(map(repr, unknown))}; accepted: "
            f"{', '.join(allowed) if allowed else '(none)'}"
        )


def make_codec(name: str, **kwargs) -> Codec:
    factory = codec_factory(name)
    check_codec_params(name, kwargs)
    return factory(**kwargs)


def codec_names() -> Tuple[str, ...]:
    """Registered codec names, sorted for deterministic listings."""
    return tuple(sorted(_REGISTRY))
