"""ADPCM / UAADPCM: lossy value-state codecs (port of
`repro/core/algorithms/adpcm.py`; paper §3.1.4).

ADPCM quantizes the *prediction error* against the reconstructed previous
value, so quantization error cannot accumulate: a true sequential
recurrence (the quantizer is nonlinear). Parallelism comes from lanes: each
lane runs its own substream with private reconstruction state, the paper's
private-state parallelization. On a CUDA device one call of kernel B6/B7
in its codec form (`ops.adpcm_lane_encode` / `adpcm_lane_decode`) covers a
whole chunk of blocks: the encode walks each lane in speculative segments
resolved to the serial walk's codes, the decode scans clamp-add maps
(serially outside `kernels/delta_nuq.py: decode_kernel_for`'s integer
rule); on the CPU the wrappers run the plain per-lane scan. The mu-law
quantizer is the host-built tables of `nuq.py`.

Values are treated as magnitudes in [0, vmax] (float32 internally: exact
for the <=24-bit sensor ranges the paper's datasets use).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import nuq
from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register
from repro_torch.kernels import ops


class _ADPCMBase(Codec):
    state_dtypes = {"xhat": np.dtype(np.float32), "init": np.dtype(np.bool_)}

    def __init__(
        self,
        qbits: int = 8,
        vmax: float = float(2**24),
        mu: float = nuq.DEFAULT_MU,
        dmax: float | None = None,
    ):
        self.qbits = qbits
        self.vmax = vmax
        self.mu = mu
        # delta-quantizer range; calibrated separately from the value range
        # (slope-overload clipping recovers via error feedback, as in
        # classic ADPCM)
        self.dmax = float(dmax) if dmax is not None else vmax / 8.0

    def _bitlen(self) -> int:
        raise NotImplementedError

    def init_state(self, lanes: int, device: torch.device):
        # `init` False => the first symbol of the lane is the raw 32-bit
        # reference sample (classic ADPCM predictor bootstrap; avoids
        # slope-overload from a cold xhat=0 start).
        return {
            "xhat": torch.zeros((lanes,), dtype=torch.float32, device=device),
            "init": torch.zeros((lanes,), dtype=torch.bool, device=device),
        }

    def encode_blocks(self, state: Any, blocks: torch.Tensor,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, Encoded]:
        """C blocks `(C, L, B)` in one B6 launch: the recurrence is per lane,
        so one walk of each lane's C*B tuples equals C sequential calls."""
        if merge is not None:
            raise ValueError(f"codec {self.name!r} has no per-block state merge")
        codes, bitlen, xhat, init = ops.adpcm_lane_encode(
            blocks.to(torch.int32).contiguous(), state["xhat"], state["init"],
            self.qbits, self.vmax, self.dmax, self.mu, self._bitlen(),
        )
        return {"xhat": xhat, "init": init}, Encoded(codes, bitlen)

    def decode_blocks(self, state: Any, enc: Encoded,
                      merge: Optional[Callable[[Any], Any]] = None) -> Tuple[Any, torch.Tensor]:
        """`encode_blocks`' inverse in one B7 launch: codes `(C, L, B, 2)`
        -> values `(C, L, B)`."""
        if merge is not None:
            raise ValueError(f"codec {self.name!r} has no per-block state merge")
        x, xhat, init = ops.adpcm_lane_decode(
            enc.codes.contiguous(), state["xhat"], state["init"],
            self.qbits, self.vmax, self.dmax, self.mu,
        )
        return {"xhat": xhat, "init": init}, x

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        state, enc = self.encode_blocks(state, x[None])
        return state, Encoded(enc.codes[0], enc.bitlen[0])

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        state, x = self.decode_blocks(state, Encoded(enc.codes[None], enc.bitlen[None]))
        return state, x[0]


@register("adpcm")
class ADPCM(_ADPCMBase):
    # not maskable: decode replays xhat from the delta codes themselves, so
    # pad symbols must travel on the wire to keep encoder/decoder state equal
    meta = CodecMeta(
        "adpcm", lossy=True, stateful=True, state_kind="value", aligned=True,
        maskable=False,
    )

    def _bitlen(self) -> int:
        return 8 * ((self.qbits + 7) // 8)


@register("uaadpcm")
class UAADPCM(_ADPCMBase):
    meta = CodecMeta(
        "uaadpcm", lossy=True, stateful=True, state_kind="value", aligned=False,
        maskable=False,
    )

    def _bitlen(self) -> int:
        return self.qbits
