"""B6/B7: block ADPCM (delta + mu-law NUQ) on the card (port of
`repro/kernels/delta_nuq.py`; CUDA source `csrc/delta_nuq.cu`).

Two forms of one recurrence, each with an encode and a decode entry point:
the Pallas contract over (S, T) float32 tiles (`launch_tile_encode`,
`launch_tile_decode`) and the ADPCM codec's per-lane form over a chunk of
(C, L, B) blocks with carried state (`launch_lane_encode`,
`launch_lane_decode`). `ops.adpcm_encode`, `adpcm_decode`,
`adpcm_lane_encode` and `adpcm_lane_decode` are the public wrappers;
`quantizer` gives the host-built mu-law tables both the kernels and the
plain versions read (`core/algorithms/nuq.py`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import nuq
from repro_torch.kernels import build

DEFAULT_SUBLANES = 8
DEFAULT_T = 128


def quantizer(qbits: int, dmax: float, mu: float, round_int: bool,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(thresholds float32[levels], decode values float32[levels + 1]) of
    the signed quantizer's (qbits - 1)-bit magnitude on `device`. The
    Pallas contract dequantizes without integer snapping (round_int=False),
    the codec with it."""
    return (
        nuq.table_tensor(qbits - 1, dmax, mu, None, device),
        nuq.table_tensor(qbits - 1, dmax, mu, round_int, device),
    )


def f32(v: float) -> float:
    """A parameter as the float32 the reference computes with."""
    return float(np.float32(v))


def u32_limit(vmax: float) -> int:
    """The codec's integer input clip, `uint32(int(vmax))`."""
    return min(int(vmax), 0xFFFFFFFF)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_tile_encode(x: torch.Tensor, t_tile: int, dmax: float, thr: torch.Tensor,
                       dec: torch.Tensor, qbits: int, codes: torch.Tensor) -> None:
    """x float32[S, T] -> codes int32[S, T] (uint32 bits)."""
    rows, t = x.shape
    err = build.library().repro_adpcm_tile_encode(
        x.data_ptr(), rows, t, t_tile, f32(dmax), thr.data_ptr(), dec.data_ptr(), qbits,
        codes.data_ptr(), _stream(x),
    )
    build.check(err, "adpcm_encode")


def launch_tile_decode(codes: torch.Tensor, t_tile: int, thr: torch.Tensor,
                       dec: torch.Tensor, qbits: int, x: torch.Tensor) -> None:
    """codes int32[S, T] -> x float32[S, T]."""
    rows, t = codes.shape
    err = build.library().repro_adpcm_tile_decode(
        codes.data_ptr(), rows, t, t_tile, thr.data_ptr(), dec.data_ptr(), qbits,
        x.data_ptr(), _stream(codes),
    )
    build.check(err, "adpcm_decode")


def launch_lane_encode(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                       vmax: float, dmax: float, thr: torch.Tensor, dec: torch.Tensor,
                       qbits: int, width: int, codes: torch.Tensor,
                       bitlen: torch.Tensor) -> None:
    """blocks int32[C, L, B], xhat float32[L] and init uint8[L] (updated in
    place) -> codes int32[C, L, B, 2], bitlen int32[C, L, B]."""
    chunks, lanes, b = blocks.shape
    err = build.library().repro_adpcm_lane_encode(
        blocks.data_ptr(), chunks, lanes, b, xhat.data_ptr(), init.data_ptr(),
        u32_limit(vmax), f32(vmax), f32(dmax), thr.data_ptr(), dec.data_ptr(), qbits, width,
        codes.data_ptr(), bitlen.data_ptr(), _stream(blocks),
    )
    build.check(err, "adpcm_lane_encode")


def launch_lane_decode(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                       vmax: float, thr: torch.Tensor, dec: torch.Tensor, qbits: int,
                       out: torch.Tensor) -> None:
    """codes int32[C, L, B, 2], xhat float32[L] and init uint8[L] (updated
    in place) -> out int32[C, L, B]."""
    chunks, lanes, b, _ = codes.shape
    err = build.library().repro_adpcm_lane_decode(
        codes.data_ptr(), chunks, lanes, b, xhat.data_ptr(), init.data_ptr(), u32_limit(vmax),
        f32(vmax), thr.data_ptr(), dec.data_ptr(), qbits, out.data_ptr(), _stream(codes),
    )
    build.check(err, "adpcm_lane_decode")
