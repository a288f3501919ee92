"""B6/B7: block ADPCM (delta + mu-law NUQ) on the card (port of
`repro/kernels/delta_nuq.py`; CUDA source `csrc/delta_nuq.cu`).

Two forms of one recurrence. The Pallas contract over (S, T) float32 tiles
(`launch_tile_encode`, `launch_tile_decode`). The ADPCM codec's per-lane
form over a chunk of (C, L, B) blocks with carried state, by four kernels:
  * `launch_lane_encode`: the speculative segmented encode (segments of 64
    tuples, one thread each, started from a guess and resolved in rounds
    to the serial walk's codes, bit for bit);
  * `launch_lane_decode`: the clamp-add scan decode, inside the integer
    rule of `decode_kernel_for`;
  * `launch_lane_encode_serial`, `launch_lane_decode_serial`: one thread
    per lane walking its tuples in order. The serial decode takes what the
    rule leaves out; the serial encode is on no path (the card-side oracle
    of the speculative one).
`ops.adpcm_encode`, `adpcm_decode`, `adpcm_lane_encode`,
`adpcm_lane_decode` and the two `_serial` wrappers are the public entry
points, each counting its kernel's launches; `quantizer` gives the
host-built mu-law tables both the kernels and the plain versions read
(`core/algorithms/nuq.py`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import nuq
from repro_torch.kernels import build

DEFAULT_SUBLANES = 8
DEFAULT_T = 128
#: the codec form's kernels, by the `ops.WRAPPERS` entry that counts them
SPECULATIVE_ENCODE, SERIAL_ENCODE = "adpcm_lane_encode", "adpcm_lane_encode_serial"
SCAN_DECODE, SERIAL_DECODE = "adpcm_lane_decode", "adpcm_lane_decode_serial"
#: the largest vmax of the scan decode: float32 holds every integer up to it
MAX_SCAN_VMAX = 2**24
#: the speculative encode's tuples per segment (one thread), warm-up tuples
#: of a segment's guess and segments per CTA (csrc/delta_nuq.cu kSeg, kWarm,
#: kSpecThreads; for reports and the CPU emulation)
SEGMENT, WARMUP, SPEC_THREADS = 64, 32, 128


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


def decode_kernel_for(table: np.ndarray, vmax: float) -> str:
    """Which kernel decodes the codec form on CUDA, from the host-built
    dequantization table (`nuq.decode_table` of the magnitude, numpy) and
    vmax: the clamp-add scan when every table entry is an integer and vmax
    is an integer in [1, 2^24] that float32 holds exactly; the serial walk
    otherwise.

    Under the rule every state of the walk is an integer in [0, vmax]: each
    float32 add `xhat + dq` is of two integers, exact while the sum lies in
    [0, vmax] (within 2^24), and beyond a bound it rounds to a float no
    nearer than the bound and clips to it, so the walk equals its int32
    clamp-add maps. A carried state that is not an integer in [0, vmax] is
    checked on the card and its lane walked serially."""
    top = np.float32(vmax)
    if not (float(top) == float(vmax) and top == np.round(top) and 1 <= top <= MAX_SCAN_VMAX):
        return SERIAL_DECODE
    t = np.asarray(table, np.float32)
    return SCAN_DECODE if bool(np.all(np.isfinite(t) & (t == np.round(t)))) else SERIAL_DECODE


@functools.lru_cache(maxsize=None)
def lane_decode_kernel(qbits: int, vmax: float, dmax: float, mu: float) -> str:
    """`decode_kernel_for` the codec's parameters (cached per tuple)."""
    return decode_kernel_for(nuq.decode_table(qbits - 1, float(dmax), float(mu), True), vmax)


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


def _lane_encode_args(blocks, xhat, init, vmax, dmax, thr, dec, qbits, width, codes, bitlen):
    chunks, lanes, b = blocks.shape
    return (blocks.data_ptr(), chunks, lanes, b, xhat.data_ptr(), init.data_ptr(),
            u32_limit(vmax), f32(vmax), f32(dmax), thr.data_ptr(), dec.data_ptr(), qbits, width,
            codes.data_ptr(), bitlen.data_ptr())


def launch_lane_encode(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                       vmax: float, dmax: float, thr: torch.Tensor, dec: torch.Tensor,
                       qbits: int, width: int, codes: torch.Tensor,
                       bitlen: torch.Tensor) -> None:
    """The speculative encode: blocks int32[C, L, B], xhat float32[L] and
    init uint8[L] (updated in place) -> codes int32[C, L, B, 2], bitlen
    int32[C, L, B]."""
    lib = build.library()
    chunks, lanes, b = blocks.shape
    scratch = torch.zeros(lib.repro_adpcm_lane_encode_scratch(chunks, lanes, b),
                          dtype=torch.int32, device=blocks.device)
    err = lib.repro_adpcm_lane_encode(
        *_lane_encode_args(blocks, xhat, init, vmax, dmax, thr, dec, qbits, width, codes, bitlen),
        scratch.data_ptr(), _stream(blocks),
    )
    build.check(err, SPECULATIVE_ENCODE)


def launch_lane_encode_serial(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                              vmax: float, dmax: float, thr: torch.Tensor, dec: torch.Tensor,
                              qbits: int, width: int, codes: torch.Tensor,
                              bitlen: torch.Tensor) -> None:
    """`launch_lane_encode` by the serial walk, one thread per lane."""
    err = build.library().repro_adpcm_lane_encode_serial(
        *_lane_encode_args(blocks, xhat, init, vmax, dmax, thr, dec, qbits, width, codes, bitlen),
        _stream(blocks),
    )
    build.check(err, SERIAL_ENCODE)


def _lane_decode_args(codes, xhat, init, vmax, thr, dec, qbits, out):
    chunks, lanes, b, _ = codes.shape
    return (codes.data_ptr(), chunks, lanes, b, xhat.data_ptr(), init.data_ptr(), u32_limit(vmax),
            f32(vmax), thr.data_ptr(), dec.data_ptr(), qbits, out.data_ptr())


def launch_lane_decode(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                       vmax: float, thr: torch.Tensor, dec: torch.Tensor, qbits: int,
                       out: torch.Tensor) -> None:
    """The clamp-add scan decode (inside `decode_kernel_for`'s rule):
    codes int32[C, L, B, 2], xhat float32[L] and init uint8[L] (updated in
    place) -> out int32[C, L, B]."""
    lib = build.library()
    chunks, lanes = codes.shape[:2]
    scratch = torch.zeros(lib.repro_adpcm_lane_decode_scratch(chunks, lanes),
                          dtype=torch.int32, device=codes.device)
    err = lib.repro_adpcm_lane_decode(
        *_lane_decode_args(codes, xhat, init, vmax, thr, dec, qbits, out), scratch.data_ptr(),
        _stream(codes),
    )
    build.check(err, SCAN_DECODE)


def launch_lane_decode_serial(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                              vmax: float, thr: torch.Tensor, dec: torch.Tensor, qbits: int,
                              out: torch.Tensor) -> None:
    """`launch_lane_decode` by the serial walk, for any parameters."""
    err = build.library().repro_adpcm_lane_decode_serial(
        *_lane_decode_args(codes, xhat, init, vmax, thr, dec, qbits, out), _stream(codes),
    )
    build.check(err, SERIAL_DECODE)
