"""Non-uniform quantization (NUQ), the lossy core shared by LEB128-NUQ,
UANUQ, ADPCM and UAADPCM (port of `repro/core/algorithms/nuq.py`).

The reference quantizes with the classic mu-law compander, a short float32
sequence per element: divide, multiply, `log1p` (encode) or `pow` (decode),
divide, round, clip. Its codecs and kernels run that sequence under `jit`,
where XLA folds every division by a constant into a multiplication by the
float32 reciprocal and merges chained constant factors: encode becomes
`round(log1p(v * (mu * 1/vmax)) * (1/log1p(mu) * levels))`, decode
`(pow(1 + mu, code * 1/levels) - 1) * (1/mu * vmax)`, each constant a
float32 product. Evaluating the sequence again per element, in torch on the
CPU or with CUDA's `log1pf`/`powf`, gives other float32 results for some
inputs, and in ADPCM one differing step forks every later code of its lane.
So the port evaluates it once per parameter tuple, on the host in numpy,
into two tables, and quantizes by table:

  * a decode table: the float32 value of every code;
  * an encode threshold table: for each code k >= 1, the smallest float32
    input whose code is k or more. Encoding is "count the thresholds <= v".

Both follow the folded op order. Decode takes `pow` from the C math
library's `powf`, the function XLA's CPU backend calls. Encode takes
`log1p` from `_xla_log1p_f32`, a float32 transcription of the `log1p` that
XLA's CPU backend inlines (its IR: Cephes' `logf` of 1 + x at |x| >=
0.41421357, else x - x^2/2 + x^3 P(x)/Q(x)). That function is not
correctly rounded, and the x86 backend fuses most of its multiply-add
pairs into FMAs because the host CPU has FMA; the transcription emulates
each fused pair with one rounding, as the object code does, and flushes
subnormal inputs to zero as XLA's CPU runtime does. So the reference's own
codes are those of an FMA host, and the tables equal them there. Every
step of the encoder is monotone in its input, so the thresholds are found
by bisection over float32 bit patterns. The plain versions on the CPU and
the CUDA kernels (`csrc/delta_nuq.cu`) read the same tables, so the two
devices agree bit for bit by construction, and with the reference where
`tests/test_torch_lossy.py` checks it (ROADMAP C2).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import bits

DEFAULT_MU = 255.0
#: largest code width the tables are built for (2^24 float32 entries each)
MAX_TABLE_BITS = 24

_F32 = np.float32
_F32_INF_BITS = 0x7F800000


def mulaw_max_abs_err(qbits: int, vmax: float, mu: float = DEFAULT_MU) -> float:
    """Hard max-abs reconstruction bound of the unsigned mu-law quantizer
    (for inputs within [0, vmax]; values above vmax clip unboundedly).

    Encode rounds y = F(v) to the nearest of `levels+1` grid points, so a
    value at the decision boundary y = (k + 1/2)/levels may land on level k
    OR k+1. Because F^-1 is convex, the up-rounding branch is the worse one:
    err <= max_k (x[k+1] - F^-1((k+1/2)/levels)), which exceeds the naive
    half-gap. Adds 1/2 for the snap to the integer grid.
    """
    levels = (1 << qbits) - 1

    def inv(y):
        return (np.power(1.0 + mu, y) - 1.0) / mu * float(vmax)

    x = inv(np.arange(levels + 1, dtype=np.float64) / levels)
    vb = inv((np.arange(levels, dtype=np.float64) + 0.5) / levels)
    worst = max(float(np.max(x[1:] - vb)), float(np.max(vb - x[:-1])))
    return worst + 0.5


def _check_bits(qbits: int) -> int:
    if not 1 <= qbits <= MAX_TABLE_BITS:
        raise ValueError(
            f"mu-law code width must be in [1, {MAX_TABLE_BITS}] bits (the port "
            f"quantizes by tables of 2^bits entries), got {qbits}"
        )
    return (1 << qbits) - 1


def _rcp(c: float) -> np.float32:
    """XLA's folding of a division by the constant c: the float32 1/c."""
    return _F32(1.0) / _F32(c)


@functools.lru_cache(maxsize=1)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib.powf


def _f32_bits(*words: int) -> np.ndarray:
    return np.array(words, np.uint32).view(_F32)


# XLA's CPU log1p, constants as float32 bit patterns. Cephes logf of u = 1 + x
# (its polynomial in three interleaved chains), then the series of the
# small branch (numerator and denominator by Horner, highest power first).
_LOGF_POLY = _f32_bits(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                       0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_SQRT_HALF, _LN2_LO, _LN2_HI, _SMALL_X = _f32_bits(0x3F3504F3, 0xB95E8083, 0x3F318000, 0x3ED413CD)
_MIN_NORMAL = _f32_bits(0x00800000)[0]
_LOG1P_P = _f32_bits(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
                     0x41A05101)
_LOG1P_Q = _f32_bits(0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                     0x42707982)


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 a*b + c rounded once, as x86's vfmadd. The product of two
    float32 is exact in float64; the float64 sum's rounding error (TwoSum)
    sets the sticky bit (round to odd), so the one rounding to float32 is
    correct (float64 carries more than 24 + 2 bits)."""
    a, b, c = (np.asarray(t, _F32).astype(np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(_F32)


def _xla_log1p_f32(x: np.ndarray) -> np.ndarray:
    """`jax.jit(jnp.log1p)` on the CPU for float32 `x`, bit for bit: the
    inlined `xla.log1p.f32`, op for op, with the multiply-add pairs the x86
    backend fuses (read from its object code) as single-rounding FMAs."""
    with np.errstate(all="ignore"):
        x = np.asarray(x, _F32)
        x = np.where(np.abs(x) < _MIN_NORMAL, x * _F32(0.0), x)  # subnormals flush
        # |x| >= 0.41421357: logf(u), mantissa m in [0.5, 1), u = m 2^e
        u = x + _F32(1.0)
        ub = np.maximum(u, _MIN_NORMAL).view(np.uint32)
        m = ((ub & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(_F32)
        lo = m < _SQRT_HALF
        e = ((ub >> 23).astype(np.int32) - 127).astype(_F32) + _F32(1.0)
        e = e - np.where(lo, _F32(1.0), _F32(0.0))
        z = (m + _F32(-1.0)) + np.where(lo, m, _F32(0.0))
        z2 = z * z
        z3 = z2 * z
        c = _LOGF_POLY
        r0 = _fma_f32(_fma_f32(z, c[0], c[1]), z, c[2])
        r1 = _fma_f32(_fma_f32(z, c[3], c[4]), z, c[5])
        r2 = _fma_f32(_fma_f32(z, c[6], c[7]), z, c[8])
        r = _fma_f32(_fma_f32(_fma_f32(r0, z3, r1), z3, r2), z3, e * _LN2_LO)
        y = _fma_f32(e, _LN2_HI, _fma_f32(-z2, _F32(0.5), z) + r)
        # u <= 0 or NaN: NaN (all ones); u == 0: -inf; u == inf: inf
        yb = np.where(u > 0, y.view(np.uint32), np.uint32(0xFFFFFFFF))
        yb = np.where((u != 0) & (u != np.inf), yb, np.uint32(0))
        yb |= np.where(u == 0, np.uint32(0xFF800000),
                       np.where(u == np.inf, np.uint32(0x7F800000), np.uint32(0)))
        # |x| < 0.41421357: x - x^2/2 + x^3 P(x)/Q(x)
        num, den = _LOG1P_P[0], _LOG1P_Q[0]
        for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
            num, den = _fma_f32(num, x, cp), _fma_f32(den, x, cq)
        x2 = x * x
        small = x + _fma_f32(x2, _F32(-0.5), (x * x2) * (num / den))
        return np.where(np.abs(x) < _SMALL_X, small, yb.view(_F32))


def emulate_encode(v: np.ndarray, qbits: int, vmax: float, mu: float = DEFAULT_MU) -> np.ndarray:
    """The reference's jitted unsigned mu-law encoder on float32 inputs
    `v`, step by step in float32 with its folded constants and XLA's CPU
    `log1p` (`_xla_log1p_f32`): int64 codes."""
    levels = _check_bits(qbits)
    scale = _rcp(vmax) * _F32(mu)
    gain = _rcp(_F32(np.log1p(np.float64(_F32(mu))))) * _F32(levels)
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.asarray(v, _F32) * scale
        y = _xla_log1p_f32(t) * gain
        return np.clip(np.round(y), 0, levels).astype(np.int64)


@functools.lru_cache(maxsize=None)
def decode_table(qbits: int, vmax: float, mu: float = DEFAULT_MU,
                 round_int: bool = True) -> np.ndarray:
    """float32[2^qbits]: the reference's jitted `mulaw_decode_unsigned` of
    every code, `pow` by the C library's `powf`. Read-only."""
    levels = _check_bits(qbits)
    powf = _libm_powf()
    base = float(_F32(1.0 + mu))
    y = np.arange(levels + 1, dtype=_F32) * _rcp(levels)
    p = np.array([powf(base, float(e)) for e in y], dtype=_F32)
    x = (p - _F32(1.0)) * (_rcp(mu) * _F32(vmax))
    if round_int:
        x = np.clip(np.round(x), _F32(0.0), _F32(vmax)).astype(_F32)
    x.setflags(write=False)
    return x


@functools.lru_cache(maxsize=None)
def encode_thresholds(qbits: int, vmax: float, mu: float = DEFAULT_MU) -> np.ndarray:
    """float32[2^qbits - 1]: entry k-1 is the smallest non-negative float32
    whose code is k or more, by bisection over float32 bit patterns (every
    step of the encoder is monotone). Read-only."""
    levels = _check_bits(qbits)
    k = np.arange(1, levels + 1, dtype=np.int64)
    lo = np.zeros(levels, np.int64)  # code(0.0) = 0 < k
    hi = np.full(levels, _F32_INF_BITS, np.int64)  # code(inf) = levels >= k
    while True:
        open_ = hi - lo > 1
        if not open_.any():
            break
        mid = (lo + hi) // 2
        ge = emulate_encode(mid.astype(np.uint32).view(_F32), qbits, vmax, mu) >= k
        hi = np.where(open_ & ge, mid, hi)
        lo = np.where(open_ & ~ge, mid, lo)
    thr = hi.astype(np.uint32).view(_F32)
    thr.setflags(write=False)
    return thr


_TORCH_TABLES: Dict[Tuple, torch.Tensor] = {}


def table_tensor(qbits: int, vmax: float, mu: float, round_int, device) -> torch.Tensor:
    """A table as a float32 tensor on `device`, cached per parameter tuple
    and device: the decode table for `round_int` True or False, the encode
    thresholds for `round_int=None`."""
    device = torch.device(device)
    key = (qbits, float(vmax), float(mu), round_int, device)
    t = _TORCH_TABLES.get(key)
    if t is None:
        table = (encode_thresholds(qbits, float(vmax), float(mu)) if round_int is None
                 else decode_table(qbits, float(vmax), float(mu), round_int))
        t = torch.from_numpy(table.copy()).to(device)
        _TORCH_TABLES[key] = t
    return t


def _as_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 values as given; uint32 words (int32 bits) converted, as
    the reference's `.astype(float32)` rounds them."""
    return v if v.dtype == torch.float32 else bits._u(v).to(torch.float32)


def mulaw_encode_unsigned(v: torch.Tensor, qbits: int, vmax: float,
                          mu: float = DEFAULT_MU) -> torch.Tensor:
    """Quantize unsigned values in [0, vmax] (float32, or uint32 words as
    int32 bits) to `qbits`-bit codes, int32."""
    thr = table_tensor(qbits, vmax, mu, None, v.device)
    return torch.searchsorted(thr, _as_f32(v), right=True).to(torch.int32)


def mulaw_decode_unsigned(code: torch.Tensor, qbits: int, vmax: float, mu: float = DEFAULT_MU,
                          round_int: bool = True) -> torch.Tensor:
    """Dequantize codes (int32, uint32 bits) to float32; `round_int=False`
    keeps the continuous value. A code above the top level (a corrupt
    leb128_nuq symbol) decodes as the top level, which is what the
    reference's clip to vmax gives with round_int."""
    table = table_tensor(qbits, vmax, mu, round_int, code.device)
    return table[bits._u(code).clamp(max=(1 << qbits) - 1)]


def signed_table(qbits: int, vmax: float, mu: float, round_int: bool, device) -> torch.Tensor:
    """float32[2^qbits]: the value of every signed code, a sign bit over a
    (qbits - 1)-bit magnitude (code s 2^(qbits-1) + m -> (-1)^s decode(m),
    -0.0 for the negative zero), cached like the tables."""
    device = torch.device(device)
    key = ("signed", qbits, float(vmax), float(mu), round_int, device)
    t = _TORCH_TABLES.get(key)
    if t is None:
        dec = decode_table(qbits - 1, float(vmax), float(mu), round_int)
        t = _TORCH_TABLES[key] = torch.from_numpy(np.concatenate([dec, -dec])).to(device)
    return t


def mulaw_encode_signed(d: torch.Tensor, qbits: int, dmax: float,
                        mu: float = DEFAULT_MU) -> torch.Tensor:
    """Quantize float32 values in [-dmax, dmax]: 1 sign bit + (qbits-1)
    magnitude bits, int32."""
    sign = (d < 0).to(torch.int32)
    mag = mulaw_encode_unsigned(d.abs(), qbits - 1, dmax, mu)
    return (sign << (qbits - 1)) | mag


def mulaw_decode_signed(code: torch.Tensor, qbits: int, dmax: float, mu: float = DEFAULT_MU,
                        round_int: bool = True) -> torch.Tensor:
    """Inverse of `mulaw_encode_signed` (float32; a set sign bit negates;
    bits above the code's qbits ignored), one gather from `signed_table`."""
    return signed_table(qbits, dmax, mu, round_int, code.device)[code.to(torch.int64) & ((1 << qbits) - 1)]


def to_u32_saturating(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 words (int32 bits), saturating as the reference's
    `.astype(uint32)` does on the CPU: negatives to 0, 2^32 and above to
    2^32 - 1. (A plain int64 cast masked to 32 bits would wrap 2^32 to 0.)"""
    return bits._i32(x.to(torch.int64).clamp(0, bits.M32))
