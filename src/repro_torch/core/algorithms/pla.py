"""PLA: lossy model-state codec, piecewise linear approximation [31], [13]
(port of `repro/core/algorithms/pla.py`).

Two-level blockwise-parallel formulation: the stream is cut into
superwindows of 2W tuples. Each superwindow tries a single least-squares
line (72 bits for 2W tuples); failing that, each W half tries its own line
(72 bits per half); failing that, a half falls back to raw 32-bit values
(lossless for that window). All fits are closed-form and data-parallel.

Symbol layout per W-window (slot indices within the window):
  slot 0: flag byte + intercept-or-raw-value (40 bits)
  slot 1: slope (fit) or raw value (32 bits)
  slots 2..W-1: raw values (raw case only)
Flags: 0 = raw window, 1 = W-fit, 2 = 2W-fit (stored in the first half;
the second half of a 2W-fit emits nothing).

The intercept and slope bits go on the wire, and they come from float32
sums whose value depends on the order of the adds. So the fit sums in one
fixed order on every device, an explicit loop of elementwise adds over the
window axis from 0.0 (`_sum_window`), the order of XLA's CPU loop over the
reduced axis; and it computes the mean as the reference's jitted code does,
the sum times the float32 1/W. Frames on the card equal the CPU path's bit
for bit; agreement with the reference's is measured
(tests/test_torch_lossy.py).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register

#: the largest float32 below 2^32 that decoded predictions clip to
_TOP = 4294967040.0


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 words (int64 values) with the same bits."""
    return bits._u(x.to(torch.float32).view(torch.int32))


def _bits_f32(b: torch.Tensor) -> torch.Tensor:
    """uint32 words (any integer dtype) -> float32 with the same bits."""
    return bits._i32(b).view(torch.float32)


def _sum_window(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: ((0 + x0) + x1) + ..."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _line_fit(xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form least squares over the last axis: (intercept, slope,
    max_abs_err), in float32."""
    w = xs.shape[-1]
    t = torch.arange(w, dtype=torch.float32, device=xs.device)
    tm = (w - 1) / 2.0
    var_t = _sum_window((t - tm) ** 2)
    mean_x = _sum_window(xs)[..., None] * float(np.float32(1.0) / np.float32(w))
    slope = _sum_window((xs - mean_x) * (t - tm)) / var_t
    intercept = mean_x[..., 0] - slope * tm
    pred = intercept[..., None] + slope[..., None] * t
    err = (xs - pred).abs().amax(dim=-1)
    return intercept, slope, err


def _to_u32(pred: torch.Tensor) -> torch.Tensor:
    """Round a float32 prediction to the uint32 grid (int64 values)."""
    return torch.round(pred).clamp(0.0, _TOP).to(torch.int64)


@register("pla")
class PLA(Codec):
    # maskable: decode is a pure per-window function of the symbols (no
    # carried state), pads sit in a suffix so any window holding real tuples
    # keeps its parameter slots, and masked raw pads decode to 0 and are
    # trimmed by the frame's valid count
    meta = CodecMeta("pla", lossy=True, stateful=True, state_kind="model", aligned=True)

    def __init__(self, window: int = 16, eps: float = 8.0):
        assert window >= 4
        self.window = window
        self.eps = eps

    def error_bound(self) -> float:
        # fitted windows are accepted only at max-abs err <= eps; raw windows
        # are exact; rounding to the integer grid adds at most 1/2
        return self.eps + 0.5

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        lanes, b = x.shape
        w = self.window
        assert b % (2 * w) == 0, f"PLA batch {b} must be a multiple of 2*window {2 * w}"
        nsup = b // (2 * w)
        raw = bits._u(x).reshape(lanes, nsup, 2, w)
        xs1 = raw.to(torch.float32)  # halves
        i2, s2, e2 = _line_fit(xs1.reshape(lanes, nsup, 2 * w))  # superwindows
        i1, s1, e1 = _line_fit(xs1)
        eps = float(np.float32(self.eps))
        fit2 = e2 <= eps  # (L, nsup)
        fit1 = (e1 <= eps) & ~fit2[..., None]  # (L, nsup, 2)

        first = torch.tensor([True, False], device=x.device)
        # per-half parameters: the first half of a 2W-fit carries the 2W line
        flag = torch.where(fit2[..., None] & first, 2, torch.where(fit1, 1, 0))
        intercept = torch.where(fit2[..., None], i2[..., None], i1)
        slope = torch.where(fit2[..., None], s2[..., None], s1)
        is_fit = flag > 0  # this half emits line params
        in_fit2_tail = fit2[..., None] & ~first  # emits nothing

        payload0 = torch.where(is_fit, _f32_bits(intercept), raw[..., 0])
        c0 = raw.clone()
        c0[..., 0] = (flag | (payload0 << 8)) & bits.M32
        c0[..., 1] = torch.where(is_fit, _f32_bits(slope), raw[..., 1])
        c1 = torch.zeros_like(c0)
        c1[..., 0] = payload0 >> 24

        blen = torch.full((lanes, nsup, 2, w), 32, dtype=torch.int32, device=x.device)
        blen = torch.where(is_fit[..., None], 0, blen)  # fit: only slots 0-1
        blen[..., 0] = 40
        blen[..., 1] = torch.where(is_fit, 32, blen[..., 1])
        blen = torch.where(in_fit2_tail[..., None], 0, blen).to(torch.int32)  # tail of 2W fit

        codes = bits._i32(torch.stack([c0, c1], dim=-1)).reshape(lanes, b, 2)
        return state, Encoded(codes, blen.reshape(lanes, b))

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        lanes, b = enc.bitlen.shape
        w = self.window
        nsup = b // (2 * w)
        c0 = bits._u(enc.codes[..., 0]).reshape(lanes, nsup, 2, w)
        c1 = bits._u(enc.codes[..., 1]).reshape(lanes, nsup, 2, w)
        flag = c0[..., 0] & 0xFF  # (L, nsup, 2)
        payload0 = ((c0[..., 0] >> 8) | (c1[..., 0] << 24)) & bits.M32
        intercept = _bits_f32(payload0)
        slope = _bits_f32(c0[..., 1])

        t1 = torch.arange(w, dtype=torch.float32, device=c0.device)
        pred1 = intercept[..., None] + slope[..., None] * t1  # per-half line
        # the 2W line evaluated over both halves with the first half's params
        t2 = torch.arange(2 * w, dtype=torch.float32, device=c0.device).reshape(2, w)
        pred2 = intercept[..., 0:1, None] + slope[..., 0:1, None] * t2

        raw = c0.clone()
        raw[..., 0] = payload0
        fit2 = (flag[..., 0] == 2)[..., None, None]
        is_fit1 = (flag == 1)[..., None]
        out = torch.where(fit2, _to_u32(pred2), torch.where(is_fit1, _to_u32(pred1), raw))
        return state, bits._i32(out.reshape(lanes, b))
