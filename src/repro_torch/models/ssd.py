"""Mamba2 SSD (state-space duality) block, the attention-free sequence
mixer (port of `repro/models/ssd.py`).

Prefill and training run the chunked SSD algorithm: the sequence is cut
into chunks of `cfg.ssm_chunk`; inside a chunk the recurrence is a small
masked "attention" (the duality), and the chunk states pass from one chunk
to the next in a Python loop, the reference's `lax.scan` (its
`jax.checkpoint` of the body only saves memory). The reference's
four-operand einsums are written here as explicit pairwise products: a
contraction order that formed (B, t, u, G, E, P) would take 4.3 GB a chunk
at mamba2-1.3b's width. Decode is the O(1) recurrence
h_t = exp(dt A) h_{t-1} + dt B x.

Plain torch, no kernel: the reference computes SSD in jnp, and no Pallas
kernel of its reaches it.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Storage, _Params
from repro_torch.models.rglru import causal_conv1d, softplus


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`, x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _split_proj(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor):
    """x (B, S, D) -> z (B, S, di), xBC (B, S, conv_dim), dt_raw (B, S, nh)."""
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    zxbcdt = x @ params["in_proj"]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * n], zxbcdt[..., 2 * di + 2 * g * n:]


def _ssd_chunk_scan(xh, dt, a, bm, cm, h0, chunk: int):
    """Chunked SSD over a whole sequence, float32.

    xh (B, S, G, E, P), dt (B, S, G, E), a (G, E), bm/cm (B, S, G, N), h0
    (B, G, E, P, N); S a multiple of `chunk`. Returns y (B, S, G, E, P) and
    the last state. E = heads per group."""
    b, s, g, e, p = xh.shape
    n = bm.shape[-1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    h = h0
    ys = []
    for c in range(s // chunk):
        blk = slice(c * chunk, (c + 1) * chunk)
        x_b, dt_b, b_b, c_b = xh[:, blk], dt[:, blk], bm[:, blk], cm[:, blk]
        inc = torch.cumsum(dt_b * a, dim=1)  # (B, c, G, E), inclusive within the chunk
        # carry-in: C . H, decayed from the chunk's start to t
        y0 = torch.einsum("btgn,bgepn->btgep", c_b, h) * torch.exp(inc)[..., None]
        # the duality inside the chunk: (C B^T) * L * dt, then against x
        cb = torch.einsum("btgn,bugn->btug", c_b, b_b)  # (B, t, u, G)
        decay = torch.exp(inc[:, :, None] - inc[:, None, :])  # (B, t, u, G, E)
        decay = torch.where(tri[None, :, :, None, None], decay, torch.zeros((), device=xh.device))
        w = cb[..., None] * decay * dt_b[:, None]  # (B, t, u, G, E)
        y_diag = torch.einsum("btuge,bugep->btgep", w, x_b)
        # the chunk's out-state
        decay_out = torch.exp(inc[:, -1:] - inc) * dt_b  # (B, c, G, E)
        h = (torch.exp(inc[:, -1])[..., None, None] * h
             + torch.einsum("bugn,bugep->bgepn", b_b, decay_out[..., None] * x_b))
        ys.append(y0 + y_diag)
    return torch.cat(ys, dim=1).reshape(b, s, g, e, p), h


def mamba2_apply(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_tail: Optional[torch.Tensor] = None):
    """The Mamba2 block over a sequence: x (B, S, D) -> (y, ssm_state,
    conv_tail); ssm_state (B, G, E, P, N) float32, conv_tail (B, W-1,
    conv_dim). A ragged last chunk is padded with dt = 0 (no decay, no
    input), as the reference pads it."""
    b, s, _ = x.shape
    di, n, g, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_head_dim
    e = nh // g
    f32 = torch.float32
    z, xbc_pre, dt_raw = _split_proj(params, cfg, x)
    xbc, new_tail = causal_conv1d(xbc_pre, params["conv_w"], params["conv_b"], conv_tail)
    xbc = _silu(xbc.to(f32)).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, g, e, p)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = softplus(dt_raw.to(f32) + params["dt_bias"]).reshape(b, s, g, e)
    a = -torch.exp(params["A_log"]).reshape(g, e)

    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    xs32, bm32, cm32 = xs.to(f32), bm.to(f32), cm.to(f32)
    if pad:
        xs32 = F.pad(xs32, (0, 0, 0, 0, 0, 0, 0, pad))
        bm32 = F.pad(bm32, (0, 0, 0, 0, 0, pad))
        cm32 = F.pad(cm32, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, 0, 0, pad))
    y, h_last = _ssd_chunk_scan(xs32, dt, a, bm32, cm32, ssm_state, chunk)
    y = y[:, :s] + params["D"].reshape(g, e)[None, None, :, :, None] * xs.to(f32)
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * _silu(z.to(f32)).to(x.dtype), params["norm"])
    return y @ params["out_proj"], h_last, new_tail


def mamba2_decode(params: Mapping[str, torch.Tensor], cfg, x_t: torch.Tensor, ssm_state: torch.Tensor,
                  conv_tail: torch.Tensor):
    """One token: x_t (B, 1, D) -> (y (B, 1, D), ssm_state, conv_tail), the
    O(1) update."""
    b = x_t.shape[0]
    di, n, g, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_head_dim
    e = nh // g
    f32 = torch.float32
    z, xbc_pre, dt_raw = _split_proj(params, cfg, x_t)
    xbc, new_tail = causal_conv1d(xbc_pre, params["conv_w"], params["conv_b"], conv_tail)
    xbc = _silu(xbc.to(f32)).to(x_t.dtype)
    xs = xbc[..., :di].reshape(b, g, e, p).to(f32)
    bm = xbc[..., di:di + g * n].reshape(b, g, n).to(f32)
    cm = xbc[..., di + g * n:].reshape(b, g, n).to(f32)
    dt = softplus(dt_raw[:, 0].to(f32) + params["dt_bias"]).reshape(b, g, e)
    a = -torch.exp(params["A_log"]).reshape(g, e)

    decay = torch.exp(dt * a)  # (B, G, E)
    h = decay[..., None, None] * ssm_state + (dt[..., None] * xs)[..., None] * bm[:, :, None, None, :]
    y = torch.einsum("bgn,bgepn->bgep", cm, h) + params["D"].reshape(g, e)[None, :, :, None] * xs
    y = y.reshape(b, 1, di).to(x_t.dtype)
    y = rms_norm(y * _silu(z.to(f32)).to(x_t.dtype), params["norm"])
    return y @ params["out_proj"], h, new_tail


def init_ssm_state(batch: int, cfg, device=None) -> torch.Tensor:
    g, e, p, n = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups, cfg.ssm_head_dim, cfg.ssm_state
    return torch.zeros((batch, g, e, p, n), dtype=torch.float32, device=device)


def conv_dim(cfg) -> int:
    """Channels of the block's causal conv: x, B and C."""
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


class Mamba2(_Params):
    """The block's parameters under the reference's names: `in_proj` (D,
    2 di + 2 G N + nh), `conv_w` (W, conv_dim), `conv_b`, `A_log`, `D`,
    `dt_bias` (nh,), `norm` (di,), `out_proj` (di, D)."""

    def __init__(self, cfg, store: Storage):
        super().__init__(store)
        di, nh = cfg.d_inner, cfg.ssm_heads
        self._add("in_proj", (cfg.d_model, 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + nh))
        self._add("conv_w", (cfg.conv_width, conv_dim(cfg)))
        self._add("conv_b", (conv_dim(cfg),))
        self._add("A_log", (nh,))
        self._add("D", (nh,))
        self._add("dt_bias", (nh,))
        self._add("norm", (di,))
        self._add("out_proj", (di, cfg.d_model))

    @torch.no_grad()
    def draw_(self, gen: torch.Generator) -> None:
        """The reference's own distributions where the dense rule does not
        hold: `conv_w` N(0, 1) x 0.1; A ~ U(1, 16), `A_log` = log A; `D` = 1;
        dt0 = exp(U(0, 1) (log 0.1 - log 0.001) + log 0.001), `dt_bias` its
        inverse softplus dt0 + log(-expm1(-dt0)). Drawn in float32 on the
        parameters' device."""
        dev = self.D.device
        nh = self.D.shape[0]
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=gen, device=dev) * 0.1)
        a = 1.0 + 15.0 * torch.rand((nh,), generator=gen, device=dev)
        self.A_log.copy_(torch.log(a))
        self.D.fill_(1.0)
        dt0 = torch.exp(torch.rand((nh,), generator=gen, device=dev) * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
        self.dt_bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
