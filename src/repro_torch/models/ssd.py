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
h_t = exp(dt A) h_{t-1} + dt B x. The intra-chunk decay masks its exponent
before the exponential: the reference masks the exponential's output, and
above the diagonal the exponent is positive, up to ~400 at mamba2-1.3b's
chunk of 256, so exp overflows there and the gradient of dt and A through
the mask is NaN (0 x inf); the forward values are the same.

Plain torch, no kernel: the reference computes SSD in jnp, and no Pallas
kernel of its reaches it.

Tensor parallelism (`mamba2_group`, a model group of n slots,
`models/partition.py`): a slot holds 1/n of `in_proj`'s columns, of the
conv's channels (`conv_w` and its `conv_tail` shard) and of `out_proj`'s
rows, and the state of its nh / n heads (`ssm_state`'s shard). The even
shards of the projection and of the conv do not line up with the z | xBC |
dt segments or with the heads, so the slots' projections are all-gathered,
each slot runs the conv on its channels against its tail, the activations
are all-gathered again after the SiLU, and each slot scans its heads (its
x and dt, the whole B and C of the one group) into its state shard. The
gated RMSNorm normalises over the whole d_inner: a `psum` of the slots'
sums of squares. `out_proj`'s row shards give partial sums (`psum`).

On `meta` with gradients off (the dry run's prefill) the chunk loop runs
one chunk under `partition.repeated(n_chunks)`: the trips do the same work.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.models import partition
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
    trips = s // chunk
    if xh.device.type == "meta" and not torch.is_grad_enabled() and trips > 1:
        # shapes only: one chunk stands for every trip (the dry run)
        with partition.repeated(trips):
            y, h = _ssd_chunk_scan(xh[:, :chunk], dt[:, :chunk], a, bm[:, :chunk], cm[:, :chunk], h0, chunk)
        return torch.cat([y] * trips, dim=1), h
    for c in range(trips):
        blk = slice(c * chunk, (c + 1) * chunk)
        x_b, dt_b, b_b, c_b = xh[:, blk], dt[:, blk], bm[:, blk], cm[:, blk]
        inc = torch.cumsum(dt_b * a, dim=1)  # (B, c, G, E), inclusive within the chunk
        # carry-in: C . H, decayed from the chunk's start to t
        y0 = torch.einsum("btgn,bgepn->btgep", c_b, h) * torch.exp(inc)[..., None]
        # the duality inside the chunk: (C B^T) * L * dt, then against x
        cb = torch.einsum("btgn,bugn->btug", c_b, b_b)  # (B, t, u, G)
        # (B, t, u, G, E): the exponent masked above the diagonal, where it is
        # positive and overflows at a full chunk (exp(-inf) = 0 there, as the
        # reference's masked product is; a masked exp(inf) would turn the
        # backward's 0 into NaN)
        seg = inc[:, :, None] - inc[:, None, :]
        decay = torch.exp(torch.where(tri[None, :, :, None, None], seg, torch.full((), -math.inf, device=xh.device)))
        w = cb[..., None] * decay * dt_b[:, None]  # (B, t, u, G, E)
        y_diag = torch.einsum("btuge,bugep->btgep", w, x_b)
        # the chunk's out-state
        decay_out = torch.exp(inc[:, -1:] - inc) * dt_b  # (B, c, G, E)
        h = (torch.exp(inc[:, -1])[..., None, None] * h
             + torch.einsum("bugn,bugep->bgepn", b_b, decay_out[..., None] * x_b))
        ys.append(y0 + y_diag)
    return torch.cat(ys, dim=1).reshape(b, s, g, e, p), h


def _ssd_heads(xh, dt, a, bm, cm, d_skip, h0, chunk: Optional[int]):
    """The SSD of some heads, float32, with the D skip: xh (B, S, G, E, P)
    in the compute dtype, dt (B, S, G, E), a and d_skip (G, E), bm/cm (B,
    S, G, N) float32, h0 (B, G, E, P, N). `chunk` None is one token's O(1)
    update (S = 1); else the chunked scan, a ragged last chunk padded with
    dt = 0 (no decay, no input), as the reference pads it. Returns y (B, S,
    G, E, P) and the last state. The whole block runs it on every head, a
    model slot of `mamba2_group` on its own."""
    x32 = xh.to(torch.float32)
    if chunk is None:
        x1, dt1 = x32[:, 0], dt[:, 0]
        h = torch.exp(dt1 * a)[..., None, None] * h0 + (dt1[..., None] * x1)[..., None] * bm[:, 0, :, None, None, :]
        y = torch.einsum("bgn,bgepn->bgep", cm[:, 0], h)[:, None]
    else:
        s = xh.shape[1]
        pad = (-s) % chunk
        xp, bp, cp, dp = x32, bm, cm, dt
        if pad:
            xp = F.pad(xp, (0, 0, 0, 0, 0, 0, 0, pad))
            bp = F.pad(bp, (0, 0, 0, 0, 0, pad))
            cp = F.pad(cp, (0, 0, 0, 0, 0, pad))
            dp = F.pad(dp, (0, 0, 0, 0, 0, pad))
        y, h = _ssd_chunk_scan(xp, dp, a, bp, cp, h0, chunk)
        y = y[:, :s]
    return y + d_skip[None, None, :, :, None] * x32, h


def mamba2_apply(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_tail: Optional[torch.Tensor] = None, decode: bool = False):
    """The Mamba2 block over a sequence: x (B, S, D) -> (y, ssm_state,
    conv_tail); ssm_state (B, G, E, P, N) float32, conv_tail (B, W-1,
    conv_dim). `decode`: one token's O(1) update (S = 1)."""
    b, s, _ = x.shape
    di, n, g, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_head_dim
    e = nh // g
    f32 = torch.float32
    z, xbc_pre, dt_raw = _split_proj(params, cfg, x)
    xbc, new_tail = causal_conv1d(xbc_pre, params["conv_w"], params["conv_b"], conv_tail)
    xbc = _silu(xbc.to(f32)).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, g, e, p)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n).to(f32)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n).to(f32)
    dt = softplus(dt_raw.to(f32) + params["dt_bias"]).reshape(b, s, g, e)
    a = -torch.exp(params["A_log"]).reshape(g, e)
    y, h_last = _ssd_heads(xs, dt, a, bm, cm, params["D"].reshape(g, e), ssm_state,
                           None if decode else min(cfg.ssm_chunk, s))
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * _silu(z.to(f32)).to(x.dtype), params["norm"])
    return y @ params["out_proj"], h_last, new_tail


def mamba2_decode(params: Mapping[str, torch.Tensor], cfg, x_t: torch.Tensor, ssm_state: torch.Tensor,
                  conv_tail: torch.Tensor):
    """One token: x_t (B, 1, D) -> (y (B, 1, D), ssm_state, conv_tail), the
    O(1) update."""
    return mamba2_apply(params, cfg, x_t, ssm_state, conv_tail, decode=True)


# ----------------------------------------------------- tensor parallelism --
def _slot_heads(cfg, n: int, i: int):
    """Slot i's SSD heads [h0, h1) of n slots: its rows of `out_proj` are
    theirs, so nh must divide over the slots (and one group holds them)."""
    nh = cfg.ssm_heads
    if nh % n or cfg.ssm_groups != 1:
        raise ValueError(f"{nh} SSD heads in {cfg.ssm_groups} groups do not split over {n} model slots "
                         f"(the split takes one group, and heads that divide the slots)")
    return i * nh // n, (i + 1) * nh // n


def mamba2_group(g, ps, cfg, xs, ssm_states=None, conv_tails=None, decode: bool = False):
    """The Mamba2 block over a model group (see the module's docstring):
    xs[i] (B, S, D) replicated on slot i, ps[i] the slot's parameters (its
    model shards of `in_proj`, `conv_w`, `out_proj`; the replicated
    per-channel and per-head leaves whole, of which it takes its slice),
    ssm_states[i] (B, 1, nh / n, P, N) and conv_tails[i] (B, W-1, conv_dim
    / n) its state shards (zeros when None). `decode`: one token's O(1)
    update (S = 1). Returns (ys, each slot's new state and tail); ys[i]
    (B, S, D) the replicated output."""
    n = g.n
    di, nst, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    cw = conv_dim(cfg) // n
    if conv_dim(cfg) % n:
        raise ValueError(f"{conv_dim(cfg)} conv channels do not split over {n} model slots")
    heads = [_slot_heads(cfg, n, i) for i in range(n)]
    none = [None] * n
    zx = compat.all_gather(g.map(lambda i, x, pp: x @ pp["in_proj"], xs, ps), g.devices, dim=-1)

    def conv(i, z, pp, tail):
        lo = di + i * cw
        y, new_tail = causal_conv1d(z[..., lo:lo + cw], pp["conv_w"], pp["conv_b"][i * cw:(i + 1) * cw], tail)
        return _silu(y.to(f32)).to(z.dtype), new_tail

    convs = g.map(conv, zx, ps, conv_tails or none)
    xbc = compat.all_gather([c[0] for c in convs], g.devices, dim=-1)

    def mix(i, z, xb, pp, h0):
        h_lo, h_hi = heads[i]
        b, s = z.shape[:2]
        e = h_hi - h_lo
        xh = xb[..., h_lo * p:h_hi * p].reshape(b, s, 1, e, p)
        bm = xb[..., di:di + nst].reshape(b, s, 1, nst).to(f32)
        cm = xb[..., di + nst:di + 2 * nst].reshape(b, s, 1, nst).to(f32)
        dt_raw = z[..., 2 * di + 2 * nst + h_lo:2 * di + 2 * nst + h_hi]
        dt = softplus(dt_raw.to(f32) + pp["dt_bias"][h_lo:h_hi]).reshape(b, s, 1, e)
        a = -torch.exp(pp["A_log"][h_lo:h_hi]).reshape(1, e)
        if h0 is None:
            h0 = torch.zeros((b, 1, e, p, nst), dtype=f32, device=z.device)
        y, h = _ssd_heads(xh, dt, a, bm, cm, pp["D"][h_lo:h_hi].reshape(1, e), h0,
                          None if decode else min(cfg.ssm_chunk, s))
        y = y.reshape(b, s, e * p).to(z.dtype)
        return y * _silu(z[..., h_lo * p:h_hi * p].to(f32)).to(z.dtype), h

    mixed = g.map(mix, zx, xbc, ps, ssm_states or none)
    # the gated RMSNorm over the whole d_inner: the slots' sums of squares
    sq = compat.psum(g.map(lambda i, m: torch.sum(torch.square(m[0].to(f32)), dim=-1, keepdim=True), mixed),
                     g.devices)

    def out(i, m, ss, pp):
        h_lo, h_hi = heads[i]
        y = m[0].to(f32) * torch.rsqrt(ss / di + 1e-6)
        y = (y * (1.0 + pp["norm"][h_lo * p:h_hi * p].to(f32))).to(m[0].dtype)
        return y @ pp["out_proj"]

    ys = compat.psum(g.map(out, mixed, sq, ps), g.devices)
    return ys, [m[1] for m in mixed], [c[1] for c in convs]


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
