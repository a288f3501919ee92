"""RG-LRU recurrent block (RecurrentGemma / Griffin) and the causal
depthwise conv (port of `repro/models/rglru.py`).

The linear recurrence h_t = a_t * h_{t-1} + b_t runs as the reference's
`jax.lax.associative_scan` does: `_lru_scan` transcribes jax's odd/even
recursion on torch slices, so the float32 products are formed in the
reference's order and a sequence of S positions costs about 2 log2(S)
elementwise levels, not S steps. (A cumulative-product shortcut,
A_t * cumsum(b / A), would underflow float32 at S = 4,096.) Decode carries
(h, conv tail) as O(1) state through the same `rglru_apply`.

Plain torch, no kernel: the reference computes the block in jnp, and no
Pallas kernel of its reaches it.

Tensor parallelism (`rglru_group`, a model group of n slots,
`models/partition.py`): a slot holds 1/n of the columns of `w_in_x`,
`w_in_gate`, `w_a` and `w_x`, of the conv's channels (`conv_w` and its
`conv_tail` shard) and of `w_out`'s rows, and the RG-LRU state `h` of its
R / n channels. Its in-projections give its channels of `xb` and of the
gate, and the conv runs per channel against its tail; `w_a` and `w_x` take
every channel of `xb`, which is all-gathered; the scan runs on the slot's
channels into its `h` shard, and `w_out`'s row shards give partial sums
(`compat.psum`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.models.params import Storage, _Params

C_SCALE = 8.0  # Griffin's fixed temperature on the recurrence gate


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (its default, the tanh approximation), op for op."""
    c = float(np.sqrt(2 / np.pi).astype(np.float32))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3)))))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as `logaddexp(x, 0)`."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, R), w (W, R), b (R,); `tail` (B, W-1,
    R) carries the previous call's last inputs (zeros when None): (y in x's
    dtype, the new tail)."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    return y.to(x.dtype), xp[:, -(width - 1):]


def _combine(a_l, b_l, a_r, b_r):
    return a_l * a_r, b_l * a_r + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (even may hold one
    more)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def _scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax's `associative_scan._scan` over dim 1 for the combine
    (a_l a_r, b_l a_r + b_r): pairs reduced, the half scanned by recursion,
    the even elements from the odd ones."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ev_a, ev_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def _lru_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t over dim 1 from h0 (B, R): h (B, S, R)."""
    a_cum, h = _scan(a, bx)
    return h + a_cum * h0[:, None, :]


def _project(x: torch.Tensor, p: Mapping[str, torch.Tensor], conv_b: torch.Tensor,
             tail: Optional[torch.Tensor]):
    """The in-projections of x (B, S, D) on `p`'s columns and the causal
    conv of their channels (bias `conv_b`): (gate, xb, the new conv tail)."""
    gate = gelu_tanh((x @ p["w_in_gate"]).to(torch.float32)).to(x.dtype)
    xb, new_tail = causal_conv1d(x @ p["w_in_x"], p["conv_w"], conv_b, tail)
    return gate, xb, new_tail


def _gated_scan(xa: torch.Tensor, xb: torch.Tensor, gate: torch.Tensor, h0: torch.Tensor,
                p: Mapping[str, torch.Tensor], sl: slice = slice(None)):
    """The RG-LRU on the channels `sl` and the gated out-projection: the
    gates r and i from xa (B, S, R), every channel of the conv's output,
    against `p`'s columns of `w_a`/`w_x` and its `sl` slice of `b_a`, `b_x`
    and `lam`; the scan of xb (the channels `sl`) from h0, gated, against
    `p`'s rows of `w_out`: (y (B, S, D), h_last float32)."""
    f32 = torch.float32
    r = torch.sigmoid((xa @ p["w_a"] + p["b_a"][sl]).to(f32))
    i = torch.sigmoid((xa @ p["w_x"] + p["b_x"][sl]).to(f32))
    a = torch.exp(-C_SCALE * r * softplus(p["lam"][sl]))  # a_t (B, S, R)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.to(f32))
    h = _lru_scan(a, bx, h0.to(f32))
    return (h.to(xb.dtype) * gate) @ p["w_out"], h[:, -1, :]


def rglru_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, h0: torch.Tensor,
                conv_tail: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (y (B, S, D), h_last float32 (B, R), conv_tail).

    Griffin's recurrent block: in-projection, causal conv, RG-LRU, gated
    out-projection; S = 1 is a decode step (the same code, O(1) state)."""
    gate, xb, new_tail = _project(x, params, params["conv_b"], conv_tail)
    y, h_last = _gated_scan(xb, xb, gate, h0, params)
    return y, h_last, new_tail


def rglru_group(g, ps, xs, h0s=None, conv_tails=None):
    """`rglru_apply` over a model group (see the module's docstring): xs[i]
    (B, S, D) replicated on slot i, ps[i] the slot's parameters (its model
    shards; `conv_b`, `b_a`, `b_x` and `lam` whole, of which it takes its
    slice), h0s[i] (B, R / n) and conv_tails[i] (B, W-1, R / n) its state
    shards (zeros when None). Returns (ys, each slot's h_last and tail);
    ys[i] (B, S, D) the replicated output."""
    rn = ps[0]["w_in_x"].shape[1]
    none = [None] * g.n

    def channels(i: int) -> slice:
        return slice(i * rn, (i + 1) * rn)

    proj = g.map(lambda i, x, p, tail: _project(x, p, p["conv_b"][channels(i)], tail), xs, ps, conv_tails or none)
    xb_all = compat.all_gather([t[1] for t in proj], g.devices, dim=-1)

    def scan(i, xa, pr, p, h0):
        gate, xb = pr[0], pr[1]
        if h0 is None:
            h0 = torch.zeros((xb.shape[0], rn), dtype=torch.float32, device=xb.device)
        return _gated_scan(xa, xb, gate, h0, p, channels(i))

    out = g.map(scan, xb_all, proj, ps, h0s or none)
    ys = compat.psum([o[0] for o in out], g.devices)
    return ys, [o[1] for o in out], [t[2] for t in proj]


def init_rglru_state(batch: int, lru_width: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, lru_width), dtype=torch.float32, device=device)


class RGLRU(_Params):
    """The block's parameters under the reference's names: `w_in_x`,
    `w_in_gate` (D, R), `conv_w` (W, R), `conv_b`, `w_a`, `b_a`, `w_x`, `b_x`
    (R, R) and (R,), `lam` (R,), `w_out` (R, D)."""

    def __init__(self, d_model: int, lru_width: int, conv_width: int, store: Storage):
        super().__init__(store)
        d, r = d_model, lru_width
        self._add("w_in_x", (d, r))
        self._add("w_in_gate", (d, r))
        self._add("conv_w", (conv_width, r))
        self._add("conv_b", (r,))
        self._add("w_a", (r, r))
        self._add("b_a", (r,))
        self._add("w_x", (r, r))
        self._add("b_x", (r,))
        self._add("lam", (r,))
        self._add("w_out", (r, d))

    def forward(self, x: torch.Tensor, h0: torch.Tensor, conv_tail: Optional[torch.Tensor] = None):
        return rglru_apply(self.params(), x, h0, conv_tail)

    @torch.no_grad()
    def draw_(self, gen: torch.Generator) -> None:
        """The reference's own distributions where the dense rule does not
        hold: `conv_w` N(0, 1) x 0.1, and `lam` so that a = sigmoid(lam)^c
        spreads over (0.9, 0.999): u ~ U(0.9, 0.999), lam = log(u^(1/c) /
        (1 - u^(1/c))). Drawn in float32 on the parameters' device."""
        dev = self.lam.device
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=gen, device=dev) * 0.1)
        u = 0.9 + (0.999 - 0.9) * torch.rand(self.lam.shape, generator=gen, device=dev)
        root = u ** (1.0 / C_SCALE)
        self.lam.copy_(torch.log(root / (1 - root)))

