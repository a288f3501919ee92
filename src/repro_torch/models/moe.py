"""Mixture-of-Experts FFN with capacity-bounded top-k routing (port of
`repro/models/moe.py`).

Dispatch is the reference's dense one-hot-cumsum scheme: each (token,
choice) pair takes its rank within its expert from a cumulative sum over
the pairs in token-major order, ranks >= capacity are dropped, and the kept
pairs are scattered into an (E, capacity, D) buffer for batched per-expert
SwiGLU products (`torch.bmm`, plain library products as in the reference,
which computes them outside any Pallas kernel). Every expert is computed,
full or not: a decode step of a few tokens reads every expert's weights.

Only the reference's branch without a mesh is ported: its `shard_map`
dispatch runs under a mesh alone (ROADMAP A10, the mesh machinery).

Routing runs in float32 (`route`): the router is held in the compute dtype,
as the reference's `_cast` rounds it before use, and the product is taken
in float32. Top-k is a stable descending sort, so that equal probabilities
pick the lower expert first, as `jax.lax.top_k` does (`torch.topk` does
not).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.models.params import Storage, _Params


class MoEFFN(_Params):
    """The expert FFN's parameters under the reference's names: `router`
    (d_model, E), `w_gate`/`w_up` (E, d_model, d_ff) and `w_down` (E, d_ff,
    d_model)."""

    def __init__(self, cfg, store: Storage):
        super().__init__(store)
        d, f, n = cfg.d_model, cfg.d_ff, cfg.n_experts
        self._add("router", (d, n))
        self._add("w_gate", (n, d, f))
        self._add("w_up", (n, d, f))
        self._add("w_down", (n, f, d))

    def forward(self, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self.params(), cfg, x)


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for `tokens` tokens: capacity_factor * tokens * k / E
    truncated, rounded up to a multiple of 8, at least 8."""
    cap = int(cfg.capacity_factor * tokens * cfg.n_experts_per_token / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _dispatch_indices(sel_flat: torch.Tensor, n_experts: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expert, slot) of each (token, choice) pair of `sel_flat` (N,), its
    rank among the earlier pairs routed to the same expert; overflow takes
    expert 0 and the sentinel slot `cap`. The reference's one-hot cumsum,
    with the one-hot laid out (E, N) so that the scan runs along the
    innermost dim (torch's scan along an outer dim of 65,536 pairs took
    25 ms a layer on the H100)."""
    experts = torch.arange(n_experts, device=sel_flat.device)
    oh = (experts[:, None] == sel_flat[None, :]).to(torch.int32)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    rank = torch.gather(pos, 0, sel_flat[None, :].long())[0]
    keep = rank < cap
    slot = torch.where(keep, rank, cap)
    e = torch.where(keep, sel_flat.long(), 0)
    return e, slot.long()


def unique_scatter(src: torch.Tensor, e: torch.Tensor, c: torch.Tensor, n_experts: int,
                   cap: int) -> torch.Tensor:
    """src (N, D) at unique (e, c) -> buf (E, cap, D); pairs at the
    sentinel slot `cap` land in a spare slot that is sliced away (a view:
    the batched products take its strides as they are). A set, not an
    accumulation: kept slots are unique."""
    buf = src.new_zeros((n_experts, cap + 1, src.shape[-1]))
    buf.index_put_((e, c), src)
    return buf[:, :cap]


def unique_gather(buf: torch.Tensor, e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """buf (E, cap, D) at (e, c) -> (N, D), zeros at the sentinel slot
    `cap`: its pairs read a kept row, and the select zeroes them."""
    cap = buf.shape[1]
    keep = (c < cap)[:, None]
    return torch.where(keep, buf[e, c.clamp(max=cap - 1)], buf.new_zeros(()))


def route(router: torch.Tensor, cfg, xt: torch.Tensor):
    """The routing of `moe_ffn` for tokens xt (T, D): float32 logits and
    softmax, the top k (a stable sort: ties go to the lower expert),
    gates renormalised to sum to 1, and the Switch load-balance loss
    E * sum_e f_e * p_e. Returns (gates (T, k) float32, sel (T, k) int64,
    probs (T, E), aux)."""
    n_experts, k = cfg.n_experts, cfg.n_experts_per_token
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = vals[:, :k], idx[:, :k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    experts = torch.arange(n_experts, device=xt.device)
    f = torch.mean(torch.sum((sel[..., None] == experts).to(torch.float32), dim=1), dim=0)
    aux = n_experts * torch.sum(f * torch.mean(probs, dim=0))
    return gates, sel, probs, aux


def moe_ffn(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux load-balance loss, a float32
    scalar). Capacity and drops depend on all B*S tokens of the call."""
    b, s, d = x.shape
    n_experts, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    gates, sel, _, aux = route(params["router"], cfg, xt)
    cap = capacity(t, cfg)
    e, slot = _dispatch_indices(sel.reshape(t * k), n_experts, cap)
    buf = unique_scatter(torch.repeat_interleave(xt, k, dim=0), e, slot, n_experts, cap)
    a = torch.bmm(buf, params["w_gate"])
    h = (a * torch.sigmoid(a)) * torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"])
    gathered = unique_gather(out_buf, e, slot)
    w = gates.reshape(-1).to(x.dtype)
    y = torch.sum((gathered * w[:, None]).reshape(t, k, d), dim=1)
    return y.reshape(b, s, d), aux
