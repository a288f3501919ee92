"""Mixture-of-Experts FFN with capacity-bounded top-k routing (port of
`repro/models/moe.py`).

Dispatch is the reference's dense one-hot-cumsum scheme: each (token,
choice) pair takes its rank within its expert from a cumulative sum over
the pairs in token-major order, ranks >= capacity are dropped, and the kept
pairs are scattered into an (E, capacity, D) buffer for batched per-expert
SwiGLU products (`torch.bmm`, plain library products as in the reference,
which computes them outside any Pallas kernel). Every expert is computed,
full or not: a decode step of a few tokens reads every expert's weights.

Under a mesh and logical mapping (`models/partition.py`) whose data axes
hold n > 1 slots, dispatch and combine run per data shard, as the
reference's `shard_map` does: each shard ranks its own contiguous T / n
tokens against a per-shard capacity C_local = max(8, ceil(capacity(T) /
n)), the (E, C, D) buffer (C = n * C_local) holds shard i in capacity slots
[i * C_local, (i + 1) * C_local), and each shard combines its tokens from
its own block. T % n != 0 (a batch-1 decode) takes the unsharded branch.
The expert products run on the whole buffer with whole weights, which
changes no number. Inside a slot's program (the data-parallel train step)
the tokens are already the slot's shard; its load-balance loss then uses
the global routed fractions when the step has gathered them
(`SlotProgram.shared["moe_f"]`), so that the slots' losses sum to the
reference's.

Under tensor parallelism (`moe_group`, one data shard's model group of n
slots) the router stays replicated: every slot routes the shard's tokens
and fills the whole (E, C, D) buffer. Where E divides the production model
axis (qwen3-moe) the experts are split over it (expert parallelism): each
slot runs `_experts` on its E / n experts' rows of the buffer and the rows
are all-gathered, so that every slot combines over k in the unsharded
order. Otherwise (mixtral) each expert's d_ff is split (tensor parallelism
inside each expert): each slot's products give a partial (E, C, D) sum,
added by `compat.psum`. The capacity stays the reference's.

Routing runs in float32 (`route`): the router is held in the compute dtype,
as the reference's `_cast` rounds it before use, and the product is taken
in float32. Top-k is a stable descending sort, so that equal probabilities
pick the lower expert first, as `jax.lax.top_k` does (`torch.topk` does
not).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.core.device import on_device
from repro_torch.models import partition
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
        #: the layer's index, naming it to a slot program's shared routing
        #: fractions (`moe_ffn(key=)`)
        self.key: Optional[int] = None

    def forward(self, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self.params(), cfg, x, key=self.key)


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


def shard_dispatch(sel: torch.Tensor, cfg, n_shards: int, cap_local: int):
    """(expert, slot) of each (token, choice) pair of sel (T, k), each of
    the n_shards contiguous token shards ranked on its own against
    `cap_local` slots (the sentinel `cap_local` for overflow): the
    reference's per-shard `_dispatch_indices`, concatenated."""
    t, k = sel.shape
    tl = t // n_shards
    parts = [_dispatch_indices(sel[i * tl:(i + 1) * tl].reshape(tl * k), cfg.n_experts, cap_local)
             for i in range(n_shards)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _experts(params: Mapping[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    a = torch.bmm(buf, params["w_gate"])
    h = (a * torch.sigmoid(a)) * torch.bmm(buf, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _local(params, cfg, xt: torch.Tensor, sel: torch.Tensor, gates: torch.Tensor, cap: int,
           dtype: torch.dtype) -> torch.Tensor:
    """Dispatch, expert products and combine of tokens xt (T, D) at capacity
    `cap`: (T, D)."""
    t, d = xt.shape
    k = cfg.n_experts_per_token
    e, slot = _dispatch_indices(sel.reshape(t * k), cfg.n_experts, cap)
    buf = unique_scatter(torch.repeat_interleave(xt, k, dim=0), e, slot, cfg.n_experts, cap)
    gathered = unique_gather(_experts(params, buf), e, slot)
    w = gates.reshape(-1).to(dtype)
    return torch.sum((gathered * w[:, None]).reshape(t, k, d), dim=1)


def moe_ffn(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
            key: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux load-balance loss, a float32
    scalar). Capacity and drops depend on all B*S tokens of the call, or
    per data shard under a mesh (see the module's docstring). `key` names
    the layer to a slot program's shared routing fractions."""
    b, s, d = x.shape
    n_experts, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    gates, sel, probs, aux = route(params["router"], cfg, xt)
    prog = partition.current_slot()
    if prog is not None and "data" in prog.split:
        n = prog.split["data"][1]
        aux = _slot_aux(prog, key, sel, probs, t * n, n_experts, aux)
        cap = max(8, -(-capacity(t * n, cfg) // n))
        return _local(params, cfg, xt, sel, gates, cap, x.dtype).reshape(b, s, d), aux
    dax, n = partition.data_shards()
    if dax is None or n == 1 or t % n != 0:
        return _local(params, cfg, xt, sel, gates, capacity(t, cfg), x.dtype).reshape(b, s, d), aux
    return _sharded(params, cfg, xt, sel, gates, dax, n, x.dtype).reshape(b, s, d), aux


def _slot_aux(prog, key, sel, probs, t_global: int, n_experts: int, aux):
    """A slot's share of the global load-balance loss: E * sum_e f_e *
    sum_tokens(p_e) / T with the global fractions f from the step's
    recording pass; records this slot's routed counts when asked."""
    counts = torch.sum((sel[..., None] == torch.arange(n_experts, device=sel.device)).to(torch.float32),
                       dim=(0, 1))
    rec = prog.shared.get("moe_counts")
    if rec is not None:
        rec[key] = rec[key] + counts.to(rec[key].device) if key in rec else counts
    f = prog.shared.get("moe_f", {}).get(key)
    if f is None:
        return aux
    return n_experts * torch.sum(f.to(probs.device) * torch.sum(probs, dim=0)) / t_global


def _sharded(params, cfg, xt, sel, gates, dax, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The per-data-shard dispatch and combine: each shard's tokens ranked
    apart (`shard_dispatch`) and scattered on the shard's slot, the
    buffers assembled along capacity
    (`compat.all_gather`), the expert products on the whole buffer, each
    shard's block of the products combined on its slot."""
    mesh = partition.current_mesh()
    t, d = xt.shape
    k = cfg.n_experts_per_token
    tl = t // n
    cap_local = max(8, -(-capacity(t, cfg) // n))
    devs = [mesh.devices[s] for s in partition.lead_slots(mesh, partition.axis_names(dax))]
    e_all, slot_all = shard_dispatch(sel, cfg, n, cap_local)
    idx, bufs = [], []
    for i, dev in enumerate(devs):
        with on_device(dev):
            pairs = slice(i * tl * k, (i + 1) * tl * k)
            e, slot = e_all[pairs].to(dev), slot_all[pairs].to(dev)
            bufs.append(unique_scatter(torch.repeat_interleave(xt[i * tl:(i + 1) * tl].to(dev), k, dim=0), e,
                                       slot, cfg.n_experts, cap_local))
            idx.append((e, slot))
    buf = compat.all_gather(bufs, [xt.device] * n, dim=1)[0]
    out_buf = _experts(params, buf)
    ys = []
    for i, dev in enumerate(devs):
        with on_device(dev):
            e, slot = idx[i]
            gathered = unique_gather(out_buf[:, i * cap_local:(i + 1) * cap_local].to(dev), e, slot)
            w = gates[i * tl:(i + 1) * tl].reshape(-1).to(device=dev, dtype=dtype)
            ys.append(torch.sum((gathered * w[:, None]).reshape(tl, k, d), dim=1))
    return compat.all_gather(ys, [xt.device] * n, dim=0)[0]


def expert_parallel(cfg) -> bool:
    """The experts split over the model axis (E divides the production
    model axis, `runtime/sharding.py: _rule`), else d_ff inside each."""
    from repro_torch.runtime.sharding import MODEL_AXIS_SIZE

    return cfg.n_experts > 0 and cfg.n_experts % MODEL_AXIS_SIZE == 0


def moe_group(g, ps, cfg, xs, cap: int, f_global=None, t_global: Optional[int] = None,
              record: Optional[list] = None):
    """`moe_ffn` over a model group: xs[i] (B, S, D) replicated, ps[i] the
    slot's `router` (whole) and expert shards, `cap` the capacity of the
    data shard's tokens. Returns (ys (B, S, D) replicated, aux per slot).
    With `f_global` (E,) the global routed fractions of a data-parallel
    step, each slot's aux is the data shard's share E * sum_e f_e *
    sum_tokens(p_e) / t_global; `record` (a list) gets the shard's routed
    counts (E,)."""
    b, s, d = xs[0].shape
    n_experts, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    ep = expert_parallel(cfg)
    el = n_experts // g.n

    def dispatch(i, x, p):
        xt = x.reshape(t, d)
        gates, sel, probs, aux = route(p["router"], cfg, xt)
        if record is not None and i == 0:
            record.append(torch.sum((sel[..., None] == torch.arange(n_experts, device=sel.device))
                                    .to(torch.float32), dim=(0, 1)))
        if f_global is not None:
            aux = n_experts * torch.sum(f_global.to(probs.device) * torch.sum(probs, dim=0)) / t_global
        e, slot = _dispatch_indices(sel.reshape(t * k), n_experts, cap)
        buf = unique_scatter(torch.repeat_interleave(xt, k, dim=0), e, slot, n_experts, cap)
        return gates, e, slot, aux, buf

    routed = g.map(dispatch, xs, ps)
    if ep:
        parts = g.map(lambda i, r, p: _experts(p, r[4][i * el:(i + 1) * el]), routed, ps)
        out_bufs = compat.all_gather(parts, g.devices, dim=0)
    else:
        out_bufs = compat.psum(g.map(lambda i, r, p: _experts(p, r[4]), routed, ps), g.devices)

    def combine(i, r, out_buf):
        gates, e, slot = r[0], r[1], r[2]
        gathered = unique_gather(out_buf, e, slot)
        w = gates.reshape(-1).to(xs[0].dtype)
        return torch.sum((gathered * w[:, None]).reshape(t, k, d), dim=1).reshape(b, s, d)

    return g.map(combine, routed, out_bufs), [r[3] for r in routed]
