"""Shared transformer layers (port of `repro/models/layers.py`): RMSNorm,
RoPE, SwiGLU, GQA attention.

Functions take the reference's parameter names in a mapping (`params["wq"]`
and so on; the modules of `models/transformer.py` pass their own
parameters) and keep its weight layout, `x @ w` with `w` of shape
(d_in, d_out), and its casts, so that parameters carry across unchanged.

Three attentions:
  * `attention_train` (the reference's, a whole sequence with gradients)
    runs `FlashAttention`: kernel B10 forward in the form that also writes
    each row's log-sum-exp (`ops.flash_attention_fwd_lse`), and the port of
    the reference's hand-derived backward (`_flash_core_bwd`) in plain
    torch, blockwise over KV blocks, with the scores recomputed in float32
    (ROADMAP C5's training half); with `cfg.attn_logit_softcap` both take
    the cap (B10 caps each unmasked key's scaled score, the backward its
    derivative);
  * `attention_prefill` (the reference's `attention_train` on a prompt,
    with the k/v the decode cache keeps) calls kernel B10 through
    `ops.flash_attention_fwd`: float32 scores (bf16 inputs' products are
    exact in float32), float32 softmax, and p@v in float32, or on bf16
    inputs as three bf16 products of p split as p_hi + p_mid + p_lo (p to
    2^-26) on the tensor cores. The reference's prefill runs the blocked
    `flash_attention` below instead, whose bf16 einsums round the scores and
    p to bf16, so in a bf16 configuration the two prefills differ by that
    rounding by design (in float32 both are float32 and agree to summation
    order);
  * `flash_attention`, the reference's general blocked scan (positions,
    `kv_valid`, softcap) in plain torch, with the reference's numerics. The
    raw-cache decode uses it; `_chunk_attn_update` is also the step of the
    quantized-cache decode read (`core/kvcache.py`).

Under tensor parallelism (a model group of n slots, `models/partition.py`)
the attention is split by heads (`head_splits`): each slot projects its
columns of `wq` (a 1/n shard), the kv heads its q heads read (a slice of
`wk`/`wv` when they are replicated over the model axis, its shard when
split), runs norm, RoPE and B10 on its heads, and multiplies its rows of
`wo`; the partial outputs meet in `compat.psum` (`attention_group_out`).
Where the head count does not divide n, slot i attends a contiguous range
of whole heads (the first H mod n slots one more): its q columns are
all-gathered first, and the attention outputs all-gathered and re-cut to
`wo`'s row shards before the sum. `swiglu` is the FFN's slot program as
it stands (its `w_gate`/`w_up` column shards and `w_down` row shard give a
partial sum).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.kernels import ops

# Default KV block of the blocked scan (the reference's KV_BLOCK)
KV_BLOCK = 1024
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """`x * rsqrt(mean(x^2) + eps) * (1 + gamma)` in float32, in x's dtype;
    gamma is an offset from 1."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.to(torch.float32))).to(dt)


# ------------------------------------------------------------------ RoPE --
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions int[...] -> (cos, sin) float32[..., head_dim // 2]."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a Python scalar base: a device tensor built from it would be a
    # synchronizing host-to-device copy at every call
    freqs = torch.pow(float(np.float32(theta)), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, Dh); cos/sin: (..., S, Dh//2) broadcast over heads.
    Computed in float32 (x promotes against the float32 angles), returned in
    x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- SwiGLU --
def swiglu(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`silu(x @ w_gate) * (x @ w_up) @ w_down`, silu as `a * sigmoid(a)`,
    each op rounding to x's dtype as the reference's `jax.nn.silu` does."""
    a = x @ params["w_gate"]
    h = (a * torch.sigmoid(a)) * (x @ params["w_up"])
    return h @ params["w_down"]


# ----------------------------------------------------- blocked attention --
def _score_scale(head_dim: int) -> np.float32:
    """The reference's `s / sqrt(Dh)` as the jitted reference computes it:
    XLA folds the division by a constant into a product with its float32
    reciprocal."""
    return np.float32(1.0) / np.sqrt(np.float32(head_dim))


def _chunk_attn_update(q, k_blk, v_blk, mask_blk, m, l, acc, softcap=None):
    """One flash step: q (B, H, Sq, Dh), k/v_blk (B, K, C, Dh) grouped to H,
    mask_blk (B, Sq, C); running (m, l, acc) float32 of shapes (B, K, G,
    Sq), (B, K, G, Sq), (B, K, G, Sq, Dh).

    The reference's numerics: the score einsum runs in the promoted input
    dtype and is then widened to float32 (bf16 inputs round the scores to
    bf16); p is cast to the value dtype for the PV einsum."""
    b, h, sq, dh = q.shape
    kh = k_blk.shape[1]
    g = h // kh
    dt = torch.promote_types(q.dtype, k_blk.dtype)
    qg = q.reshape(b, kh, g, sq, dh).to(dt)
    s = torch.einsum("bkgsd,bkcd->bkgsc", qg, k_blk.to(dt)).to(torch.float32)
    s = s * float(_score_scale(dh))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask_blk[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgsc,bkcd->bkgsd", p.to(v_blk.dtype), v_blk).to(torch.float32)
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def _block_mask(q_positions, p_blk, o_blk, causal, window):
    """(B, Sq, C) bool mask for one KV block."""
    mask = o_blk[:, None, :]
    if causal:
        mask = mask & (p_blk[:, None, :] <= q_positions[:, :, None])
    if window is not None:
        mask = mask & (p_blk[:, None, :] > q_positions[:, :, None] - window)
    return mask


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, K, Dh)
    v: torch.Tensor,  # (B, Sk, K, Dh)
    q_positions: torch.Tensor,  # int (B, Sq) absolute positions of queries
    kv_positions: torch.Tensor,  # int (B, Sk) absolute positions of keys
    kv_valid: Optional[torch.Tensor] = None,  # bool (B, Sk)
    window: Optional[int] = None,  # sliding window (keys >= qpos-window+1)
    causal: bool = True,
    kv_block: int = KV_BLOCK,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blocked causal (optionally sliding-window) attention with a running
    (max, sum, acc) softmax over KV blocks of `kv_block` keys, padded to a
    whole block: (B, Sq, H, Dh) in q's dtype. Plain torch, forward only."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    c = min(kv_block, sk)
    n_blocks = (sk + c - 1) // c
    pad = n_blocks * c - sk
    valid = kv_valid if kv_valid is not None else torch.ones((b, sk), dtype=torch.bool, device=q.device)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=-1)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    q_ = q.transpose(1, 2)  # (B, H, Sq, Dh)
    m = torch.full((b, kh, g, sq), -float("inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, dh), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        blk = slice(j * c, (j + 1) * c)
        mask = _block_mask(q_positions, kv_positions[:, blk], valid[:, blk], causal, window)
        m, l, acc = _chunk_attn_update(
            q_, k[:, blk].transpose(1, 2), v[:, blk].transpose(1, 2), mask, m, l, acc, softcap
        )
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, sq, dh).transpose(1, 2).to(q.dtype)


# ------------------------------------------------------------- GQA block --
def attention_qkv(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project + per-head norm + RoPE. x: (B, S, D) -> q (B, S, H, Dh),
    k/v (B, S, K, Dh)."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kh, dh)
    v = (x @ params["wv"]).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def attention_prefill(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
                      window: Optional[int] = None):
    """Causal self-attention over a whole sequence at positions arange(S)
    through kernel B10, with `cfg.attn_logit_softcap`: (out (B, S, D), k,
    v), k/v (B, S, K, Dh) for the decode cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    q, k, v = attention_qkv(params, cfg, x, positions)
    out = ops.flash_attention_fwd(q, k, v, window=window, causal=True, softcap=cfg.attn_logit_softcap)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"], k, v



# ------------------------------------------------------- training attention --
def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, window: Optional[int], causal: bool,
                   kv_block: int = KV_BLOCK, softcap: Optional[float] = None):
    """The reference's hand-derived flash backward (`_flash_core_bwd`) at
    positions arange(Sq) x arange(Sk): q (B, Sq, H, Dh), k/v (B, Sk, K, Dh),
    out (B, Sq, H, Dh) and dout like q, lse float32 (B, H, Sq). Returns (dq,
    dk, dv) in the inputs' dtypes.

    D = rowsum(dout * out) in float32; per KV block of `kv_block` keys (the
    keys padded to a whole block), p = exp(s - lse) recomputed from the
    scores, dv += p^T dout, dp = dout v^T, ds = p * (dp - D) * scale,
    dq += ds k (float32), dk += ds^T q; the block products in the input
    dtype, as the reference's. One difference: the recomputed scores are
    float32 products of the inputs (the reference's are the input dtype's),
    so that in bf16 p is the p that B10's float32 forward normalised
    (ROADMAP C5); in float32 the two are the same.

    With a logit softcap c the forward's scores were s_c = c * t, t =
    tanh(s / c) of the scaled float32 scores s: p = exp(s_c - lse), and ds
    takes the cap's derivative (1 - t^2) before the scale. The reference
    differentiates its softcap path by autodiff through the scan
    (`_flash_ad`); this is the same gradient in closed form."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    c = min(kv_block, sk)
    n = (sk + c - 1) // c
    pad = n * c - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    positions = torch.arange(sq, device=dev)[None]
    kv_pos = torch.arange(n * c, device=dev)[None]
    kv_valid = kv_pos < sk
    scale = float(_score_scale(dh))

    def grouped(t: torch.Tensor) -> torch.Tensor:  # (B, S, H, Dh) -> (B, K, G, S, Dh)
        return t.transpose(1, 2).reshape(b, kh, g, t.shape[1], dh)

    do = grouped(dout)
    d_sum = torch.sum(do.to(torch.float32) * grouped(out).to(torch.float32), dim=-1)
    q_ = grouped(q)
    q32 = q_.to(torch.float32)
    do_c = do.to(q.dtype)
    lse_ = lse.reshape(b, kh, g, sq)[..., None]
    dq = torch.zeros((b, kh, g, sq, dh), dtype=torch.float32, device=dev)
    dk = torch.empty((b, kh, n * c, dh), dtype=k.dtype, device=dev)
    dv = torch.empty((b, kh, n * c, dh), dtype=v.dtype, device=dev)
    for j in range(n):
        blk = slice(j * c, (j + 1) * c)
        k_blk = k[:, blk].transpose(1, 2)  # (B, K, C, Dh)
        v_blk = v[:, blk].transpose(1, 2)
        mask = _block_mask(positions, kv_pos[:, blk], kv_valid[:, blk], causal, window)
        s = torch.einsum("bkgsd,bkcd->bkgsc", q32, k_blk.to(torch.float32)) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        s = torch.where(mask[:, None, None], s, torch.full_like(s, -float("inf")))
        p = torch.exp(s - lse_)  # masked -> exp(-inf) = 0
        del s
        dv[:, :, blk] = torch.einsum("bkgsc,bkgsd->bkcd", p.to(v.dtype), do_c)
        dp = torch.einsum("bkgsd,bkcd->bkgsc", do_c, v_blk).to(torch.float32)
        ds = p * (dp - d_sum[..., None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
            del t
        ds = (ds * scale).to(q.dtype)
        del p, dp
        dq += torch.einsum("bkgsc,bkcd->bkgsd", ds, k_blk).to(torch.float32)
        dk[:, :, blk] = torch.einsum("bkgsc,bkgsd->bkcd", ds, q_)
    dq = dq.reshape(b, h, sq, dh).transpose(1, 2).to(q.dtype)
    dk = dk[:, :, :sk].transpose(1, 2).contiguous()
    dv = dv[:, :, :sk].transpose(1, 2).contiguous()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal (optionally windowed, optionally capped) GQA attention at
    positions arange(S) with gradients: forward on kernel B10 with its
    log-sum-exp (`ops.flash_attention_fwd_lse`; its plain version on CPU
    tensors), saving (q, k, v, out, lse) and the cap; backward
    `flash_backward` (the reference's `_flash_core` custom VJP, and its
    `_flash_ad` gradient when capped). B10 has no backward kernel (ROADMAP
    B lists one as a candidate)."""

    @staticmethod
    def forward(ctx, q, k, v, window: Optional[int], causal: bool, softcap: Optional[float] = None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal, ctx.softcap = window, causal, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.window, ctx.causal, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


def attention_train(params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention over a whole sequence (B, S, D) at positions
    arange(S), differentiable, with `cfg.attn_logit_softcap`: (B, S, D).
    Forward on kernel B10."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    q, k, v = attention_qkv(params, cfg, x, positions)
    out = FlashAttention.apply(q, k, v, window, True, cfg.attn_logit_softcap)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"]


# --------------------------------------------- tensor-parallel attention --
@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """One model slot's part of the attention: `cols`, its columns of `wq`
    (and rows of `wo`); `heads`, the whole q heads it attends; `kv`, the kv
    heads those read; `own_kv`, the kv heads it contributes when the slots
    gather K/V (each kv head from the first slot that reads it);
    `gather_q`, whether q is all-gathered first (heads straddle the
    slots); `kv_index`, each local q head's kv head among `kv` when B10's
    grouping (local head j reads local kv j // (heads / kv)) does not hold,
    else None."""

    cols: Tuple[int, int]
    heads: Tuple[int, int]
    kv: Tuple[int, int]
    own_kv: Tuple[int, int]
    gather_q: bool
    kv_index: Optional[Tuple[int, ...]]


def head_splits(cfg, n: int, kv_sharded: bool) -> List[HeadSplit]:
    """The `HeadSplit` of each of n model slots. `kv_sharded`: `wk`/`wv`
    are split over the model axis (each slot holds kv heads [iK/n,
    (i+1)K/n), which must be the ones its heads read)."""
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if (h * dh) % n or h < n:
        raise ValueError(f"{h} heads of {dh} do not split over {n} model slots")
    width, grp = h * dh // n, h // kh
    base, extra = divmod(h, n)
    out, h0, kv_done = [], 0, 0
    for i in range(n):
        h1 = h0 + base + (i < extra)
        k0, k1 = h0 // grp, (h1 - 1) // grp + 1
        if kv_sharded and (k0, k1) != (i * kh // n, (i + 1) * kh // n):
            raise ValueError(f"slot {i}'s heads [{h0}, {h1}) read kv heads [{k0}, {k1}), "
                             f"not its shard of the split wk/wv")
        idx = tuple((h0 + j) // grp - k0 for j in range(h1 - h0))
        nq, nk = h1 - h0, k1 - k0
        regular = nq % nk == 0 and all(idx[j] == j // (nq // nk) for j in range(nq))
        out.append(HeadSplit((i * width, (i + 1) * width), (h0, h1), (k0, k1), (max(k0, kv_done), k1),
                             h % n != 0, None if regular else idx))
        kv_done = max(kv_done, k1)
        h0 = h1
    return out


def _kv_project(p: Mapping[str, torch.Tensor], name: str, x: torch.Tensor, sp: HeadSplit,
                heads: Tuple[int, int], kv_sharded: bool, dh: int) -> torch.Tensor:
    """x @ the columns of kv heads `heads` of `wk`/`wv` (the slot's shard
    when split, else a slice of the replicated weight)."""
    off = sp.kv[0] if kv_sharded else 0
    return x @ p[name][:, (heads[0] - off) * dh:(heads[1] - off) * dh]


def attention_group_qkv(g, ps, cfg, xs, positions, splits: List[HeadSplit], kv_sharded: bool,
                        all_heads: bool = False):
    """Each slot's (q, k, v) from the replicated input xs[i] (B, S, D) at
    `positions` (B, S): q on the slot's heads (B, S, h_i, Dh) and k/v on
    the kv heads they read, or with `all_heads` every q and kv head on
    every slot (the decode: q all-gathered, K/V gathered from their first
    readers). Per-head norm and RoPE as `attention_qkv`."""
    dh = cfg.head_dim
    qc = g.map(lambda i, x, p: x @ p["wq"], xs, ps)
    if all_heads or splits[0].gather_q:
        qc = compat.all_gather(qc, g.devices, dim=-1)

    def q_of(i, q, p):
        sp = splits[i]
        if not all_heads and sp.gather_q:
            q = q[..., sp.heads[0] * dh:sp.heads[1] * dh]
        b, s = q.shape[:2]
        q = q.reshape(b, s, -1, dh)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        cos, sin = rope_angles(positions.to(q.device), dh, cfg.rope_theta)
        return apply_rope(q, cos, sin)

    def kv_of(i, x, p):
        sp = splits[i]
        heads = sp.own_kv if all_heads else sp.kv
        b, s = x.shape[:2]
        k = _kv_project(p, "wk", x, sp, heads, kv_sharded, dh).reshape(b, s, -1, dh)
        v = _kv_project(p, "wv", x, sp, heads, kv_sharded, dh).reshape(b, s, -1, dh)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"])
        cos, sin = rope_angles(positions.to(k.device), dh, cfg.rope_theta)
        return apply_rope(k, cos, sin), v

    qs = g.map(q_of, qc, ps, by=g.variants)
    kvs = g.map(kv_of, xs, ps, by=g.variants)
    ks, vs = [kv[0] for kv in kvs], [kv[1] for kv in kvs]
    if all_heads:
        ks = compat.all_gather(ks, g.devices, dim=2)
        vs = compat.all_gather(vs, g.devices, dim=2)
    return qs, ks, vs


def grouped_kv(sp: HeadSplit, k: torch.Tensor, v: torch.Tensor):
    """k/v (B, S, kv_i, Dh) laid out for B10 against the slot's q heads:
    as they are when B10's grouping holds, else one kv head per q head."""
    if sp.kv_index is None:
        return k, v
    idx = torch.tensor(sp.kv_index, device=k.device)
    return k.index_select(2, idx).contiguous(), v.index_select(2, idx).contiguous()


def attention_group_out(g, ps, outs, splits: List[HeadSplit], all_heads: bool = False):
    """The attention outputs through `wo`: each slot's outs[i] (B, S,
    h_i, Dh) on its heads, or with `all_heads` (B, S, H, Dh) on every head,
    times its rows of `wo`, summed over the slots (`compat.psum`)."""
    b, s = outs[0].shape[:2]
    flat = [o.reshape(b, s, -1) for o in outs]
    if not all_heads and splits[0].gather_q:
        flat = compat.all_gather(flat, g.devices, dim=-1)
        all_heads = True
    parts = g.map(lambda i, o, p: (o[..., splits[i].cols[0]:splits[i].cols[1]] if all_heads else o) @ p["wo"],
                  flat, ps)
    return compat.psum(parts, g.devices)


def attention_train_group(g, ps, cfg, xs, splits: List[HeadSplit], kv_sharded: bool,
                          window: Optional[int] = None):
    """`attention_train` over a model group: B10's lse form and the flash
    backward on each slot's heads; the replicated (B, S, D) output on
    every slot."""
    b, s = xs[0].shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=xs[0].device)[None].expand(b, s)
    qs, ks, vs = attention_group_qkv(g, ps, cfg, xs, positions, splits, kv_sharded)

    def one(i, q, k, v):
        k, v = grouped_kv(splits[i], k, v)
        return FlashAttention.apply(q, k, v, window, True, cfg.attn_logit_softcap)

    return attention_group_out(g, ps, g.map(one, qs, ks, vs, by=g.variants), splits)
