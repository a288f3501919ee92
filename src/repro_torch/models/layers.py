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
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

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
