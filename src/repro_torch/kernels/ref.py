"""Plain PyTorch versions of the CUDA kernels (port of `repro/kernels/ref.py`).
They repeat the kernels' arithmetic with the tensor ops of `core/bits.py`:
the CPU path of `ops`, and the oracle the kernels are held against on the
card, bit for bit; B10's (`flash_reference`, a dense float32 softmax) within
a stated tolerance, its sums running in another order than the kernel's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bits
from repro_torch.core.bits import M32
from repro_torch.core.algorithms import nuq
from repro_torch.kernels import delta_nuq, dict_hash, rans
from repro_torch.kernels.rans import PROB_BITS, PROB_SCALE, RANS_L, cum_freqs, slot_table


def pack_blocks_ref(codes: torch.Tensor, bitlen: torch.Tensor, block: int,
                    out_words: Optional[int] = None):
    """Block-local packing (carry-free scatter-add): int32[N, 2] codes and
    int32[N] bitlens -> (words int32[N/block, out_words], nbits int32[N/block]).
    `out_words` defaults to the kernel contract's 2*block+1."""
    nblocks = codes.shape[0] // block
    out_words = 2 * block + 1 if out_words is None else out_words
    words, totals, _ = bits.pack_bits(
        codes.reshape(nblocks, block, 2), bitlen.reshape(nblocks, block), out_words
    )
    return words, totals


def unpack_blocks_ref(words: torch.Tensor, bitlen: torch.Tensor):
    """`bits.unpack_symbols` per block: int32[nb, W] words and int32[nb*S]
    bitlens -> int32[nb*S, 2] codes."""
    nblocks = words.shape[0]
    codes, _ = bits.unpack_symbols(words, bitlen.reshape(nblocks, -1))
    return codes.reshape(-1, 2)


def compact_blocks_ref(words: torch.Tensor, nbits: torch.Tensor):
    """`bits.compact_payload`: (payload int32[n*OW], total int32)."""
    return bits.compact_payload(words, nbits)


def pack_meta7_ref(bitlen: torch.Tensor) -> torch.Tensor:
    """`bits.pack_meta7` per row: int32[n, S] -> int32[n, ceil(7S/32)]."""
    return bits.pack_meta7(bitlen)


def probe_ref(x: torch.Tensor, table: torch.Tensor, valid: torch.Tensor, idx_bits: int):
    """Dictionary probe per lane: x int32[L, N] against table int32[L, TS]
    and valid uint8[L, TS] -> (c0, c1, bitlen) int32[L, N]."""
    h = dict_hash.hash_tensor(x, idx_bits)
    hit = (valid.gather(1, h) != 0) & (table.gather(1, h) == x)
    return dict_hash.symbols(hit, h, x, idx_bits)


def _dict_walk(state: tuple, steps, idx_bits: int, block):
    """Tdic32's frozen per-block walk over a chunk: `block(j, table, valid)`
    gives block j's values int32[L, B] (read against the state the blocks
    before it left) and what it emits; each block's values are then merged
    in (`dict_hash.merge_updates`). Returns (what the blocks emit, the
    state after the chunk as (table, valid uint8, ts, clock))."""
    table, valid, ts, clock = state
    st = {"table": table.clone(), "valid": valid.bool(), "ts": ts.clone(), "clock": clock.clone()}
    emitted = []
    for j in range(steps):
        x, out = block(j, st["table"], st["valid"])
        st = dict_hash.merge_updates(st, dict_hash.hash_tensor(x, idx_bits), x, idx_bits)
        emitted.append(out)
    return emitted, (st["table"], st["valid"].to(torch.uint8), st["ts"], st["clock"])


def dict_chunk_encode_ref(blocks: torch.Tensor, table: torch.Tensor, valid: torch.Tensor,
                          ts: torch.Tensor, clock: torch.Tensor, idx_bits: int):
    """Tdic32's frozen encode of C blocks int32[C, L, B] from the state
    (table int32, valid uint8, ts int32 [L, 2^idx_bits], clock int32[L]),
    block by block: `probe_ref` against the table the blocks before it
    left, then the block's merge. Returns (codes int32[C, L, B, 2], bitlen
    int32[C, L, B], table, valid, ts, clock)."""
    c, lanes, b = blocks.shape

    def block(j, tab, val):
        c0, c1, blen = probe_ref(blocks[j], tab, val.to(torch.uint8), idx_bits)
        return blocks[j], (torch.stack([c0, c1], dim=-1), blen)

    out, state = _dict_walk((table, valid, ts, clock), c, idx_bits, block)
    codes = torch.stack([o[0] for o in out]) if c else blocks.new_zeros((0, lanes, b, 2))
    bitlen = torch.stack([o[1] for o in out]) if c else blocks.new_zeros((0, lanes, b))
    return (codes, bitlen, *state)


def dict_chunk_decode_ref(codes: torch.Tensor, table: torch.Tensor, valid: torch.Tensor,
                          ts: torch.Tensor, clock: torch.Tensor, idx_bits: int):
    """`dict_chunk_encode_ref`'s inverse: codes int32[C, L, B, 2] -> (values
    int32[C, L, B], table, valid, ts, clock); a hit reads the table the
    blocks before it left, a miss is its literal."""
    c, lanes, b, _ = codes.shape

    def block(j, tab, val):
        hit, idx, literal = dict_hash.unsymbol(codes[j], idx_bits)
        x = bits._i32(torch.where(hit, bits._u(tab.gather(1, idx)), literal))
        return x, x

    out, state = _dict_walk((table, valid, ts, clock), c, idx_bits, block)
    values = torch.stack(out) if c else codes.new_zeros((0, lanes, b))
    return (values, *state)


def rans_encode_ref(syms: torch.Tensor, mask: torch.Tensor, freqs: torch.Tensor):
    """Interleaved rANS encode of C chunks' (C, T, N_LANES) byte grids,
    batched over chunks as the reference's `vmap` of `encode_rows` is.

    `syms` byte values (any integer dtype), `mask` marks real bytes
    (masked steps are identity). Returns `(states int32[C, N], flags
    int32[C, T, N], vals int32[C, T, N])`, indexed by ORIGINAL row; uint32
    values travel as int32 bit patterns, the state arithmetic runs on int64
    values in [0, 2^32) with explicit wraparound (`& M32`)."""
    c, t_rows, n = syms.shape
    fr = bits._u(freqs)
    cum = cum_freqs(freqs) & M32
    s = syms.to(torch.int64).clamp(0, 255)  # the reference's clamped gather
    m = mask.to(torch.bool)
    x = torch.full((c, n), RANS_L, dtype=torch.int64, device=syms.device)
    flags = torch.zeros((c, t_rows, n), dtype=torch.int32, device=syms.device)
    vals = torch.zeros((c, t_rows, n), dtype=torch.int64, device=syms.device)
    for t in range(t_rows - 1, -1, -1):  # reverse, so decode runs forward
        st, mt = s[:, t], m[:, t]
        f, cu = fr[st], cum[st]
        f_safe = torch.where(mt & (f > 0), f, torch.ones_like(f))
        # renorm: x >= f·2^20, spelled so f = PROB_SCALE cannot overflow
        emit = mt & ((x >> 20) >= f_safe)
        vals[:, t] = torch.where(emit, x & 0xFFFF, torch.zeros_like(x))
        flags[:, t] = emit.to(torch.int32)
        x1 = torch.where(emit, x >> 16, x)
        x2 = (((x1 // f_safe) << PROB_BITS) + (x1 % f_safe) + cu) & M32
        x = torch.where(mt, x2, x)
    return bits._i32(x), flags, bits._i32(vals)


def rans_section_encode_ref(data: torch.Tensor, freqs: torch.Tensor):
    """B8's section form: a section's bytes uint8[n] under one table int32
    [256] -> (states int32[C, 8], counts int32[C, 8], words
    int32[section_words(n)], E int64 0-d): `rans_encode_ref` on the chunk
    grid, `assemble_stream`, and the E u16s packed two to a word, low half
    first, in words[:ceil(E/2)] (zeros after)."""
    n = data.numel()
    words = torch.zeros(rans.section_words(n), dtype=torch.int32, device=data.device)
    if n == 0:
        empty = torch.zeros((0, rans.N_LANES), dtype=torch.int32, device=data.device)
        return empty, empty.clone(), words, torch.zeros((), dtype=torch.int64, device=data.device)
    syms, mask = rans.chunk_grid(data)
    states, flags, vals = rans_encode_ref(syms, mask, freqs)
    stream, counts = rans.assemble_stream(flags, vals)
    e = stream.numel()
    words[: (e + 1) // 2] = rans.packed_words(stream)
    return states, counts, words, torch.tensor(e, dtype=torch.int64, device=data.device)


def _read_stream(stream: torch.Tensor, p: torch.Tensor, cap: int) -> torch.Tensor:
    """u16 reads (int64) at positions `p` of `stream` (int64 values), as
    over a stream zero-padded to `cap` entries with reads clipped to
    [0, cap-1], the reference's decode reads; only the first
    `stream.numel()` entries are stored."""
    q = p.clamp(0, cap - 1)
    if stream.numel() == 0:
        return torch.zeros_like(q)
    got = stream[q.clamp(max=stream.numel() - 1)]
    return torch.where(q < stream.numel(), got, torch.zeros_like(got))


def rans_decode_ref(stream: torch.Tensor, cap: int, freqs: torch.Tensor,
                    states: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor):
    """Forward decode of C chunks to their (C, T, N_LANES) byte grids,
    batched as the reference's `vmap` of `decode_rows` is. `offsets` are
    each lane's ABSOLUTE start into the u16 `stream`; reads behave as over
    a zero-padded `cap`-entry stream. Returns int32[C, T, N]."""
    c, t_rows, n = mask.shape
    fr = bits._u(freqs)
    cum = cum_freqs(freqs) & M32
    lut = slot_table(freqs)
    su = bits._u(stream)
    m = mask.to(torch.bool)
    x = bits._u(states)
    p = offsets.to(torch.int64)
    out = torch.zeros((c, t_rows, n), dtype=torch.int32, device=mask.device)
    for t in range(t_rows):
        mt = m[:, t]
        slot = x & (PROB_SCALE - 1)
        sym = lut[slot]
        x2 = (fr[sym] * (x >> PROB_BITS) + slot - cum[sym]) & M32
        need = mt & (x2 < RANS_L)
        w = _read_stream(su, p, cap)
        x3 = torch.where(need, ((x2 << 16) | w) & M32, x2)
        x = torch.where(mt, x3, x)
        p = p + need.to(torch.int64)
        out[:, t] = torch.where(mt, sym, torch.zeros_like(sym)).to(torch.int32)
    return out


def unpack_u16(words: torch.Tensor, total: int) -> torch.Tensor:
    """The first `total` u16s of words packed two to a word, low half
    first: int32[total] (values 0..65535)."""
    u = bits._u(words)
    return torch.stack([u & 0xFFFF, u >> 16], dim=1).reshape(-1)[:total].to(torch.int32)


def rans_section_decode_ref(words: torch.Tensor, total: int, freqs: torch.Tensor,
                            states: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """B9's section form: the u16s unpacked from the packed words, the
    section's chunk-grid mask, `rans_decode_ref` from the lanes' exclusive
    offsets with `cap = decode_cap(C)`, the n bytes narrowed to uint8[n]."""
    c = states.shape[0]
    mask = (torch.arange(c * rans.CHUNK_BYTES, device=words.device) < n).reshape(
        c, rans.ROWS, rans.N_LANES)
    syms = rans_decode_ref(unpack_u16(words, total), rans.decode_cap(c), freqs, states,
                           rans.lane_offsets(counts), mask)
    return syms.reshape(-1)[:n].to(torch.uint8)


# ---------------------------------------------------------------- delta_nuq --
def _quantize(d: torch.Tensor, thr: torch.Tensor, dec: torch.Tensor):
    """Signed mu-law quantization of float32 deltas on the magnitude tables
    (`delta_nuq.quantizer`): (sign, magnitude code, dequantized value)."""
    neg = d < 0
    mag = torch.searchsorted(thr, d.abs(), right=True)
    m = dec[mag]
    return neg, mag, torch.where(neg, -m, m)


def _signed_codes(neg: torch.Tensor, mag: torch.Tensor, qbits: int) -> torch.Tensor:
    return (neg.to(torch.int32) << (qbits - 1)) | mag.to(torch.int32)


def delta_nuq_encode_ref(x: torch.Tensor, qbits: int, dmax: float, mu: float, t_tile: int):
    """The Pallas contract of B6: x float32[S, T] -> codes int32[S, T]
    (uint32 bits). Each t_tile tile starts from its raw sample, bit-cast
    into code[0]; later codes quantize the clipped delta against the
    running float reconstruction, dequantized without integer snapping.
    (The kernel body's `(mu * |d|) / dmax` and its oracle's `mu * (|d| /
    dmax)` fold to the same jitted constant, so one table serves both.)"""
    s, t = x.shape
    xt = x.reshape(s, t // t_tile, t_tile)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, False, x.device)
    lim = delta_nuq.f32(dmax)
    neg = torch.zeros(xt.shape, dtype=torch.bool, device=x.device)
    mag = torch.zeros(xt.shape, dtype=torch.int64, device=x.device)
    xhat = xt[..., 0]
    for k in range(1, t_tile):
        neg[..., k], mag[..., k], dq = _quantize((xt[..., k] - xhat).clamp(-lim, lim), thr, dec)
        xhat = xhat + dq
    codes = _signed_codes(neg, mag, qbits)
    codes[..., 0] = xt[..., 0].contiguous().view(torch.int32)  # the raw reference sample
    return codes.reshape(s, t)


def delta_nuq_decode_ref(codes: torch.Tensor, qbits: int, dmax: float, mu: float, t_tile: int):
    """The Pallas contract of B7: codes int32[S, T] -> float32[S, T], a
    running float32 sum per tile from its bit-cast raw sample."""
    s, t = codes.shape
    ct = codes.reshape(s, t // t_tile, t_tile)
    dq = nuq.mulaw_decode_signed(ct, qbits, dmax, mu, round_int=False)
    out = torch.empty(ct.shape, dtype=torch.float32, device=codes.device)
    xhat = ct[..., 0].contiguous().view(torch.float32)
    out[..., 0] = xhat
    for k in range(1, t_tile):
        xhat = xhat + dq[..., k]
        out[..., k] = xhat
    return out.reshape(s, t)


def adpcm_lane_encode_ref(blocks: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                          qbits: int, vmax: float, dmax: float, mu: float, width: int):
    """The ADPCM codec's encode (`repro/core/algorithms/adpcm.py`) over C
    blocks int32[C, L, B], as one per-lane scan of each lane's C*B tuples
    from the state (xhat float32[L], init bool[L]): the input clips to vmax,
    a fresh lane's first symbol is its raw 32-bit tuple (bitlen 32), deltas
    clip to +-dmax and dequantize snapped to integers, and the
    reconstruction clips to [0, vmax]. Returns (codes int32[C, L, B, 2],
    bitlen int32[C, L, B], xhat, init)."""
    c, lanes, b = blocks.shape
    dev = blocks.device
    codes = torch.zeros((c, lanes, b, 2), dtype=torch.int32, device=dev)
    bitlen = torch.full((c, lanes, b), width, dtype=torch.int32, device=dev)
    if c * b == 0:
        return codes, bitlen, xhat.clone(), init.clone()
    x = blocks.permute(1, 0, 2).reshape(lanes, c * b)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, True, dev)
    lim, top = delta_nuq.f32(dmax), delta_nuq.f32(vmax)
    xf = bits._u(x).clamp(max=delta_nuq.u32_limit(vmax)).to(torch.float32)
    fresh = ~init
    xhat = torch.where(fresh, xf[:, 0], xhat)
    neg = torch.empty((lanes, c * b), dtype=torch.bool, device=dev)
    mag = torch.empty((lanes, c * b), dtype=torch.int64, device=dev)
    for k in range(c * b):
        neg[:, k], mag[:, k], dq = _quantize((xf[:, k] - xhat).clamp(-lim, lim), thr, dec)
        xhat = (xhat + dq).clamp(0.0, top)
    codes[..., 0] = _signed_codes(neg, mag, qbits).reshape(lanes, c, b).permute(1, 0, 2)
    # a fresh lane's stream starts at block 0, tuple 0: the raw reference symbol
    codes[0, :, 0, 0] = torch.where(fresh, blocks[0, :, 0], codes[0, :, 0, 0])
    bitlen[0, :, 0] = torch.where(fresh, 32, width)
    return codes, bitlen, xhat, torch.ones_like(init)


def adpcm_lane_decode_ref(codes: torch.Tensor, xhat: torch.Tensor, init: torch.Tensor,
                          qbits: int, vmax: float, dmax: float, mu: float):
    """The ADPCM codec's decode over C blocks' codes int32[C, L, B, 2]
    (word 0): the clipped accumulation from the state, a fresh lane
    restarting at its raw symbol, rounded to uint32 with saturation.
    Returns (values int32[C, L, B], xhat, init)."""
    c, lanes, b, _ = codes.shape
    if c * b == 0:
        empty = torch.zeros((c, lanes, b), dtype=torch.int32, device=codes.device)
        return empty, xhat.clone(), init.clone()
    cw = codes[..., 0].permute(1, 0, 2).reshape(lanes, c * b)
    top = delta_nuq.f32(vmax)
    dq = nuq.mulaw_decode_signed(cw, qbits, dmax, mu)
    fresh = ~init
    raw = bits._u(cw[:, 0]).clamp(max=delta_nuq.u32_limit(vmax)).to(torch.float32)
    xhat = torch.where(fresh, raw, xhat)
    dq[:, 0] = torch.where(fresh, 0.0, dq[:, 0])
    out = torch.empty((lanes, c * b), dtype=torch.float32, device=codes.device)
    for k in range(c * b):
        xhat = (xhat + dq[:, k]).clamp(0.0, top)
        out[:, k] = xhat
    values = nuq.to_u32_saturating(torch.round(out))
    return values.reshape(lanes, c, b).permute(1, 0, 2).contiguous(), xhat, torch.ones_like(init)


def _dense_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int], causal: bool, softcap: Optional[float] = None):
    """(masked scaled float32 scores (B, H, Sq, Sk), v float32 grouped to H
    heads) of `flash_reference`: scaled, then capped to `softcap * tanh(s /
    softcap)` when a cap is given, then masked (the reference's order)."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    kk = k.to(torch.float32).repeat_interleave(g, dim=2)
    vv = v.to(torch.float32).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kk) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, -1e30)
    return s, vv


def flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None, causal: bool = True,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Dense GQA attention, q (B, Sq, H, Dh) against k/v (B, Sk, K, Dh) at
    positions arange(Sq) x arange(Sk): softmax over the scores in float32 on
    inputs converted to float32, each scaled score s of an unmasked key
    capped to `softcap * tanh(s / softcap)` when `softcap` is given, masked
    scores at -1e30, the output in q's dtype. Query head h reads kv head
    h // (H/K) (the reference's `jnp.repeat(k, G, axis=2)`)."""
    s, vv = _dense_scores(q, k, v, window, causal, softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def flash_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None, causal: bool = True,
                        softcap: Optional[float] = None):
    """`flash_reference` and each query row's log-sum-exp of its scaled,
    capped, masked scores, float32 (B, H, Sq): (out, lse), the plain
    version of `ops.flash_attention_fwd_lse`."""
    s, vv = _dense_scores(q, k, v, window, causal, softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype), torch.logsumexp(s, dim=-1)
