"""NUQ-compressed KV cache: CStream's mu-law quantizer on the decode path
(port of `repro/core/kvcache.py`).

Layout: codes uint8[L, B, W, K, Dh] and scales float32[L, B, W // G, K],
one absmax scale per (group of G = 128 ring slots, kv head). A prefill
quantizes whole groups (`quantize_block`); a decode step appends one token
against the current group's scale (`append_token_layer`) and reads the ring
back block by block, dequantizing through a 256-entry table
(`dequantize_block_kmajor`) inside the reference's flash step.

The encoder is the port's host-built mu-law threshold table at (7 bits,
vmax 1.0) (`core/algorithms/nuq.py`, ROADMAP C2), which follows the
reference's jitted quantizer; the dequantization table is the reference's
own float64 construction, copied. Writes update the cache tensors in place.

`decode_attend_dlse` has the reference's two branches. Without a mesh (or
with a model axis of one slot) it appends the token and scans the whole
ring; a ring held as shards is read and written per data shard on the
shard's slot (`per_data_shard`). Under a mesh and logical mapping (`models/partition.py`) whose model
axis splits the ring, each slot appends the token if the slot is its own and
scans only its slice of the ring (W over the model slots, B over the data
slots when B > 1), and the slots' (m, l, acc) statistics merge by a
log-sum-exp over the model axis (`compat.pmax`/`psum`): the explicit form
of the reference's `shard_map`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.algorithms.nuq import mulaw_decode_unsigned, mulaw_encode_unsigned
from repro_torch.core.device import DeviceLike, on_device, resolve_device
from repro_torch.models import partition

SCALE_GROUP = 128  # tokens per quantization scale group


def _build_dequant_table(qbits: int = 8) -> np.ndarray:
    """All 2^qbits signed mu-law reconstructions, in float64 rounded once to
    float32 (the reference's table, copied)."""
    codes = np.arange(1 << qbits, dtype=np.uint32)
    sign = (codes >> (qbits - 1)) & 1
    mag_mask = (1 << (qbits - 1)) - 1
    levels = (1 << (qbits - 1)) - 1
    y = (codes & mag_mask).astype(np.float64) / levels
    mag = (np.power(1.0 + 255.0, y) - 1.0) / 255.0
    return np.where(sign == 1, -mag, mag).astype(np.float32)


_DEQUANT_TABLE_8 = _build_dequant_table(8)
_TABLES: Dict[tuple, torch.Tensor] = {}


def dequant_table(qbits: int, device) -> torch.Tensor:
    """`_build_dequant_table(qbits)` as a float32 tensor on `device`, cached."""
    key = (qbits, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        table = _DEQUANT_TABLE_8 if qbits == 8 else _build_dequant_table(qbits)
        t = _TABLES[key] = torch.from_numpy(table.copy()).to(device)
    return t


@dataclasses.dataclass
class QuantKVCache:
    """One layer-stacked quantized KV cache (the reference's form; the
    serving paths keep the same tensors in a dict ring)."""

    k_codes: torch.Tensor  # uint8 [L, B, W, K, Dh]
    v_codes: torch.Tensor  # uint8 [L, B, W, K, Dh]
    k_scale: torch.Tensor  # float32 [L, B, W // G, K]
    v_scale: torch.Tensor  # float32 [L, B, W // G, K]
    length: torch.Tensor  # int32 [] tokens currently valid (ring if > W)

    @property
    def window(self) -> int:
        return self.k_codes.shape[2]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The fields by name, the tensors themselves (no copies)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def init_cache(n_layers: int, batch: int, window: int, kv_heads: int, head_dim: int,
               device: DeviceLike = None) -> QuantKVCache:
    """Zero codes, scales of one (G = min(128, window) slots a scale), length
    0, on `device` (the card unless the caller names another)."""
    dev = resolve_device(device)
    g = min(SCALE_GROUP, window)
    codes = (n_layers, batch, window, kv_heads, head_dim)
    scales = (n_layers, batch, window // g, kv_heads)
    return QuantKVCache(
        k_codes=torch.zeros(codes, dtype=torch.uint8, device=dev),
        v_codes=torch.zeros(codes, dtype=torch.uint8, device=dev),
        k_scale=torch.ones(scales, dtype=torch.float32, device=dev),
        v_scale=torch.ones(scales, dtype=torch.float32, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _signed_codes(xn: torch.Tensor, qbits: int) -> torch.Tensor:
    """Normalized float32 values in [-1, 1] -> uint8 codes: a sign bit over
    a (qbits - 1)-bit mu-law magnitude."""
    sign = (xn < 0).to(torch.int32)
    mag = mulaw_encode_unsigned(xn.abs(), qbits - 1, 1.0)
    return ((sign << (qbits - 1)) | mag).to(torch.uint8)


# ----------------------------------------------------------- quant / deq --
def quantize_block(x: torch.Tensor, qbits: int = 8):
    """x (B, S, K, Dh) -> (codes uint8 (B, S, K, Dh), scale float32
    (B, S // G, K)): absmax (+ 1e-6) per group of G = min(128, S) tokens and
    kv head, then a signed mu-law code of x / scale."""
    b, s, kh, dh = x.shape
    g = min(SCALE_GROUP, s)
    xg = x.reshape(b, s // g, g, kh, dh).to(torch.float32)
    scale = xg.abs().amax(dim=(2, 4)) + 1e-6
    xn = xg / scale[:, :, None, :, None]
    return _signed_codes(xn, qbits).reshape(b, s, kh, dh), scale


def dequantize_block(codes: torch.Tensor, scale: torch.Tensor, qbits: int = 8,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """codes (B, S, K, Dh) + scale (B, S // G, K) -> values (B, S, K, Dh),
    through the quantizer's continuous decode table."""
    b, s, kh, dh = codes.shape
    g = min(SCALE_GROUP, s)
    c = codes.to(torch.int32).reshape(b, s // g, g, kh, dh)
    mag = mulaw_decode_unsigned(c & ((1 << (qbits - 1)) - 1), qbits - 1, 1.0, round_int=False)
    xn = torch.where(((c >> (qbits - 1)) & 1) == 1, -mag, mag)
    x = xn * scale[:, :, None, :, None]
    return x.reshape(b, s, kh, dh).to(dtype)


def dequantize_block_kmajor(codes: torch.Tensor, scale: torch.Tensor, ring_w: int,
                            qbits: int = 8, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """codes (B, C, K, Dh) + scale (B, C // G, K) -> values (B, K, C, Dh):
    the uint8 codes are moved into the attention layout before the table
    lookup widens them."""
    b, c, kh, dh = codes.shape
    g = min(SCALE_GROUP, ring_w)
    ct = codes.transpose(1, 2).reshape(b, kh, c // g, g, dh)
    xn = dequant_table(qbits, codes.device)[ct.to(torch.int64)]
    st = scale.transpose(1, 2)[:, :, :, None, None]  # (B, K, C // G, 1, 1)
    return (xn * st).to(dtype).reshape(b, kh, c, dh)


# ----------------------------------------------------------------- writes --
def prefill_layer(cache: Union[QuantKVCache, Dict[str, torch.Tensor]], layer: int, k: torch.Tensor,
                  v: torch.Tensor) -> Union[QuantKVCache, Dict[str, torch.Tensor]]:
    """Write a whole prefill (B, S <= W, K, Dh) for one layer at slot 0 of a
    layer-stacked quantized cache ({k,v}_codes (L, B, W, K, Dh), {k,v}_scale
    (L, B, W // G, K)), a `QuantKVCache` or the same tensors in a dict, in
    place: S padded with zeros to a multiple of the scale group, then
    quantized. Sets the length to S (a 0-d int32 tensor in a
    `QuantKVCache`, an int in a dict)."""
    t = cache.tensors() if isinstance(cache, QuantKVCache) else cache
    s = k.shape[1]
    g = min(SCALE_GROUP, t["k_codes"].shape[2])
    pad = (-s) % g
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kc, ks = quantize_block(k)
    vc, vs = quantize_block(v)
    n = kc.shape[1]
    t["k_codes"][layer, :, :n] = kc
    t["v_codes"][layer, :, :n] = vc
    t["k_scale"][layer, :, :ks.shape[1]] = ks
    t["v_scale"][layer, :, :vs.shape[1]] = vs
    if isinstance(cache, QuantKVCache):
        cache.length = torch.tensor(s, dtype=torch.int32, device=cache.k_codes.device)
    else:
        cache["length"] = s
    return cache


def append_token_layer(cache_layer: dict, k_t: torch.Tensor, v_t: torch.Tensor, pos: int) -> dict:
    """Append one token (B, 1, K, Dh) to a single layer's ring at slot
    pos % W, in place. The token is quantized against its group's current
    scale (set at prefill), clipped to [-1, 1]."""
    w = cache_layer["k_codes"].shape[1]
    slot = pos % w
    g = min(slot // min(SCALE_GROUP, w), cache_layer["k_scale"].shape[1] - 1)

    def write(codes, scale, x):
        s = scale[:, g, :]  # (B, K)
        xn = torch.clamp(x[:, 0].to(torch.float32) / s[..., None], -1.0, 1.0)
        codes[:, slot] = _signed_codes(xn, 8)

    write(cache_layer["k_codes"], cache_layer["k_scale"], k_t)
    write(cache_layer["v_codes"], cache_layer["v_scale"], v_t)
    return cache_layer


# ------------------------------------------------------------------ reads --
def _flash_quant_stats(q: torch.Tensor, cache_layer: dict, pos: int, window: Optional[int],
                       kv_block: int, softcap: Optional[float], slot_base: int = 0,
                       ring_w: Optional[int] = None):
    """Blocked flash statistics over one layer's quantized ring, or a
    slot's slice of it: q (B, 1, H, Dh) against the slice's W slots in
    blocks of C keys (the largest multiple of the scale group up to
    `kv_block` that divides W). `slot_base` is the slice's first ring slot
    and `ring_w` the whole ring's size (W when None), for the positions.
    Returns unnormalized (m, l, acc) float32."""
    from repro_torch.models.layers import _chunk_attn_update

    b, _, h, dh = q.shape
    w = cache_layer["k_codes"].shape[1]
    kh = cache_layer["k_codes"].shape[2]
    grp = h // kh
    dev = q.device
    q_ = q.transpose(1, 2)  # (B, H, 1, Dh)

    g_eff = min(SCALE_GROUP, w)
    c = g_eff
    for cand in range(min(kv_block, w), g_eff - 1, -g_eff):
        if w % cand == 0:
            c = cand
            break
    ring = ring_w or w
    slots = slot_base + torch.arange(w, device=dev)
    # slot s holds absolute position s before the ring wraps, else the latest
    # p <= pos with p % ring == s
    abs_pos = pos - torch.remainder(pos - slots, ring) if pos >= ring else slots
    valid = (abs_pos <= pos) & (slots < ring)
    if window is not None:
        valid = valid & (abs_pos > pos - window)

    m = torch.full((b, kh, grp, 1), -float("inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, grp, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, grp, 1, dh), dtype=torch.float32, device=dev)
    gpb = c // g_eff
    for j in range(w // c):
        blk, gblk = slice(j * c, (j + 1) * c), slice(j * gpb, (j + 1) * gpb)
        k_blk = dequantize_block_kmajor(cache_layer["k_codes"][:, blk], cache_layer["k_scale"][:, gblk], ring)
        v_blk = dequantize_block_kmajor(cache_layer["v_codes"][:, blk], cache_layer["v_scale"][:, gblk], ring)
        mask = valid[blk][None, None, :].expand(b, 1, c)
        m, l, acc = _chunk_attn_update(q_, k_blk, v_blk, mask, m, l, acc, softcap)
    return m, l, acc


def decode_attention_quant(q: torch.Tensor, cache_layer: dict, pos: int, window: Optional[int],
                           kv_block: int = 2048, softcap: Optional[float] = None) -> torch.Tensor:
    """Blocked decode attention of q (B, 1, H, Dh) over the quantized ring
    (single view): (B, 1, H, Dh) in q's dtype."""
    b, _, h, dh = q.shape
    m, l, acc = _flash_quant_stats(q, cache_layer, pos, window, kv_block, softcap)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, 1, dh).transpose(1, 2).to(q.dtype)


def _append_local(cl: dict, k_t: torch.Tensor, v_t: torch.Tensor, pos: int, ring_w: int,
                  slot_base: int, w_local: int) -> None:
    """Write the token (B, 1, K, Dh) into a slot's slice of the ring (its
    first ring slot `slot_base`, `w_local` slots) iff ring slot
    pos % ring_w is in it, in place; quantized against its group's scale."""
    slot = pos % ring_w
    if not slot_base <= slot < slot_base + w_local:
        return
    local = slot - slot_base
    g = min(local // min(SCALE_GROUP, ring_w), cl["k_scale"].shape[1] - 1)
    for codes, scale, x in ((cl["k_codes"], cl["k_scale"], k_t), (cl["v_codes"], cl["v_scale"], v_t)):
        xn = torch.clamp(x[:, 0].to(torch.float32) / scale[:, g, :][..., None], -1.0, 1.0)
        codes[:, local] = _signed_codes(xn, 8)


def lse_merge(stats, devices, dtype: torch.dtype):
    """Merge the slots' (m, l, acc) statistics of one model group by a
    log-sum-exp over the group: m_g = pmax(m), l_g = psum(l e^(m - m_g)),
    acc_g = psum(acc e^(m - m_g)). Returns each slot's normalized output
    (B, 1, H, Dh) in `dtype`."""
    m_g = compat.pmax([st[0] for st in stats], devices)
    wts = [torch.exp(st[0] - mg) for st, mg in zip(stats, m_g)]
    l_g = compat.psum([st[1] * wt for st, wt in zip(stats, wts)], devices)
    acc_g = compat.psum([st[2] * wt[..., None] for st, wt in zip(stats, wts)], devices)
    outs = []
    for lg, ag in zip(l_g, acc_g):
        o = ag / torch.clamp(lg[..., None], min=1e-30)
        b, kh, grp, _, dh = o.shape
        outs.append(o.reshape(b, kh * grp, 1, dh).transpose(1, 2).to(dtype))
    return outs


def decode_attend_dlse(q: torch.Tensor, cache_layer: dict, k_t: torch.Tensor, v_t: torch.Tensor,
                       pos: int, window: Optional[int], kv_block: int = 2048,
                       softcap: Optional[float] = None):
    """The reference's decode attention (DESIGN.md §8): returns (attn_out
    (B, 1, H, Dh), cache_layer), the cache updated in place.

    Without a mesh and mapping, with a model axis of one slot, a ring W
    that the model slots do not divide, or a model entry naming several
    axes, the single view: append the token at its slot, then scan the
    whole ring. Otherwise the distributed-LSE branch: the ring's W is split
    over the model slots and B over the data slots when B > 1; each slot
    appends the token if its slice holds the slot, scans only its slice,
    and the (m, l, acc) triples of a data group's model slots merge as
    m_g = pmax(m), l_g = psum(l e^(m - m_g)), acc_g = psum(acc e^(m - m_g)).
    The cache's leaves may be `runtime/sharding.Sharded` (one shard per
    slot) or whole tensors; a whole ring is cut into per-slot views (copies
    written back when a slot's device is another)."""
    from repro_torch.runtime.sharding import Placement, Sharded

    axes, mesh = partition.current_axes(), partition.current_mesh()
    m_entry = axes.get("model") if axes else None
    d_entry = axes.get("data") if axes else None
    b, _, h, dh = q.shape
    w = cache_layer["k_codes"].shape[1]
    n_model = 1
    if m_entry is not None and mesh is not None and isinstance(m_entry, str) and m_entry in mesh.axis_names:
        n_model = partition.axis_size(m_entry, mesh)
    if m_entry is None or n_model == 1 or w % n_model != 0 or not isinstance(m_entry, str):
        if not any(isinstance(t, Sharded) for t in cache_layer.values()):
            cache_layer = append_token_layer(cache_layer, k_t, v_t, pos)
            return decode_attention_quant(q, cache_layer, pos, window, kv_block, softcap), cache_layer

        def single(rows, whole, dev):
            append_token_layer(whole, k_t[rows].to(dev), v_t[rows].to(dev), pos)
            return decode_attention_quant(q[rows].to(dev), whole, pos, window, kv_block, softcap)

        return join_rows(per_data_shard(cache_layer, b, single), q.device), cache_layer

    w_local = w // n_model
    dax = d_entry if b > 1 else None
    specs = {"k_codes": (dax, m_entry), "v_codes": (dax, m_entry), "k_scale": (dax, m_entry),
             "v_scale": (dax, m_entry)}
    local, back = {}, []
    for k, t in cache_layer.items():
        pl = Placement(mesh, specs[k])
        if isinstance(t, Sharded) and (t.placement.entry(0), t.placement.entry(1)) == specs[k]:
            local[k] = t.shards
            continue
        whole = t.gather() if isinstance(t, Sharded) else t
        views = [whole[pl.slices(whole.shape, s)].to(d) for s, d in enumerate(mesh.devices)]
        local[k] = views
        back.append((t, whole, pl, views))
    tok = Placement(mesh, (dax,))
    stats = []
    for s, dev in enumerate(mesh.devices):
        sl = tok.slices(q.shape, s)[:1]
        cl = {k: local[k][s] for k in local}
        base = compat.shard_index(mesh, s, (m_entry,)) * w_local
        with on_device(dev):
            _append_local(cl, k_t[sl].to(dev), v_t[sl].to(dev), pos, w, base, w_local)
            stats.append(_flash_quant_stats(q[sl].to(dev), cl, pos, window, kv_block, softcap,
                                            slot_base=base, ring_w=w))
    outs = [None] * mesh.size
    for grp in compat.groups(mesh, (m_entry,)):
        for s, o in zip(grp, lse_merge([stats[s] for s in grp], [mesh.devices[s] for s in grp], q.dtype)):
            outs[s] = o
    # the first slot of each data shard holds its rows
    out = torch.cat([outs[s].to(q.device) for s in partition.lead_slots(mesh, partition.axis_names(dax))],
                    dim=0)
    for t, whole, pl, views in back:
        for s, view in enumerate(views):
            dst = whole[pl.slices(whole.shape, s)]
            if view.data_ptr() != dst.data_ptr() or view.device != dst.device:
                dst.copy_(view)
        if isinstance(t, Sharded):
            t.write(whole)
    return out, cache_layer


def per_data_shard(leaves, batch: int, fn):
    """Run fn(rows, whole, device) once per data shard of the active mapping
    and mesh, on the shard's first slot: `whole` holds each `Sharded` leaf
    of one layer's ring (batch first) gathered over the other axes (the
    shard's rows of the whole ring), `rows` the shard's slice of the batch
    (every row when the data axes do not split it); the leaves written back
    into the shards of the slots that hold those rows. Returns ([fn's
    result per shard], whether the data axes split the batch)."""
    mesh = next(iter(leaves.values())).mesh
    dax, n = partition.data_shards()
    daxes = partition.axis_names(dax)
    keep = tuple(a for a in mesh.axis_names if a not in daxes)
    split = n > 1 and next(iter(leaves.values())).placement.entry(0) is not None
    outs = []
    for i, slot in enumerate(partition.lead_slots(mesh, daxes) if daxes else [0]):
        dev = mesh.devices[slot]
        rows = slice(i * batch // n, (i + 1) * batch // n) if split else slice(None)
        whole = {k: t.gather_over(keep, slot) for k, t in leaves.items()}
        with on_device(dev):
            outs.append(fn(rows, whole, dev))
        for k, t in leaves.items():
            t.write_over(keep, slot, whole[k])
    return outs, split


def join_rows(result, device) -> Optional[torch.Tensor]:
    """`per_data_shard`'s results as one batch on `device`: the shards'
    rows joined (`compat.all_gather`), or the first shard's when the data
    axes do not split the batch."""
    outs, split = result
    if outs[0] is None:
        return None
    return compat.all_gather(outs, [device], dim=0)[0] if split else outs[0].to(device)


def cache_bytes(cache: Union[QuantKVCache, Dict[str, torch.Tensor]]) -> int:
    """Bytes of a ring's tensors (codes and scales, or raw K/V), or of a
    `QuantKVCache`'s (its 4-byte length included, as the reference counts)."""
    ts = cache.tensors() if isinstance(cache, QuantKVCache) else cache
    return sum(t.numel() * t.element_size() for t in ts.values())


# ---------------------------------------------------- tensor parallelism --
def _flash_raw_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, window: Optional[int],
                     kv_block: int, softcap: Optional[float], slot_base: int, ring_w: int):
    """`_flash_quant_stats` over a slot's slice of a raw ring: k/v (B,
    W_local, K, Dh) in the cache dtype, in blocks of up to `kv_block` keys."""
    from repro_torch.models.layers import _chunk_attn_update

    b, _, h, dh = q.shape
    w, kh = k.shape[1], k.shape[2]
    grp = h // kh
    dev = q.device
    slots = slot_base + torch.arange(w, device=dev)
    abs_pos = pos - torch.remainder(pos - slots, ring_w) if pos >= ring_w else slots
    valid = (abs_pos <= pos) & (slots < ring_w)
    if window is not None:
        valid = valid & (abs_pos > pos - window)
    m = torch.full((b, kh, grp, 1), -float("inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, grp, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, grp, 1, dh), dtype=torch.float32, device=dev)
    q_ = q.transpose(1, 2)
    c = min(kv_block, w)
    for j in range(0, w, c):
        blk = slice(j, min(j + c, w))
        n = blk.stop - blk.start
        mask = valid[blk][None, None, :].expand(b, 1, n)
        m, l, acc = _chunk_attn_update(q_, k[:, blk].transpose(1, 2), v[:, blk].transpose(1, 2), mask,
                                       m, l, acc, softcap)
    return m, l, acc


def decode_attend_group(g, qs, rings, kts, vts, pos: int, window: Optional[int], kv_block: int = 2048,
                        softcap: Optional[float] = None):
    """The distributed-LSE decode over a model group (tensor parallelism):
    qs[i] (B, 1, H, Dh) every head on slot i, rings[i] the slot's slice of
    one layer's ring (W / n slots, quantized or raw), kts/vts[i] the token's
    K/V (B, 1, K, Dh) on every kv head. Each slot writes the token if its
    slice holds ring slot pos % W, scans its slice, and the statistics
    merge over the group (`lse_merge`). Returns each slot's output (B, 1,
    H, Dh); the rings are updated in place."""
    quant = "k_codes" in rings[0]
    w_local = rings[0]["k_codes" if quant else "k"].shape[1]
    ring_w = w_local * g.n

    def one(i, q, cl, kt, vt):
        base = i * w_local
        if quant:
            _append_local(cl, kt, vt, pos, ring_w, base, w_local)
            return _flash_quant_stats(q, cl, pos, window, kv_block, softcap, slot_base=base, ring_w=ring_w)
        slot = pos % ring_w
        if base <= slot < base + w_local:
            cl["k"][:, slot - base] = kt[:, 0].to(cl["k"].dtype)
            cl["v"][:, slot - base] = vt[:, 0].to(cl["v"].dtype)
        return _flash_raw_stats(q, cl["k"], cl["v"], pos, window, kv_block, softcap, base, ring_w)

    return lse_merge(g.map(one, qs, rings, kts, vts), g.devices, qs[0].dtype)


def store_slice(cache_l: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor, base: int, ring_w: int,
                quant: bool, store) -> None:
    """Write a prefill's K/V (B, S, K, Dh) at positions [0, S) into a
    slot's slice of one layer's ring (its first ring slot `base`, of a ring
    of `ring_w`), in place. Without wrapping (S <= W) the slot quantizes
    only its positions (a slice of whole scale groups, as the ring splits
    them); else `store(whole, k, v)` writes a whole ring on the slot, whose
    slice is copied."""
    name = "k_codes" if quant else "k"
    w_local = cache_l[name].shape[1]
    s = k.shape[1]
    if s > ring_w:
        whole = {n: torch.full((t.shape[0], t.shape[1] * ring_w // w_local) + tuple(t.shape[2:]),
                               1.0 if n.endswith("scale") else 0, dtype=t.dtype, device=t.device)
                 for n, t in cache_l.items()}
        store(whole, k, v)
        for n, t in cache_l.items():
            per = t.shape[1]
            t.copy_(whole[n][:, base // w_local * per:(base // w_local + 1) * per])
        return
    end = min(base + w_local, s)
    if end <= base:
        return
    kk, vv = k[:, base:end], v[:, base:end]
    if not quant:
        cache_l["k"][:, :end - base] = kk.to(cache_l["k"].dtype)
        cache_l["v"][:, :end - base] = vv.to(cache_l["v"].dtype)
        return
    grp = min(SCALE_GROUP, ring_w)
    pad = (-(end - base)) % grp
    padded = (0, 0, 0, 0, 0, pad)
    kq, ks = quantize_block(torch.nn.functional.pad(kk, padded))
    vq, vs = quantize_block(torch.nn.functional.pad(vv, padded))
    cache_l["k_codes"][:, :end - base] = kq[:, :end - base]
    cache_l["v_codes"][:, :end - base] = vq[:, :end - base]
    cache_l["k_scale"][:, :ks.shape[1]] = ks
    cache_l["v_scale"][:, :vs.shape[1]] = vs
