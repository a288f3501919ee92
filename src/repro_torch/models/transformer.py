"""Decoder backbone for the dense, moe, ssm and hybrid families (port of
`repro/models/transformer.py`).

GQA + RoPE + SwiGLU (with qwen3's per-head q/k norm), as `nn.Module`s:
`Transformer` holds the embedding, the final norm, the head when it is not
tied, and its blocks: in `layers`, a `DenseBlock` (`Attention`, `SwiGLU`
and two norms) per layer for the dense family, a `MoEBlock` (`Attention`,
`moe.MoEFFN` and two norms) for the moe family (mixtral, qwen3-moe), an
`SSMBlock` (a norm and `ssd.Mamba2`) for the ssm family (mamba2); for the
hybrid family (RecurrentGemma) `groups` of `HybridGroup`s (two
`RecSublayer`s, each an `rglru.RGLRU` and a SwiGLU, then local attention
and a SwiGLU) and a `tail` of `RecSublayer`s. Parameters keep the
reference's names and layout (`x @ w` with `w` of shape (d_in, d_out),
norm gammas as offsets from 1), so the reference's parameter tree carries
across without transposes (`models/convert.py`).

Two storages, one set of modules, chosen by `Transformer(cfg, device,
param_dtype=...)`:
  * serving (`param_dtype=None`): parameters in `cfg.dtype`, without
    gradients;
  * training (`param_dtype=cfg.param_dtype`, float32): master parameters
    with `requires_grad=True`, cast to `cfg.dtype` at every use, as the
    reference's `_cast` does (`params()`, `p()`).

The API of the reference: `init_params`, `forward` (each block through
`layers.attention_train`, kernel B10 with its log-sum-exp and the flash
backward, under `torch.utils.checkpoint` when `cfg.remat == "full"`; the
moe blocks' load-balance losses summed), `loss_fn`, and for serving
`init_decode_cache`, `prefill` (writes the ring cache, NUQ-quantized by
default) and `decode_step`. Prefill attention runs kernel B10
(`ops.flash_attention_fwd`); the decode reads the quantized ring in plain
torch (`core/kvcache.py`). An moe block routes all B*S tokens of a prefill,
or the B tokens of a decode step, in one call, as the reference does:
capacity and drops depend on them all. The recurrent blocks carry their
state in the cache (ssm: `layers/ssm_state` and `layers/conv_tail`;
hybrid: `groups/{rec1,rec2}/{h,conv_tail}`, `groups/attn/<ring>` and
`tail/{h,conv_tail}`, the reference's layout); the hybrid family's local
attention prefills on B10 with `cfg.local_window` and decodes over its
ring. The cache is a dict of tensors updated in place, with `pos` a Python
int. Inputs are int tokens, or for `cfg.input_kind == "embeddings"`
(musicgen-large, pixtral-12b: the front ends of `models/frontends.py`)
(B, S, D) embeddings cast to the compute dtype; the `embed` table stays,
as the head when tied and as the rows serving feeds back. Attention takes
`cfg.attn_logit_softcap` in every path: B10 and its lse form, the flash
backward, both decode reads.

Under a mesh and logical mapping (`models/partition.py`), the reference's
`partition.hint` sites are kept (the identity on whole tensors, a shape
check inside a slot's program), the rings of the decode cache are held as
`runtime/sharding.Sharded` per `sharding.cache_specs` (batch over data,
ring over model; the recurrent states stay whole), a prefill writes each
layer's shards from its whole K/V, its B10 attention runs per data shard
on the shard's slot, the decode reads the ring through the
distributed-LSE branch of `kvcache.decode_attend_dlse`, and an moe block
dispatches per data shard (`models/moe.py`). Weights stay whole: the model
axis's compute is not split (the next ROADMAP item).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.core import kvcache
from repro_torch.core.device import on_device, resolve_device
from repro_torch.models import layers, partition, rglru, ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEFFN
from repro_torch.models.params import Storage, _Params

Device = Union[None, str, torch.device]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype `cfg.dtype` as a torch dtype."""
    return getattr(torch, cfg.dtype)


class Attention(_Params):
    """GQA projections (`wq`, `wk`, `wv`, `wo`) and qwen3's `q_norm`/`k_norm`."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(store)
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self._add("wq", (d, h * dh))
        self._add("wk", (d, kh * dh))
        self._add("wv", (d, kh * dh))
        self._add("wo", (h * dh, d))
        if cfg.qk_norm:
            self._add("q_norm", (dh,))
            self._add("k_norm", (dh,))


class SwiGLU(_Params):
    """`w_gate`, `w_up` (d_model, d_ff) and `w_down` (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, store: Storage):
        super().__init__(store)
        self._add("w_gate", (d_model, d_ff))
        self._add("w_up", (d_model, d_ff))
        self._add("w_down", (d_ff, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.swiglu(self.params(), x)


class Block(_Params):
    """Pre-norm attention and an FFN with residuals: `attn_norm`, `attn`,
    `ffn_norm` and the FFN of the subclass (`ffn_out`)."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(store)
        self._add("attn_norm", (cfg.d_model,))
        self._add("ffn_norm", (cfg.d_model,))
        self.attn = Attention(cfg, store)

    def ffn_out(self, cfg: ModelConfig, h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the FFN's output on the normed `h`, its aux loss or None)."""
        raise NotImplementedError

    def forward(self, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The training block (the reference's `_dense_block` / `_moe_block`),
        (B, S, D): attention through `layers.attention_train`; returns (x
        out, aux or None)."""
        h = x + layers.attention_train(self.attn.params(), cfg, layers.rms_norm(x, self.p("attn_norm")),
                                       window=cfg.swa_window)
        h = partition.hint(h, "data", None, None)
        y, aux = self.ffn_out(cfg, h)
        return partition.hint(h + y, "data", None, None), aux

    def prefill(self, cfg: ModelConfig, x: torch.Tensor):
        """(x out, k, v) over a whole prompt (B, S, D); attention on B10."""
        a, k, v = _prefill_attention(self.attn.params(), cfg, layers.rms_norm(x, self.p("attn_norm")),
                                     cfg.swa_window)
        h = x + a
        return h + self.ffn_out(cfg, h)[0], k, v


class DenseBlock(Block):
    """Attention and SwiGLU (`ffn`)."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(cfg, store)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, store)

    def ffn_out(self, cfg: ModelConfig, h: torch.Tensor):
        return self.ffn(layers.rms_norm(h, self.p("ffn_norm"))), None


class MoEBlock(Block):
    """Attention and the expert FFN (`moe`)."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(cfg, store)
        self.moe = MoEFFN(cfg, store)

    def ffn_out(self, cfg: ModelConfig, h: torch.Tensor):
        return self.moe(cfg, layers.rms_norm(h, self.p("ffn_norm")))


class SSMBlock(_Params):
    """Pre-norm Mamba2 with a residual (the reference's `_ssm_block`):
    `norm` and the mixer (`mixer`); no separate FFN."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(store)
        self._add("norm", (cfg.d_model,))
        self.mixer = ssd.Mamba2(cfg, store)

    def forward(self, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, None]:
        h0 = ssd.init_ssm_state(x.shape[0], cfg, x.device)
        y, _, _ = ssd.mamba2_apply(self.mixer.params(), cfg, layers.rms_norm(x, self.p("norm")), h0)
        return partition.hint(x + y, "data", None, None), None

    def step_(self, cfg: ModelConfig, x: torch.Tensor, state: Dict[str, torch.Tensor],
              decode: bool) -> torch.Tensor:
        """x (B, S, D) through the block from the state in `state`
        (`ssm_state`, `conv_tail`): the chunked scan over a prompt, or the
        O(1) update of one token when `decode`; the new state written back
        in place."""
        fn = ssd.mamba2_decode if decode else ssd.mamba2_apply
        y, h, tail = fn(self.mixer.params(), cfg, layers.rms_norm(x, self.p("norm")), state["ssm_state"],
                        state["conv_tail"])
        state["ssm_state"].copy_(h)
        state["conv_tail"].copy_(tail)
        return x + y


class RecSublayer(_Params):
    """An RG-LRU mixer and a SwiGLU, each pre-norm with a residual (the
    reference's `_rec_sublayer`): `mix_norm`, `rglru`, `ffn_norm`, `ffn`."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(store)
        self._add("mix_norm", (cfg.d_model,))
        self.rglru = rglru.RGLRU(cfg.d_model, cfg.lru_width, cfg.conv_width, store)
        self._add("ffn_norm", (cfg.d_model,))
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, store)

    def apply(self, cfg: ModelConfig, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
              conv_tail: Optional[torch.Tensor] = None):
        """(x out, h_last, conv_tail) from state h0 (zeros when None)."""
        if h0 is None:
            h0 = rglru.init_rglru_state(x.shape[0], cfg.lru_width, x.device)
        y, h_last, tail = self.rglru(layers.rms_norm(x, self.p("mix_norm")), h0, conv_tail)
        x = x + y
        x = x + self.ffn(layers.rms_norm(x, self.p("ffn_norm")))
        return partition.hint(x, "data", None, None), h_last, tail

    def forward(self, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return self.apply(cfg, x)[0], None

    def step_(self, cfg: ModelConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x through the sublayer from the state in `state` (`h`,
        `conv_tail`), the new state written back in place."""
        x, h, tail = self.apply(cfg, x, state["h"], state["conv_tail"])
        state["h"].copy_(h)
        state["conv_tail"].copy_(tail)
        return x


class HybridGroup(_Params):
    """RecurrentGemma's group (the reference's `_hybrid_group`): two
    `RecSublayer`s (`rec1`, `rec2`), then local attention over
    `cfg.local_window` keys and a SwiGLU, each pre-norm with a residual
    (`attn_norm`, `attn`, `attn_ffn_norm`, `attn_ffn`)."""

    def __init__(self, cfg: ModelConfig, store: Storage):
        super().__init__(store)
        self.rec1 = RecSublayer(cfg, store)
        self.rec2 = RecSublayer(cfg, store)
        self._add("attn_norm", (cfg.d_model,))
        self.attn = Attention(cfg, store)
        self._add("attn_ffn_norm", (cfg.d_model,))
        self.attn_ffn = SwiGLU(cfg.d_model, cfg.d_ff, store)

    def _attend_ffn(self, x: torch.Tensor, attend) -> torch.Tensor:
        h = x + attend(self.attn.params(), layers.rms_norm(x, self.p("attn_norm")))
        return h + self.attn_ffn(layers.rms_norm(h, self.p("attn_ffn_norm")))

    def forward(self, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, None]:
        x = self.rec1(cfg, x)[0]
        x = self.rec2(cfg, x)[0]
        x = self._attend_ffn(x, lambda p, h: layers.attention_train(p, cfg, h, window=cfg.local_window))
        return partition.hint(x, "data", None, None), None

    def prefill_(self, cfg: ModelConfig, x: torch.Tensor, state: Dict[str, Any]) -> torch.Tensor:
        """A prompt through the group: the sublayers' states and the local
        attention's ring (`state["attn"]`) written in place; attention on
        B10 over `cfg.local_window` keys."""
        x = self.rec1.step_(cfg, x, state["rec1"])
        x = self.rec2.step_(cfg, x, state["rec2"])
        kv = []

        def attend(p, h):
            a, k, v = _prefill_attention(p, cfg, h, cfg.local_window)
            kv.extend((k, v))
            return a

        x = self._attend_ffn(x, attend)
        store_kv(cfg, state["attn"], *kv)
        return x

    def decode_(self, cfg: ModelConfig, x: torch.Tensor, state: Dict[str, Any], pos: int) -> torch.Tensor:
        """One token through the group at position `pos`, its states and
        ring updated in place."""
        x = self.rec1.step_(cfg, x, state["rec1"])
        x = self.rec2.step_(cfg, x, state["rec2"])
        return self._attend_ffn(
            x, lambda p, h: _decode_attend(p, cfg, h, state["attn"], pos, cfg.local_window))


class Transformer(_Params):
    """The decoder: `embed` (padded_vocab, d_model), `final_norm`, `head`
    (d_model, padded_vocab) unless tied, and the blocks: `layers`
    (`DenseBlock`s, `MoEBlock`s for the moe family, `SSMBlock`s for the ssm
    family), or for the hybrid family `groups` (`HybridGroup`s) and `tail`
    (`RecSublayer`s) by `cfg.hybrid_pattern()`. `param_dtype` None serves
    (parameters in `cfg.dtype`, no gradients); a dtype name
    (`cfg.param_dtype` to train) holds master parameters in it with
    gradients, cast to `cfg.dtype` at every use."""

    def __init__(self, cfg: ModelConfig, device: Device = None, param_dtype: Optional[str] = None):
        compute = dtype_of(cfg)
        store = Storage(compute, compute if param_dtype is None else getattr(torch, param_dtype),
                        resolve_device(device), param_dtype is not None)
        super().__init__(store)
        self.cfg = cfg
        self._add("embed", (cfg.padded_vocab, cfg.d_model))
        self._add("final_norm", (cfg.d_model,))
        if not cfg.tie_embeddings:
            self._add("head", (cfg.d_model, cfg.padded_vocab))
        if cfg.family == "hybrid":
            groups, rem = cfg.hybrid_pattern()
            self.groups = nn.ModuleList(HybridGroup(cfg, store) for _ in range(groups))
            self.tail = nn.ModuleList(RecSublayer(cfg, store) for _ in range(rem))
        else:
            block = {"dense": DenseBlock, "moe": MoEBlock, "ssm": SSMBlock}[cfg.family]
            self.layers = nn.ModuleList(block(cfg, store) for _ in range(cfg.n_layers))
            for i, blk in enumerate(self.layers):
                if isinstance(blk, MoEBlock):
                    blk.moe.key = i

    def blocks(self):
        """The blocks in order, each `block(cfg, x) -> (x, aux or None)`."""
        if self.cfg.family == "hybrid":
            return [*self.groups, *self.tail]
        return list(self.layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embedding(self, inputs: torch.Tensor) -> torch.Tensor:
        """The blocks' input in the compute dtype: rows of the embedding for
        int tokens (B, S), or for `input_kind == "embeddings"` the (B, S, D)
        embeddings themselves."""
        x = self.embed[inputs.long()] if self.cfg.input_kind == "tokens" else inputs
        return x if x.dtype == self._store.compute else x.to(self._store.compute)

    def head_weight(self) -> torch.Tensor:
        return self.p("embed").t() if self.cfg.tie_embeddings else self.p("head")

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, self.p("final_norm"))
        return partition.hint(x @ self.head_weight(), "data", None, "model")


# =============================================================== init =====
def init_params(cfg: ModelConfig, seed: int = 0, device: Device = None,
                param_dtype: Optional[str] = None) -> Transformer:
    """A `Transformer` (`param_dtype` as there) with the reference's initial
    distributions (not its numbers): embedding N(0, 1) / sqrt(d_model),
    every weight of two or more dims N(0, 1) / sqrt(shape[-2]) (d_in of a
    dense or an expert's weight, d_model of the router), norms and biases
    0, and the recurrent blocks' own (`RGLRU.draw_`, `Mamba2.draw_`: the
    convs' N(0, 1) x 0.1, `lam`, `A_log`, `D` = 1, `dt_bias`); drawn in
    float32 from a `torch.Generator` on the device seeded with `seed`, then
    held in the storage dtype."""
    model = Transformer(cfg, device, param_dtype)
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def normal_(p: torch.Tensor, scale: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32) * scale)

    with torch.no_grad():
        normal_(model.embed, 1.0 / math.sqrt(cfg.d_model))
        if not cfg.tie_embeddings:
            normal_(model.head, 1.0 / math.sqrt(cfg.d_model))
        for blk in model.blocks():
            for p in blk.parameters():
                if p.dim() >= 2:
                    normal_(p, 1.0 / math.sqrt(p.shape[-2]))
        for mod in model.modules():
            if isinstance(mod, (rglru.RGLRU, ssd.Mamba2)):
                mod.draw_(gen)
    return model


# ============================================================ forward =====
def forward(model: Transformer, cfg: ModelConfig, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs int tokens (B, S), or (B, S, D) embeddings for
    `input_kind == "embeddings"`, at positions arange(S) -> (logits (B, S, V),
    aux loss: the sum of the moe blocks' load-balance losses, 0.0 for the
    other families). Each block runs under `torch.utils.checkpoint` (its
    activations recomputed in the backward, B10 launched again) when
    `cfg.remat == "full"` and gradients are on."""
    x = partition.hint(model.embedding(inputs), "data", None, None)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    auxs = []
    for blk in model.blocks():
        x, aux = checkpoint(blk, cfg, x, use_reentrant=False) if remat else blk(cfg, x)
        if aux is not None:
            auxs.append(aux)
    aux = torch.sum(torch.stack(auxs)) if auxs else torch.zeros((), dtype=torch.float32, device=x.device)
    return model.logits(x), aux


# =============================================================== loss =====
def loss_fn(model: Transformer, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy over the (optionally masked) labels,
    from float32 log-softmax of the logits: (ce + aux_weight * aux,
    {"ce", "aux"})."""
    logits, aux = forward(model, cfg, batch["inputs"])
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ============================================================= decode =====
def _round_window(w: int) -> int:
    """Ring size: a multiple of the NUQ scale group, and of the 2048-key
    decode block when larger."""
    g = min(kvcache.SCALE_GROUP, w)
    w = -(-w // g) * g
    if w > 2048:
        w = -(-w // 2048) * 2048
    return w


def _ring(cfg: ModelConfig, n: int, batch: int, w: int, device: torch.device) -> Dict[str, Any]:
    """n attention layers' rings of w slots, stacked on dim 0: quantized
    (uint8 codes + float32 group scales) when `cfg.kv_quant`, else raw in
    `cfg.dtype`. Under a mesh and mapping each is a `sharding.Sharded` by
    `sharding.cache_specs` (batch over data when batch > 1, ring over
    model)."""
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_quant:
        g = min(kvcache.SCALE_GROUP, w)
        leaves = {"k_codes": ((n, batch, w, kh, dh), torch.uint8, 0.0),
                  "v_codes": ((n, batch, w, kh, dh), torch.uint8, 0.0),
                  "k_scale": ((n, batch, w // g, kh), torch.float32, 1.0),
                  "v_scale": ((n, batch, w // g, kh), torch.float32, 1.0)}
    else:
        leaves = {"k": ((n, batch, w, kh, dh), dtype_of(cfg), 0.0),
                  "v": ((n, batch, w, kh, dh), dtype_of(cfg), 0.0)}
    mesh, axes = partition.current_mesh(), partition.current_axes()
    if mesh is None or axes is None:
        return {k: torch.full(shape, fill, dtype=dt, device=device) for k, (shape, dt, fill) in leaves.items()}
    from repro_torch.runtime.sharding import Placement

    data = "data" if batch > 1 else None
    return {k: Placement(mesh, partition.spec(*((None, data, "model") + (None,) * (len(shape) - 3))))
            .zeros(shape, dt, fill, logical=(None, data, "model") + (None,) * (len(shape) - 3))
            for k, (shape, dt, fill) in leaves.items()}


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, device: Device = None) -> Dict[str, Any]:
    """Decode state for `decode_step`, the reference's layout, each leaf
    stacked over its layers on dim 0, and `pos`. Attention layers keep a
    ring of `_round_window(effective_kv_window(seq_len))` slots (`_ring`):
    `layers` for the dense and moe families, `groups/attn` for the hybrid.
    The ssm family keeps `layers/ssm_state` (float32 (L, B, G, E, P, N)) and
    `layers/conv_tail` ((L, B, W-1, conv_dim) in `cfg.dtype`); the hybrid's
    RG-LRU sublayers `groups/{rec1,rec2}` and `tail` hold `h` (float32 (n,
    B, lru_width)) and `conv_tail` ((n, B, W-1, lru_width))."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    if cfg.family == "ssm":
        n = cfg.n_layers
        e = cfg.ssm_heads // cfg.ssm_groups
        return {"pos": 0, "layers": {
            "ssm_state": torch.zeros((n, batch, cfg.ssm_groups, e, cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=device),
            "conv_tail": torch.zeros((n, batch, cfg.conv_width - 1, ssd.conv_dim(cfg)), dtype=dt, device=device),
        }}
    w = _round_window(cfg.effective_kv_window(seq_len))
    if cfg.family != "hybrid":
        return {"pos": 0, "layers": _ring(cfg, cfg.n_layers, batch, w, device)}
    groups, rem = cfg.hybrid_pattern()

    def rec_state(n: int) -> Dict[str, torch.Tensor]:
        return {"h": torch.zeros((n, batch, cfg.lru_width), dtype=torch.float32, device=device),
                "conv_tail": torch.zeros((n, batch, cfg.conv_width - 1, cfg.lru_width), dtype=dt, device=device)}

    cache = {"pos": 0, "groups": {"rec1": rec_state(groups), "rec2": rec_state(groups),
                                  "attn": _ring(cfg, groups, batch, w, device)}}
    if rem:
        cache["tail"] = rec_state(rem)
    return cache


def _view(node: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Row i of every tensor of a (nested) dict, as views (of every shard of
    a `Sharded`): writes land in the cache."""
    return {k: _view(v, i) if isinstance(v, dict) else (v[i] if isinstance(v, torch.Tensor) else v.row(i))
            for k, v in node.items()}


def layer_view(cache: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of every tensor of `cache["layers"]` (views)."""
    return _view(cache["layers"], i)


def cache_tensors(cache: Dict[str, Any]):
    """Every tensor of a cache (nested dicts), in order; every shard of a
    `Sharded` ring."""
    for v in cache.values():
        if isinstance(v, dict):
            yield from cache_tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v
        elif hasattr(v, "shards"):
            yield from v.shards


def store_kv(cfg: ModelConfig, cache_l: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prefill's K/V (B, S, K, Dh) at positions [0, S) into one
    layer's ring in place: position p at slot p % W, the last W positions
    when S > W; quantized by groups of the scale group when the cache is.
    A `Sharded` ring is written whole, then copied into its shards."""
    if not isinstance(next(iter(cache_l.values())), torch.Tensor):
        whole = {name: t.gather(k.device) for name, t in cache_l.items()}
        store_kv(cfg, whole, k, v)
        for name, t in cache_l.items():
            t.write(whole[name])
        return
    s = k.shape[1]
    w = next(iter(cache_l.values())).shape[1]
    sw = min(s, w)
    k_w, v_w = k[:, -sw:], v[:, -sw:]
    start = (s - sw) % w
    idx = (start + torch.arange(sw, device=k.device)) % w
    if cfg.kv_quant:
        g = min(kvcache.SCALE_GROUP, w)
        pad = (-sw) % g
        padded = (0, 0, 0, 0, 0, pad)
        kq, ks = kvcache.quantize_block(torch.nn.functional.pad(k_w, padded))
        vq, vs = kvcache.quantize_block(torch.nn.functional.pad(v_w, padded))
        gidx = (start // g + torch.arange(ks.shape[1], device=k.device)) % max(w // g, 1)
        cache_l["k_codes"][:, idx] = kq[:, :sw]
        cache_l["v_codes"][:, idx] = vq[:, :sw]
        cache_l["k_scale"][:, gidx] = ks
        cache_l["v_scale"][:, gidx] = vs
    else:
        cache_l["k"][:, idx] = k_w.to(cache_l["k"].dtype)
        cache_l["v"][:, idx] = v_w.to(cache_l["v"].dtype)


def _prefill_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                       window: Optional[int]):
    """`layers.attention_prefill` (B10) on a prompt (B, S, D): under a mesh
    and mapping whose data axes split B, once per data shard, on the
    shard's first slot and as its program; the shards' (out, k, v) joined
    again (`compat.all_gather`)."""
    dax, n = partition.data_shards()
    b = x.shape[0]
    if dax is None or n == 1 or b % n != 0:
        return layers.attention_prefill(p, cfg, x, window=window)
    mesh = partition.current_mesh()
    bl = b // n
    parts = []
    for i, slot in enumerate(partition.lead_slots(mesh, partition.axis_names(dax))):
        dev = mesh.devices[slot]
        with partition.slot_program(mesh, slot, {"data": (b, n)}), on_device(dev):
            pd = {k: t.to(dev) for k, t in p.items()}
            parts.append(layers.attention_prefill(pd, cfg, x[i * bl:(i + 1) * bl].to(dev), window=window))
    return tuple(compat.all_gather([part[j] for part in parts], [x.device] * n, dim=0)[0]
                 for j in range(3))


def _decode_attend(p: Dict[str, torch.Tensor], cfg: ModelConfig, x_t: torch.Tensor,
                   cache_l: Dict[str, torch.Tensor], pos: int, window: Optional[int]) -> torch.Tensor:
    """One layer's decode attention: write the token into the ring cache (in
    place), attend over it, project."""
    b = x_t.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k_t, v_t = layers.attention_qkv(p, cfg, x_t, positions)
    if cfg.kv_quant:
        out, _ = kvcache.decode_attend_dlse(q, cache_l, k_t, v_t, pos, window,
                                            softcap=cfg.attn_logit_softcap)
    else:
        if not isinstance(cache_l["k"], torch.Tensor):  # a Sharded raw ring: read and written whole
            whole = {name: t.gather(x_t.device) for name, t in cache_l.items()}
            out = _decode_attend(p, cfg, x_t, whole, pos, window)
            for name, t in cache_l.items():
                t.write(whole[name])
            return out
        w = cache_l["k"].shape[1]
        slot = pos % w
        cache_l["k"][:, slot] = k_t[:, 0].to(cache_l["k"].dtype)
        cache_l["v"][:, slot] = v_t[:, 0].to(cache_l["v"].dtype)
        slots = torch.arange(w, device=x_t.device)
        abs_pos = pos - torch.remainder(pos - slots, w) if pos >= w else slots
        valid = abs_pos <= pos
        if window is not None:
            valid = valid & (abs_pos > pos - window)
        out = layers.flash_attention(
            q, cache_l["k"], cache_l["v"], positions, abs_pos[None].expand(b, w),
            kv_valid=valid[None].expand(b, w), causal=True, softcap=cfg.attn_logit_softcap,
        )
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


def decode_step(model: Transformer, cfg: ModelConfig, cache: Dict[str, Any],
                inputs_t: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One autoregressive step of int tokens (B, 1), or (B, 1, D)
    embeddings for `input_kind == "embeddings"`: (cache, logits (B, 1, V)).
    The cache's tensors are updated in place and `pos` advances."""
    pos = cache["pos"]
    x = partition.hint(model.embedding(inputs_t), "data", None, None)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.layers):
            x = blk.step_(cfg, x, layer_view(cache, i), decode=True)
    elif cfg.family == "hybrid":
        for i, grp in enumerate(model.groups):
            x = grp.decode_(cfg, x, _view(cache["groups"], i), pos)
        for i, sub in enumerate(model.tail):
            x = sub.step_(cfg, x, _view(cache["tail"], i))
    else:
        for i, blk in enumerate(model.layers):
            a = _decode_attend(blk.attn.params(), cfg, layers.rms_norm(x, blk.p("attn_norm")),
                               layer_view(cache, i), pos, cfg.swa_window)
            h = x + a
            x = partition.hint(h + blk.ffn_out(cfg, h)[0], "data", None, None)
    cache["pos"] = pos + 1
    return cache, model.logits(x)


def prefill(model: Transformer, cfg: ModelConfig, inputs: torch.Tensor,
            cache_seq_len: Optional[int] = None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Process a prompt of int tokens (B, S), or (B, S, D) embeddings for
    `input_kind == "embeddings"`: fill the decode cache (rings of
    `max(cache_seq_len or S, S)` positions, and the recurrent states) layer
    by layer with what the forward pass computes, and return (cache, logits
    of the last prompt position (B, 1, V))."""
    b, s = inputs.shape[:2]
    cache = init_decode_cache(cfg, b, max(cache_seq_len or s, s), model.device)
    x = model.embedding(inputs)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.layers):
            x = blk.step_(cfg, x, layer_view(cache, i), decode=False)
    elif cfg.family == "hybrid":
        for i, grp in enumerate(model.groups):
            x = grp.prefill_(cfg, x, _view(cache["groups"], i))
        for i, sub in enumerate(model.tail):
            x = sub.step_(cfg, x, _view(cache["tail"], i))
    else:
        for i, blk in enumerate(model.layers):
            x, k, v = blk.prefill(cfg, x)
            store_kv(cfg, layer_view(cache, i), k, v)
    cache["pos"] = s
    return cache, model.logits(x[:, -1:])
