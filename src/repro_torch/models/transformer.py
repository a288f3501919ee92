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
check inside a slot's program), the decode cache is held as
`runtime/sharding.Sharded` per `sharding.cache_specs` (the rings' batch
over data and ring over model; the recurrent states' batch over data and
`ssm_state`'s heads, the conv tails' channels and the RG-LRU's `h` width
over model). On a model axis of one slot a prefill writes each layer's
shards from its whole K/V, its B10 attention runs per data shard on the
shard's slot, the decode reads the ring through the distributed-LSE branch
of `kvcache.decode_attend_dlse`, an moe block dispatches per data shard
(`models/moe.py`), and a recurrent block gathers its state shards, steps
and writes them back.

Tensor parallelism: for every family on a model axis wider than one slot
(`tp_active`), `prefill`, `decode_step` and the train step
(`launch/steps.py`) run one program per data shard over its model group
(`partition.Group`), on lists of per-slot tensors: the embedding and head
split by vocab (a masked lookup of the slot's rows then `compat.psum`;
logits (data, None, "model"); a vocab-parallel cross-entropy, `ce_group`;
a greedy argmax over the split vocab, `decode_greedy`), attention split by
heads (`layers.head_splits`), the SwiGLU's d_ff and the moe experts split
(`moe.moe_group`), the Mamba2 mixer by heads and conv channels
(`ssd.mamba2_group`), the RG-LRU by channels (`rglru.rglru_group`), norms
and residuals replicated. Each slot writes its slice of the ring from K/V
gathered over the group, and the decode merges the slots' statistics over
their ring slices (`kvcache.decode_attend_group`); the hybrid's local
attention does so over its window's ring, which splits only where its
scale groups divide the model axis. Each slot carries its shards of the
recurrent states.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.core import kvcache
from repro_torch.core.device import on_device, resolve_device
from repro_torch.kernels import ops
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
        whole = _whole_state(state, x.device)
        y, h, tail = fn(self.mixer.params(), cfg, layers.rms_norm(x, self.p("norm")), whole["ssm_state"],
                        whole["conv_tail"])
        _write_state(state, whole, {"ssm_state": h, "conv_tail": tail})
        return x + y


def _whole_state(state: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A block's recurrent state as whole tensors: a `Sharded` leaf (a
    model axis of one slot, the batch over data) gathered on `device`."""
    return {k: v if isinstance(v, torch.Tensor) else v.gather(device) for k, v in state.items()}


def _write_state(state: Dict[str, Any], whole: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    """The new state into the cache in place (into a `Sharded` leaf's
    shards through its gathered copy)."""
    for k, t in new.items():
        whole[k].copy_(t)
        if not isinstance(state[k], torch.Tensor):
            state[k].write(whole[k])


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
        whole = _whole_state(state, x.device)
        x, h, tail = self.apply(cfg, x, whole["h"], whole["conv_tail"])
        _write_state(state, whole, {"h": h, "conv_tail": tail})
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
    model); the model axis splits a ring only where its scale groups (its
    slots, raw) divide over the model slots, else ValueError."""
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    g = min(kvcache.SCALE_GROUP, w) if cfg.kv_quant else 1
    if cfg.kv_quant:
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
    m = partition.model_width(mesh)
    if (w // g) % m:
        raise ValueError(f"a ring of {w} slots in groups of {g} does not split over {m} model slots: the model "
                         f"axis splits a ring only where its groups divide over it (W / {g} % n == 0)")
    from repro_torch.runtime.sharding import Placement

    data = "data" if batch > 1 else None
    return {k: Placement(mesh, partition.spec(*((None, data, "model") + (None,) * (len(shape) - 3))))
            .zeros(shape, dt, fill, logical=(None, data, "model") + (None,) * (len(shape) - 3))
            for k, (shape, dt, fill) in leaves.items()}


def _state(shape: tuple, dtype: torch.dtype, logical: tuple, device: torch.device):
    """A recurrent state leaf of zeros: under a mesh and mapping a
    `sharding.Sharded` by its logical spec (`sharding.cache_specs`), else a
    tensor on `device`."""
    mesh, axes = partition.current_mesh(), partition.current_axes()
    if mesh is None or axes is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from repro_torch.runtime.sharding import Placement

    return Placement(mesh, partition.spec(*logical)).zeros(shape, dtype, logical=logical)


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, device: Device = None) -> Dict[str, Any]:
    """Decode state for `decode_step`, the reference's layout, each leaf
    stacked over its layers on dim 0, and `pos`. Attention layers keep a
    ring of `_round_window(effective_kv_window(seq_len))` slots (`_ring`):
    `layers` for the dense and moe families, `groups/attn` for the hybrid.
    The ssm family keeps `layers/ssm_state` (float32 (L, B, G, E, P, N)) and
    `layers/conv_tail` ((L, B, W-1, conv_dim) in `cfg.dtype`); the hybrid's
    RG-LRU sublayers `groups/{rec1,rec2}` and `tail` hold `h` (float32 (n,
    B, lru_width)) and `conv_tail` ((n, B, W-1, lru_width)). Under a mesh
    and mapping every leaf is a `sharding.Sharded` by `sharding.cache_specs`."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    data = "data" if batch > 1 else None
    if cfg.family == "ssm":
        n = cfg.n_layers
        e = cfg.ssm_heads // cfg.ssm_groups
        return {"pos": 0, "layers": {
            "ssm_state": _state((n, batch, cfg.ssm_groups, e, cfg.ssm_head_dim, cfg.ssm_state), torch.float32,
                                (None, data, None, "model", None, None), device),
            "conv_tail": _state((n, batch, cfg.conv_width - 1, ssd.conv_dim(cfg)), dt, (None, data, None, "model"),
                                device),
        }}
    w = _round_window(cfg.effective_kv_window(seq_len))
    if cfg.family != "hybrid":
        return {"pos": 0, "layers": _ring(cfg, cfg.n_layers, batch, w, device)}
    groups, rem = cfg.hybrid_pattern()

    def rec_state(n: int) -> Dict[str, Any]:
        return {"h": _state((n, batch, cfg.lru_width), torch.float32, (None, data, "model"), device),
                "conv_tail": _state((n, batch, cfg.conv_width - 1, cfg.lru_width), dt, (None, data, None, "model"),
                                    device)}

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
    A `Sharded` ring is written per data shard on the shard's slot: its
    rows of the ring gathered, written, and copied back into the shards
    (`kvcache.per_data_shard`)."""
    if not isinstance(next(iter(cache_l.values())), torch.Tensor):
        kvcache.per_data_shard(cache_l, k.shape[0],
                               lambda rows, whole, dev: store_kv(cfg, whole, k[rows].to(dev), v[rows].to(dev)))
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
    if not cfg.kv_quant and not isinstance(cache_l["k"], torch.Tensor):
        # a Sharded raw ring: per data shard on its slot
        pd = {}

        def one(rows, whole, dev):
            if dev not in pd:
                pd[dev] = {name: t.to(dev) for name, t in p.items()}
            return _decode_attend(pd[dev], cfg, x_t[rows].to(dev), whole, pos, window)

        return kvcache.join_rows(kvcache.per_data_shard(cache_l, b, one), x_t.device)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k_t, v_t = layers.attention_qkv(p, cfg, x_t, positions)
    if cfg.kv_quant:
        out, _ = kvcache.decode_attend_dlse(q, cache_l, k_t, v_t, pos, window,
                                            softcap=cfg.attn_logit_softcap)
    else:
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
    if tp_active(cfg):
        _check_tp_cache(cache)
        parts = _tp_run(model, cfg, inputs_t, cache, decode=True)
        cache["pos"] = cache["pos"] + 1
        return cache, _whole_logits(parts, inputs_t.device)
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
    if tp_active(cfg):
        _check_tp_cache(cache)
        parts = _tp_run(model, cfg, inputs, cache, decode=False)
        cache["pos"] = s
        return cache, _whole_logits(parts, inputs.device)
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


# ======================================================= tensor parallelism ===
def tp_active(cfg: ModelConfig) -> bool:
    """Under a mapping and mesh whose model axis holds more than one slot:
    the compute of every family is split over it."""
    return partition.model_width() > 1


def nested(named: Dict[str, Any]) -> Dict[str, Any]:
    """{"layers.0.attn.wq": t, ...} -> {"layers": {"0": {"attn": {"wq": t}}}}."""
    out: Dict[str, Any] = {}
    for name, t in named.items():
        node = out
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return out


def tp_layout(cfg: ModelConfig, n: int):
    """(head splits of the n model slots, whether wk/wv are split): of the
    attention layers (`layers`, or the hybrid's `groups`); (None, False)
    for the attention-free ssm family."""
    from repro_torch.runtime.sharding import model_split

    if cfg.family == "ssm":
        return None, False
    stack = "groups" if cfg.family == "hybrid" else "layers"
    kv_sharded = model_split(cfg)[f"{stack}.0.attn.wk"] is not None
    return layers.head_splits(cfg, n, kv_sharded), kv_sharded


def tp_groups(cfg: ModelConfig, batch: int):
    """(the model groups of the current mesh, whether the data axes split a
    batch of `batch` rows)."""
    mesh = partition.current_mesh()
    _, n_data = partition.data_shards()
    data_split = n_data > 1 and batch > 1 and batch % n_data == 0
    n = partition.model_width()
    split = {"model": (cfg.padded_vocab, n)}
    if data_split:
        split["data"] = (batch, n_data)
    splits = tp_layout(cfg, n)[0]
    variants = None if splits is None else tuple(
        (sp.heads[1] - sp.heads[0], sp.kv[1] - sp.kv[0], sp.own_kv[1] - sp.own_kv[0], sp.kv_index is None)
        for sp in splits)
    return [dataclasses.replace(g, variants=variants) for g in partition.model_groups(mesh, split)], data_split


def group_rows(x: torch.Tensor, g, data_split: bool, n_data: int) -> torch.Tensor:
    """The group's data shard of a global batch (all of it when the data
    axes do not split it)."""
    if not data_split:
        return x
    b = x.shape[0] // n_data
    return x[g.data * b:(g.data + 1) * b]


def serve_slot_params(model: Transformer, cfg: ModelConfig, g) -> list:
    """Each slot's parameters for a group program from a whole model: its
    model shard of each weight, a view (a copy on another device), in the
    compute dtype, nested by name."""
    from repro_torch.runtime.sharding import model_split, slot_weight

    ms = model_split(cfg)
    compute = model._store.compute
    named = [(k, p if p.dtype == compute else p.to(compute)) for k, p in model.named_parameters()]
    return [nested({k: slot_weight(p, ms[k], i, g.n, dev) for k, p in named})
            for i, dev in enumerate(g.devices)]


def embed_group(g, cfg: ModelConfig, ps, inputs: torch.Tensor, compute: torch.dtype):
    """The blocks' input on every slot: the vocab-split embedding's rows
    (each slot's masked lookup, `compat.psum`), or the (B, S, D) embeddings
    of an embeddings model."""
    if cfg.input_kind != "tokens":
        return g.map(lambda i, p: inputs.to(device=p["final_norm"].device, dtype=compute), ps)
    vn = cfg.padded_vocab // g.n

    def one(i, p):
        tok = inputs.to(p["embed"].device).long()
        own = (tok >= i * vn) & (tok < (i + 1) * vn)
        rows = p["embed"][(tok - i * vn).clamp(0, vn - 1)]
        return torch.where(own[..., None], rows, rows.new_zeros(()))

    xs = compat.psum(g.map(one, ps), g.devices)
    return g.map(lambda i, x: partition.hint(x if x.dtype == compute else x.to(compute), "data", None, None), xs)


def logits_group(g, cfg: ModelConfig, ps, xs):
    """Each slot's vocab shard of the logits (B, S, V / n)."""
    def one(i, x, p):
        w = p["embed"].t() if cfg.tie_embeddings else p["head"]
        return partition.hint(layers.rms_norm(x, p["final_norm"]) @ w, "data", None, "model")

    return g.map(one, xs, ps)


def ce_group(g, logits, labels: torch.Tensor, mask: Optional[torch.Tensor]):
    """The vocab-parallel cross-entropy of each slot's logits shard: the
    max over the slots (`pmax`), the sum of exponents (`psum`) and the
    label's logit from the slot that holds it (`psum`); the masked mean of
    log(sum) + max - logit on every slot, in float32."""
    vn = logits[0].shape[-1]
    ms = compat.pmax(g.map(lambda i, lg: lg.detach().to(torch.float32).amax(dim=-1), logits), g.devices)
    se = compat.psum(g.map(lambda i, lg, m: torch.sum(torch.exp(lg.to(torch.float32) - m[..., None]), dim=-1),
                           logits, ms), g.devices)

    def label_logit(i, lg):
        lab = labels.to(lg.device).long()
        own = (lab >= i * vn) & (lab < (i + 1) * vn)
        got = torch.gather(lg.to(torch.float32), -1, (lab - i * vn).clamp(0, vn - 1)[..., None])[..., 0]
        return torch.where(own, got, got.new_zeros(()))

    ll = compat.psum(g.map(label_logit, logits), g.devices)

    def ce(i, m, s_, lab_logit):
        nll = torch.log(s_) + m - lab_logit
        mk = torch.ones_like(nll) if mask is None else mask.to(device=nll.device, dtype=torch.float32)
        return torch.sum(nll * mk) / torch.clamp(torch.sum(mk), min=1.0)

    return g.map(ce, ms, se, ll)


def moe_capacity(cfg: ModelConfig, tokens: int, n_data: int, data_split: bool) -> int:
    """The capacity of a data shard's `tokens` tokens: the reference's
    per-shard C_local when the data axes split them, else the whole call's."""
    from repro_torch.models.moe import capacity

    if data_split:
        return max(8, -(-capacity(tokens * n_data, cfg) // n_data))
    return capacity(tokens, cfg)


def _swiglu_group(g, fps, ns):
    """A SwiGLU over a group: each slot's d_ff shard on the normed ns, the
    partial sums added (`compat.psum`)."""
    return compat.psum(g.map(lambda i, x, fp: layers.swiglu(fp, x), ns, fps), g.devices)


def ffn_group(g, cfg: ModelConfig, lps, hs, cap: int = 0, moe_kw: Optional[dict] = None):
    """The block's FFN on the normed hs over a group: (ys, aux per slot or
    None). SwiGLU's shards give partial sums (`compat.psum`)."""
    from repro_torch.models.moe import moe_group

    ns = g.map(lambda i, h, lp: layers.rms_norm(h, lp["ffn_norm"]), hs, lps)
    if cfg.family == "moe":
        return moe_group(g, [lp["moe"] for lp in lps], cfg, ns, cap, **(moe_kw or {}))
    return _swiglu_group(g, [lp["ffn"] for lp in lps], ns), None


def _write_states(states, **new) -> None:
    """Each slot's new recurrent state into its views of the cache, in place."""
    for i, st in enumerate(states):
        for k, ts in new.items():
            st[k].copy_(ts[i])


def ssm_group(g, cfg: ModelConfig, lps, xs, states=None, decode: bool = False):
    """`SSMBlock` over a group (`ssd.mamba2_group`): xs out; `states[i]`
    slot i's views of the layer's `ssm_state` and `conv_tail` shards,
    written in place (zeros in, nothing written, when None)."""
    ns = g.map(lambda i, x, lp: layers.rms_norm(x, lp["norm"]), xs, lps)
    ys, hs, tails = ssd.mamba2_group(g, [lp["mixer"] for lp in lps], cfg, ns,
                                     None if states is None else [st["ssm_state"] for st in states],
                                     None if states is None else [st["conv_tail"] for st in states], decode)
    if states is not None:
        _write_states(states, ssm_state=hs, conv_tail=tails)
    return g.map(lambda i, x, y: partition.hint(x + y, "data", None, None), xs, ys)


def rec_group(g, cfg: ModelConfig, lps, xs, states=None):
    """`RecSublayer` over a group (`rglru.rglru_group`, then the split
    SwiGLU): xs out; `states` as `ssm_group` takes them (`h`,
    `conv_tail`)."""
    ns = g.map(lambda i, x, lp: layers.rms_norm(x, lp["mix_norm"]), xs, lps)
    ys, hs, tails = rglru.rglru_group(g, [lp["rglru"] for lp in lps], ns,
                                      None if states is None else [st["h"] for st in states],
                                      None if states is None else [st["conv_tail"] for st in states])
    if states is not None:
        _write_states(states, h=hs, conv_tail=tails)
    xs = g.map(lambda i, x, y: x + y, xs, ys)
    ff = _swiglu_group(g, [lp["ffn"] for lp in lps], g.map(lambda i, x, lp: layers.rms_norm(x, lp["ffn_norm"]),
                                                           xs, lps))
    return g.map(lambda i, x, y: partition.hint(x + y, "data", None, None), xs, ff)


def hybrid_group(g, cfg: ModelConfig, lps, xs, attend, states=None):
    """`HybridGroup` over a group: `rec1`, `rec2` (`rec_group`, `states`
    {"rec1": [...], "rec2": [...]} or None), then `attend(normed xs)` (the
    split local attention's summed output) and the split SwiGLU."""
    for name in ("rec1", "rec2"):
        xs = rec_group(g, cfg, [lp[name] for lp in lps], xs, None if states is None else states[name])
    a = attend(g.map(lambda i, x, lp: layers.rms_norm(x, lp["attn_norm"]), xs, lps))
    hs = g.map(lambda i, x, y: x + y, xs, a)
    ff = _swiglu_group(g, [lp["attn_ffn"] for lp in lps],
                       g.map(lambda i, h, lp: layers.rms_norm(h, lp["attn_ffn_norm"]), hs, lps))
    return g.map(lambda i, h, y: partition.hint(h + y, "data", None, None), hs, ff)


def block_keys(cfg: ModelConfig):
    """(stack, index) of each block in order: `layers`, or the hybrid's
    `groups` then `tail`."""
    if cfg.family == "hybrid":
        groups, rem = cfg.hybrid_pattern()
        return [("groups", i) for i in range(groups)] + [("tail", i) for i in range(rem)]
    return [("layers", i) for i in range(cfg.n_layers)]


def block_train_group(g, cfg: ModelConfig, lps, xs, cap: int, moe_kw: Optional[dict] = None,
                      stack: str = "layers"):
    """A block's training forward over a group (the block of `stack`):
    (xs out, aux per slot or None)."""
    if cfg.family == "ssm":
        return ssm_group(g, cfg, lps, xs), None
    if stack == "tail":
        return rec_group(g, cfg, lps, xs), None
    splits, kv_sharded = tp_layout(cfg, g.n)
    if cfg.family == "hybrid":
        return hybrid_group(g, cfg, lps, xs, lambda ns: layers.attention_train_group(
            g, [lp["attn"] for lp in lps], cfg, ns, splits, kv_sharded, window=cfg.local_window)), None
    ns = g.map(lambda i, x, lp: layers.rms_norm(x, lp["attn_norm"]), xs, lps)
    a = layers.attention_train_group(g, [lp["attn"] for lp in lps], cfg, ns, splits, kv_sharded,
                                     window=cfg.swa_window)
    hs = g.map(lambda i, x, y: partition.hint(x + y, "data", None, None), xs, a)
    ys, aux = ffn_group(g, cfg, lps, hs, cap, moe_kw)
    return g.map(lambda i, h, y: partition.hint(h + y, "data", None, None), hs, ys), aux


def loss_group(g, cfg: ModelConfig, ps, batch: Dict[str, torch.Tensor], compute: torch.dtype, cap: int,
               moe_kw: Optional[dict] = None):
    """`loss_fn` over a group program: (ce per slot, aux per slot). Each
    block runs under `torch.utils.checkpoint` when `cfg.remat == "full"`
    and gradients are on; `moe_kw` as `moe.moe_group` takes it, its
    `record` a dict of per-layer lists."""
    xs = embed_group(g, cfg, ps, batch["inputs"], compute)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    auxs = []
    for stack, li in block_keys(cfg):
        lps = [p[stack][str(li)] for p in ps]
        kw = dict(moe_kw or {})
        if isinstance(kw.get("record"), dict):
            kw["record"] = kw["record"].setdefault(li, [])
        if isinstance(kw.get("f_global"), dict):
            kw["f_global"] = kw["f_global"][li]

        def fn(*x_in, lps=lps, kw=kw, stack=stack):
            out, aux = block_train_group(g, cfg, lps, list(x_in), cap, kw, stack)
            return (*out, *(aux or ()))

        res = checkpoint(fn, *xs, use_reentrant=False) if remat else fn(*xs)
        xs = list(res[:g.n])
        if len(res) > g.n:
            auxs.append(res[g.n:])
    ce = ce_group(g, logits_group(g, cfg, ps, xs), batch["labels"], batch.get("mask"))
    if not auxs:
        return ce, g.map(lambda i, c: torch.zeros((), dtype=torch.float32, device=c.device), ce)
    return ce, g.map(lambda i, c: torch.sum(torch.stack([a[i].to(c.device) for a in auxs])), ce)


def _slot_states(node: Dict[str, Any], g, li: int) -> list:
    """Each slot's slice of block li's leaves of one cache node (a ring, or
    a recurrent state): views of its shards."""
    return [{k: t.shards[s][li] for k, t in node.items()} for s in g.slots]


def _attend_prefill_group(g, cfg: ModelConfig, aps, ns, positions, ring: Dict[str, Any], li: int,
                          window: Optional[int]):
    """A layer's split prefill attention (B10 on each slot's heads), its
    ring's slices written from K/V gathered over the group: the summed
    output on every slot."""
    splits, kv_sharded = tp_layout(cfg, g.n)
    qs, ks, vs = layers.attention_group_qkv(g, aps, cfg, ns, positions, splits, kv_sharded)

    def attend(i, q, k, v):
        k, v = layers.grouped_kv(splits[i], k, v)
        return ops.flash_attention_fwd(q, k, v, window=window, causal=True, softcap=cfg.attn_logit_softcap)

    a = layers.attention_group_out(g, aps, g.map(attend, qs, ks, vs, by=g.variants), splits)

    def own(t):
        return g.map(lambda i, x: x[:, :, splits[i].own_kv[0] - splits[i].kv[0]:
                                    splits[i].own_kv[1] - splits[i].kv[0]], t, by=g.variants)

    k_all = compat.all_gather(own(ks), g.devices, dim=2)
    v_all = compat.all_gather(own(vs), g.devices, dim=2)
    rings = _slot_states(ring, g, li)
    w_local = next(iter(rings[0].values())).shape[1]
    g.map(lambda i, k, v: kvcache.store_slice(rings[i], k, v, i * w_local, w_local * g.n, cfg.kv_quant,
                                              lambda whole, k_, v_: store_kv(cfg, whole, k_, v_)),
          k_all, v_all)
    return a


def _attend_decode_group(g, cfg: ModelConfig, aps, ns, positions, ring: Dict[str, Any], li: int, pos: int,
                         window: Optional[int]):
    """A layer's split decode attention: every head's q and the token's
    K/V on every slot, the token written into the slot whose ring slice
    holds it, the slots' statistics merged (`kvcache.decode_attend_group`):
    the summed output on every slot."""
    splits, kv_sharded = tp_layout(cfg, g.n)
    qs, ks, vs = layers.attention_group_qkv(g, aps, cfg, ns, positions, splits, kv_sharded, all_heads=True)
    outs = kvcache.decode_attend_group(g, qs, _slot_states(ring, g, li), ks, vs, pos, window,
                                       softcap=cfg.attn_logit_softcap)
    return layers.attention_group_out(g, aps, outs, splits, all_heads=True)


def _group_blocks(g, cfg: ModelConfig, ps, xs, cache: Dict[str, Any], cap: int, attend, decode: bool):
    """Every block over the group from `cache`'s states and rings (updated
    in place); `attend(lps' attention params, normed xs, ring, li, window)`
    the split prefill or decode attention. Returns xs out."""
    for stack, li in block_keys(cfg):
        lps = [p[stack][str(li)] for p in ps]
        if cfg.family == "ssm":
            xs = ssm_group(g, cfg, lps, xs, _slot_states(cache["layers"], g, li), decode)
        elif stack == "tail":
            xs = rec_group(g, cfg, lps, xs, _slot_states(cache["tail"], g, li))
        elif cfg.family == "hybrid":
            st = {name: _slot_states(cache["groups"][name], g, li) for name in ("rec1", "rec2")}
            xs = hybrid_group(g, cfg, lps, xs, lambda ns, lps=lps, li=li: attend(
                [lp["attn"] for lp in lps], ns, cache["groups"]["attn"], li, cfg.local_window), st)
        else:
            ns = g.map(lambda i, x, lp: layers.rms_norm(x, lp["attn_norm"]), xs, lps)
            a = attend([lp["attn"] for lp in lps], ns, cache["layers"], li, cfg.swa_window)
            hs = g.map(lambda i, x, y: x + y, xs, a)
            ys, _ = ffn_group(g, cfg, lps, hs, cap)
            xs = g.map(lambda i, h, y: partition.hint(h + y, "data", None, None), hs, ys)
    return xs


def _group_prefill(g, cfg: ModelConfig, ps, inputs: torch.Tensor, cache: Dict[str, Any], compute, cap: int):
    """A prompt through the group: the rings' slices and the recurrent
    states' shards written, and each slot's logits shard of the last
    position (B, 1, V / n)."""
    b, s = inputs.shape[:2]
    xs = embed_group(g, cfg, ps, inputs, compute)
    positions = torch.arange(s, dtype=torch.int32, device=xs[0].device)[None].expand(b, s)
    xs = _group_blocks(g, cfg, ps, xs, cache, cap, lambda aps, ns, ring, li, window: _attend_prefill_group(
        g, cfg, aps, ns, positions, ring, li, window), decode=False)
    return logits_group(g, cfg, ps, g.map(lambda i, x: x[:, -1:], xs))


def _group_decode(g, cfg: ModelConfig, ps, inputs_t: torch.Tensor, cache: Dict[str, Any], compute, cap: int):
    """One token through the group at `cache["pos"]`, the rings' slices and
    the states' shards updated in place: each slot's logits shard (B, 1,
    V / n)."""
    pos = cache["pos"]
    xs = embed_group(g, cfg, ps, inputs_t, compute)
    positions = torch.full((xs[0].shape[0], 1), pos, dtype=torch.int32, device=xs[0].device)
    xs = _group_blocks(g, cfg, ps, xs, cache, cap, lambda aps, ns, ring, li, window: _attend_decode_group(
        g, cfg, aps, ns, positions, ring, li, pos, window), decode=True)
    return logits_group(g, cfg, ps, xs)


def _tp_run(model: Transformer, cfg: ModelConfig, inputs: torch.Tensor, cache: Dict[str, Any], decode: bool):
    """Each data shard's group program (`_group_prefill`/`_group_decode`):
    [(group, its slots' logits shards)]."""
    groups, data_split = tp_groups(cfg, inputs.shape[0])
    _, n_data = partition.data_shards()
    out = []
    for g in groups:
        x = group_rows(inputs, g, data_split, n_data)
        cap = moe_capacity(cfg, x.shape[0] * x.shape[1], n_data, data_split) if cfg.family == "moe" else 0
        run = _group_decode if decode else _group_prefill
        with compat.slots_of(g.slots):
            out.append((g, run(g, cfg, serve_slot_params(model, cfg, g), x, cache, model._store.compute, cap)))
    return out


def _whole_logits(parts, device) -> torch.Tensor:
    """The groups' logits shards joined over the vocab and the data shards."""
    rows = [compat.all_gather(lg, [device], dim=-1)[0] for _, lg in parts]
    return rows[0] if len(rows) == 1 else compat.all_gather(rows, [device], dim=0)[0]


def _check_tp_cache(cache: Dict[str, Any]) -> None:
    from repro_torch.runtime.sharding import Sharded

    def leaves(node):
        for v in node.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    if not all(isinstance(t, Sharded) for t in leaves({k: v for k, v in cache.items() if k != "pos"})):
        raise ValueError("a tensor-parallel decode reads a cache held as shards (`init_decode_cache` "
                         "under the mesh)")


def decode_greedy(model: Transformer, cfg: ModelConfig, cache: Dict[str, Any],
                  inputs_t: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
    """`decode_step` and the greedy token int32 (B, 1) of its logits, the
    first maximal index as `torch.argmax` takes it. Under tensor
    parallelism over the split vocab: each slot's maximum and first index,
    then the first slot holding the largest (all-gathered), without
    gathering the logits."""
    if not tp_active(cfg):
        cache, logits = decode_step(model, cfg, cache, inputs_t)
        return cache, torch.argmax(logits, dim=-1).to(torch.int32)
    _check_tp_cache(cache)
    parts = _tp_run(model, cfg, inputs_t, cache, decode=True)
    cache["pos"] = cache["pos"] + 1
    toks = []
    for g, lgs in parts:
        vn = lgs[0].shape[-1]
        best = g.map(lambda i, lg: torch.max(lg, dim=-1, keepdim=True), lgs)
        with compat.slots_of(g.slots):
            vals = compat.all_gather([b.values.to(torch.float32) for b in best], g.devices, dim=-1)
            idx = compat.all_gather([b.indices + i * vn for i, b in enumerate(best)], g.devices, dim=-1)
        first = g.map(lambda i, v: torch.argmax(v, dim=-1, keepdim=True), vals)[0]
        toks.append(torch.gather(idx[0], -1, first)[..., 0].to(device=inputs_t.device, dtype=torch.int32))
    return cache, (toks[0] if len(toks) == 1 else compat.all_gather(toks, [inputs_t.device], dim=0)[0])
