"""Model configuration (port of `repro/models/config.py`, copied: the port
imports nothing of `repro`, not even modules without jax).

One dataclass describes every backbone the reference builds: dense GQA
transformers, MoE transformers, the RG-LRU/local-attention hybrid
(RecurrentGemma) and the attention-free Mamba2 SSD stack, all four of
which the port builds, with token or embedding inputs (the front ends of
`models/frontends.py`); each `repro_torch/configs/<arch>.py` instantiates one of these with the
published dimensions, and smoke tests use `reduced()` copies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'hybrid' | 'ssm'

    # -- core dims -------------------------------------------------------
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None  # default d_model // n_heads

    # -- attention options ------------------------------------------------
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    swa_window: Optional[int] = None  # sliding-window attention (mixtral)
    attn_logit_softcap: Optional[float] = None

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0  # 0 => dense FFN
    n_experts_per_token: int = 0
    capacity_factor: float = 1.25

    # -- hybrid (RecurrentGemma): layer pattern 2x RG-LRU : 1x local attn --
    lru_width: Optional[int] = None
    local_window: int = 2048
    conv_width: int = 4

    # -- SSM (Mamba2 SSD) --------------------------------------------------
    ssm_state: int = 0  # N; 0 => not an SSM
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # -- modality frontend stub --------------------------------------------
    # 'tokens': integer ids -> embedding table.
    # 'embeddings': precomputed frame/patch embeddings (musicgen, pixtral);
    #   the embedding table is still used to tie the output head.
    input_kind: str = "tokens"

    # -- KV-cache compression (the paper's technique on the decode path) ---
    kv_quant: bool = True  # NUQ uint8 codes + group scales vs raw bf16

    # -- numerics / training ----------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master weights
    remat: str = "full"  # 'none' | 'full'
    tie_embeddings: bool = False

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "hybrid" and self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to a multiple of 128 so the
        vocab dim tiles TPU lanes and shards over any model axis <= 128
        (mamba2's 50280 -> 50304; every other assigned vocab is already
        128-aligned).  Logits carry the padded width; labels never reference
        the pad rows."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def effective_kv_window(self, seq_len: int) -> Optional[int]:
        """Bound on the KV cache a decode step needs (None => attention-free).

        Windowed archs (SWA / hybrid local attention) cap the cache at the
        window size — this is what makes `long_500k` feasible for them."""
        if self.attention_free:
            return None
        w = seq_len
        if self.swa_window is not None:
            w = min(w, self.swa_window)
        if self.family == "hybrid":
            w = min(w, self.local_window)
        return w

    def hybrid_pattern(self) -> Tuple[int, int]:
        """(full 3-layer groups, trailing recurrent layers) for the 1 local
        attention : 2 RG-LRU layer pattern."""
        return self.n_layers // 3, self.n_layers % 3

    # -- parameter count (for MODEL_FLOPS = 6*N*D) --------------------------
    def param_count(self, active_only: bool = False) -> int:
        D, H, K, Dh, F, V, L = (
            self.d_model,
            self.n_heads,
            self.n_kv_heads,
            self.head_dim,
            self.d_ff,
            self.vocab_size,
            self.n_layers,
        )
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, N, P = self.d_inner, self.ssm_state, self.ssm_head_dim
            nh, G = self.ssm_heads, self.ssm_groups
            conv_dim = di + 2 * G * N
            per = (
                D * (2 * di + 2 * G * N + nh)  # in_proj (z, x, B, C, dt)
                + conv_dim * self.conv_width  # depthwise conv
                + nh  # A_log
                + nh  # D skip
                + di * D  # out_proj
                + 2 * D  # norms
            )
            return emb + L * per
        attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
        dense_ffn = 3 * D * F
        if self.family == "moe":
            router = D * self.n_experts
            expert_ffn = self.n_experts * 3 * D * F
            act_ffn = router + self.n_experts_per_token * 3 * D * F
            per = attn + (act_ffn if active_only else expert_ffn + router) + 2 * D
            return emb + L * per
        if self.family == "hybrid":
            R = self.lru_width
            rec = D * R * 2 + R * self.conv_width + 3 * R + R * D  # gates+conv+lru+out
            groups, rem = self.hybrid_pattern()
            n_attn = groups
            n_rec = 2 * groups + rem
            per_common = dense_ffn + 2 * D
            return emb + n_attn * (attn + per_common) + n_rec * (rec + per_common)
        return emb + L * (attn + dense_ffn + 2 * D)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family copy for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 3 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            lru_width=128 if self.family == "hybrid" else None,
            local_window=64,
            swa_window=64 if self.swa_window else None,
            ssm_state=32 if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            n_experts=min(self.n_experts, 4),
            n_experts_per_token=min(self.n_experts_per_token, 2),
            remat="none",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
