"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA [arXiv:2412.08905; hf] (port of
`repro/configs/phi4_mini_3_8b.py`).

head_dim=128, tied embeddings (per the HF config).  Pure full attention
=> long_500k skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("phi4-mini-3.8b")
def phi4_mini() -> ArchSpec:
    return ArchSpec(
        arch_id="phi4-mini-3.8b",
        model=ModelConfig(
            name="phi4-mini-3.8b",
            family="dense",
            n_layers=32,
            d_model=3072,
            n_heads=24,
            n_kv_heads=8,
            d_ff=8192,
            vocab_size=200064,
            head_dim=128,
            tie_embeddings=True,
            rope_theta=10_000.0,
        ),
        source="arXiv:2412.08905; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
    )
