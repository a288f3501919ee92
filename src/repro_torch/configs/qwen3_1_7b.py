"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, GQA [hf:Qwen/Qwen3-8B; hf] (port of
`repro/configs/qwen3_1_7b.py`).

head_dim=128 and per-head q/k RMSNorm (the qwen3 signature), tied
embeddings, rope_theta=1e6.  Pure full attention => long_500k skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("qwen3-1.7b")
def qwen3_1_7b() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen3-1.7b",
        model=ModelConfig(
            name="qwen3-1.7b",
            family="dense",
            n_layers=28,
            d_model=2048,
            n_heads=16,
            n_kv_heads=8,
            d_ff=6144,
            vocab_size=151936,
            head_dim=128,
            qk_norm=True,
            tie_embeddings=True,
            rope_theta=1_000_000.0,
        ),
        source="hf:Qwen/Qwen3-8B; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
    )
