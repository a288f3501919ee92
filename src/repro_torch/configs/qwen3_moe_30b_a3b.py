"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf] (port of
`repro/configs/qwen3_moe_30b_a3b.py`).

d_ff=768 is the PER-EXPERT FFN width (the 30B-A3B fine-grained-expert
design).  128 experts % 16 == 0 => experts shard cleanly over the model
axis (true expert parallelism).  qk_norm + head_dim=128 per qwen3.
Pure full attention => long_500k skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("qwen3-moe-30b-a3b")
def qwen3_moe() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen3-moe-30b-a3b",
        model=ModelConfig(
            name="qwen3-moe-30b-a3b",
            family="moe",
            n_layers=48,
            d_model=2048,
            n_heads=32,
            n_kv_heads=4,
            d_ff=768,
            vocab_size=151936,
            head_dim=128,
            qk_norm=True,
            n_experts=128,
            n_experts_per_token=8,
            rope_theta=1_000_000.0,
        ),
        source="hf:Qwen/Qwen3-30B-A3B; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
        notes="128 experts, EP over model axis",
    )
