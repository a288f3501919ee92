"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf] (port of
`repro/configs/mixtral_8x7b.py`).

swa_window=4096 bounds the KV window, so long_500k RUNS for this arch
(the cache is the 4096-token sliding window, not 500k).  With 8 experts
on a 16-way model axis, expert weights are TP-sharded inside experts
(DESIGN.md §8).
"""
from repro_torch.configs.base import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("mixtral-8x7b")
def mixtral_8x7b() -> ArchSpec:
    return ArchSpec(
        arch_id="mixtral-8x7b",
        model=ModelConfig(
            name="mixtral-8x7b",
            family="moe",
            n_layers=32,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            vocab_size=32000,
            head_dim=128,
            n_experts=8,
            n_experts_per_token=2,
            swa_window=4096,
            rope_theta=1_000_000.0,
        ),
        source="arXiv:2401.04088; hf",
        notes="SWA bounds KV at 4096 => long_500k runnable",
    )
