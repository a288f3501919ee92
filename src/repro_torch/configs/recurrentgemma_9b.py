"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attn 1:2 [arXiv:2402.19427; unverified].

Layer pattern: [RG-LRU, RG-LRU, local-attn] x 12 groups + 2 trailing
RG-LRU layers (38 = 12*3 + 2).  head_dim=256 (4096/16), MQA (kv=1),
local_window=2048.  Bounded window + O(1) recurrent state => long_500k
RUNS (this is the paper's sub-quadratic case, DESIGN.md §6).
(port of `repro/configs/recurrentgemma_9b.py`.)
"""
from repro_torch.configs.base import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("recurrentgemma-9b")
def recurrentgemma_9b() -> ArchSpec:
    return ArchSpec(
        arch_id="recurrentgemma-9b",
        model=ModelConfig(
            name="recurrentgemma-9b",
            family="hybrid",
            n_layers=38,
            d_model=4096,
            n_heads=16,
            n_kv_heads=1,
            d_ff=12288,
            vocab_size=256000,
            head_dim=256,
            lru_width=4096,
            local_window=2048,
            rope_theta=10_000.0,
        ),
        source="arXiv:2402.19427; unverified",
        notes="RG-LRU state uncompressed; KV compression on local-attn cache only",
    )
