"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf] (port of
`repro/configs/mistral_nemo_12b.py`).

head_dim=128 (attention inner dim 4096 < d_model, per the HF config);
rope_theta=1e6 for the 128k context.  Pure full attention => long_500k
skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("mistral-nemo-12b")
def mistral_nemo_12b() -> ArchSpec:
    return ArchSpec(
        arch_id="mistral-nemo-12b",
        model=ModelConfig(
            name="mistral-nemo-12b",
            family="dense",
            n_layers=40,
            d_model=5120,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            vocab_size=131072,
            head_dim=128,
            rope_theta=1_000_000.0,
        ),
        source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
    )
