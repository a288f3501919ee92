"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified] (port of
`repro/configs/pixtral_12b.py`).

The ViT front end is a stub (`models/frontends.py`): the backbone takes
patch embeddings (B, S, 5120), a linear projection of 16 x 16 RGB patches;
the decoder is mistral-nemo-12b's to the last field.  Pure full attention
=> long_500k skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("pixtral-12b")
def pixtral_12b() -> ArchSpec:
    return ArchSpec(
        arch_id="pixtral-12b",
        model=ModelConfig(
            name="pixtral-12b",
            family="dense",
            n_layers=40,
            d_model=5120,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            vocab_size=131072,
            head_dim=128,
            input_kind="embeddings",
            rope_theta=1_000_000.0,
        ),
        source="hf:mistralai/Pixtral-12B-2409; unverified",
        skips={"long_500k": FULL_ATTN_SKIP},
        notes="vlm backbone; ViT patch embeddings via frontend stub",
    )
