"""musicgen-large [audio] — decoder-only over EnCodec tokens (port of
`repro/configs/musicgen_large.py`).

48L d_model=2048 32H (GQA kv=32 => MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec front end is a stub
(`models/frontends.py`): the backbone takes frame embeddings (B, S, 2048),
the sum of 4 codebooks' rows; the small 2048-entry vocab is the EnCodec
codebook the output head predicts.  Pure full attention => long_500k
skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("musicgen-large")
def musicgen_large() -> ArchSpec:
    return ArchSpec(
        arch_id="musicgen-large",
        model=ModelConfig(
            name="musicgen-large",
            family="dense",
            n_layers=48,
            d_model=2048,
            n_heads=32,
            n_kv_heads=32,
            d_ff=8192,
            vocab_size=2048,
            head_dim=64,
            input_kind="embeddings",
            rope_theta=10_000.0,
        ),
        source="arXiv:2306.05284; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
        notes="audio backbone; EnCodec frame embeddings via frontend stub",
    )
