"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196; hf] (port of
`repro/configs/deepseek_coder_33b.py`).

head_dim=128 (7168/56), rope_theta=1e5 (deepseek's 16k-ctx linear-scaled
RoPE base).  The deepest assigned arch — the scan-over-layers HLO is what
keeps its 512-device dry-run compilable.  Pure full attention => long_500k
skipped.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("deepseek-coder-33b")
def deepseek_coder_33b() -> ArchSpec:
    return ArchSpec(
        arch_id="deepseek-coder-33b",
        model=ModelConfig(
            name="deepseek-coder-33b",
            family="dense",
            n_layers=62,
            d_model=7168,
            n_heads=56,
            n_kv_heads=8,
            d_ff=19200,
            vocab_size=32256,
            head_dim=128,
            rope_theta=100_000.0,
        ),
        source="arXiv:2401.14196; hf",
        skips={"long_500k": FULL_ATTN_SKIP},
    )
