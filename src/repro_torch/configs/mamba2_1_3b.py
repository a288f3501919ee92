"""mamba2-1.3b [ssm] — 48L d_model=2048 (attn-free) d_ff=0 vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*2048 = 4096, 64 heads of dim 64, ngroups=1, conv width 4,
tied embeddings (per the mamba2 reference).  d_ff=0: mamba blocks have no
separate FFN — the mixer IS the layer.  O(1) recurrent state => all four
shapes run, including long_500k.  KV-cache compression is INAPPLICABLE
(no KV cache; the SSM state is small and constant-size) — noted in
DESIGN.md §6; the arch runs without that instance of the technique.
(port of `repro/configs/mamba2_1_3b.py`.)
"""
from repro_torch.configs.base import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig


@register_arch("mamba2-1.3b")
def mamba2_1_3b() -> ArchSpec:
    return ArchSpec(
        arch_id="mamba2-1.3b",
        model=ModelConfig(
            name="mamba2-1.3b",
            family="ssm",
            n_layers=48,
            d_model=2048,
            n_heads=1,
            n_kv_heads=1,
            d_ff=0,
            vocab_size=50280,
            head_dim=64,
            ssm_state=128,
            ssm_head_dim=64,
            ssm_expand=2,
            ssm_chunk=256,
            ssm_groups=1,
            tie_embeddings=True,
        ),
        source="arXiv:2405.21060; unverified",
        notes="attention-free; KV compression inapplicable (DESIGN.md §6)",
    )
