"""Architecture registry (port of `repro/configs`): importing this package
registers the ten architectures; `get_arch("--arch id")` returns the
ArchSpec, and raises a KeyError for an unknown id."""
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    ArchSpec,
    ShapeSpec,
    arch_ids,
    get_arch,
    input_specs,
)

# importing registers each arch
from repro_torch.configs import (  # noqa: F401
    deepseek_coder_33b,
    mamba2_1_3b,
    mistral_nemo_12b,
    mixtral_8x7b,
    musicgen_large,
    phi4_mini_3_8b,
    pixtral_12b,
    qwen3_1_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
)
