"""Architecture registry (port of `repro/configs`): importing this package
registers the architectures the port builds; `get_arch("--arch id")`
returns the ArchSpec, and raises naming the ROADMAP item for the
reference's architectures not ported yet."""
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    UNPORTED,
    ArchSpec,
    ShapeSpec,
    arch_ids,
    get_arch,
)

# importing registers each arch
from repro_torch.configs import qwen3_1_7b  # noqa: F401
