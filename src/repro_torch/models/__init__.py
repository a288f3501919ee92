"""The model stack (port of `repro/models`): the dense and moe families."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    prefill,
)
