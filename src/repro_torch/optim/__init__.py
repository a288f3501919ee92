"""AdamW and its LR schedules (port of `repro/optim`)."""
from repro_torch.optim.adamw import AdamWConfig, adamw  # noqa: F401
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
