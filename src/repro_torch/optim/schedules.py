"""LR schedules (port of `repro/optim/schedules.py`): pure functions of the
step, a multiplier on the configured peak LR, computed in float32 as the
reference's jnp arithmetic does."""
from __future__ import annotations

import math

import numpy as np


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup -> cosine decay to `final_frac` of peak. Returns a
    multiplier on the configured peak LR."""
    f32 = np.float32

    def sched(step) -> np.float32:
        step = f32(step)
        warm = step / f32(max(warmup_steps, 1))
        prog = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return f32(warm if step < warmup_steps else cos)

    return sched


def constant():
    def sched(step) -> np.float32:
        return np.float32(1.0)

    return sched
