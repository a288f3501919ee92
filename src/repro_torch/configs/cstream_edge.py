"""The paper's own configuration: CStream on an edge device (port of
`repro/configs/cstream_edge.py`).

The setup behind the Fig 4 case study: PLA on ECG under RK3399 with
asymmetry-aware scheduling and an 8 KB micro-batch (solution A), and the
careless contrast (solution B: shared-state Tdic32, eager, uniform
OS-style scheduling).
"""
from __future__ import annotations

from repro_torch.core.strategies import (
    EngineConfig,
    ExecutionStrategy,
    SchedulingStrategy,
    StateStrategy,
)

#: Fig 4 point A — the thoughtful co-design.
SOLUTION_A = EngineConfig(
    codec="pla",
    execution=ExecutionStrategy.LAZY,
    micro_batch_bytes=8192,
    lanes=2,  # 1 big + 1 little core
    state=StateStrategy.PRIVATE,
    scheduling=SchedulingStrategy.ASYMMETRIC,
    profile="rk3399_amp",
)

#: Fig 4 point B — the careless contrast.
SOLUTION_B = EngineConfig(
    codec="tdic32",
    execution=ExecutionStrategy.EAGER,
    lanes=6,  # 2 big + 4 little cores
    state=StateStrategy.SHARED,
    scheduling=SchedulingStrategy.UNIFORM,
    profile="rk3399_amp",
)

#: paper §5 defaults for the strategy sweeps (Tcomp32 / Rovio).
PAPER_DEFAULT = EngineConfig(
    codec="tcomp32",
    execution=ExecutionStrategy.LAZY,
    micro_batch_bytes=400,
    lanes=4,
    state=StateStrategy.PRIVATE,
    scheduling=SchedulingStrategy.ASYMMETRIC,
    profile="rk3399_amp",
)
