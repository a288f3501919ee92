"""Energy accounting (port of `repro/core/energy.py`, edge mode only).

The paper measures Joules with custom hardware (§3.5). Energy here is an
*analytic model*, not a measurement: per-core active/idle power × busy/idle
time, for the hardware profiles of Table 2 (RK3399 AMP/SMP, H2+, Z8350).
Speeds follow the paper's roofline finding (A72 big core ≈ 2× A53 little
core, Fig 6a). The reference's TPU-mode constants (`TpuChip`, `V5E`,
`tpu_energy_j`) are TPU-only and have no counterpart; in their place the
dry run's roofline (`launch/hlo_analysis.py`) takes a `GpuChip`,
`H100_SXM`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    kind: str  # 'big' | 'little' | 'smp'
    speed: float  # relative instructions/s at reference frequency
    p_active_w: float
    p_idle_w: float
    l1d_bytes: int = 32 * 1024


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    cores: List[CoreSpec]

    @property
    def total_l1d_bytes(self) -> int:
        return sum(c.l1d_bytes for c in self.cores)

    @property
    def speeds(self) -> List[float]:
        return [c.speed for c in self.cores]


def _amp(n_big, n_little, sp_big=2.0, sp_little=1.0):
    return [CoreSpec("big", sp_big, 1.5, 0.15)] * n_big + [
        CoreSpec("little", sp_little, 0.5, 0.08)
    ] * n_little


#: Table 2 processors as profiles (speeds normalized to an A53@1.416GHz).
RK3399_AMP = HardwareProfile("rk3399_amp", _amp(2, 4))
RK3399_SMP_BIG = HardwareProfile("rk3399_smp_big", _amp(2, 0))
RK3399_SMP_LITTLE = HardwareProfile("rk3399_smp_little", _amp(0, 4))
H2PLUS = HardwareProfile(  # 32-bit RISC: ~0.6x per-word efficiency on 32b regs
    "h2plus", [CoreSpec("smp", 0.6, 0.45, 0.08)] * 4
)
Z8350 = HardwareProfile(  # CISC: higher unit energy (paper Fig 7)
    "z8350", [CoreSpec("smp", 1.1, 1.0, 0.25, l1d_bytes=24 * 1024)] * 4
)

PROFILES = {
    p.name: p
    for p in (RK3399_AMP, RK3399_SMP_BIG, RK3399_SMP_LITTLE, H2PLUS, Z8350)
}


@dataclasses.dataclass(frozen=True)
class GpuChip:
    """A GPU's peak rates for the roofline: dense bf16 tensor-core FLOP/s,
    HBM bytes/s, and NVLink bytes/s each way, at `power_w`. Published
    data-sheet peaks, not measurements."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    power_w: float


#: NVIDIA H100 SXM5 80 GB (the data sheet's dense bf16 tensor-core peak,
#: HBM3 bandwidth and NVLink 4 bandwidth per direction) at its 700 W limit
H100_SXM = GpuChip("H100 SXM5 80GB", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, power_w=700.0)


def edge_energy_j(
    profile: HardwareProfile,
    busy_s: Sequence[float],
    makespan_s: float,
    spin_wait: bool = False,
) -> float:
    """Per-core busy times + idle remainder -> Joules (paper §4.1 procedure:
    static consumption is measured separately and excluded; this is the
    dynamic compression energy).

    spin_wait=True models barrier-synchronized uniform scheduling, where a
    core that finished its equal share burns near-active power spinning at
    the barrier (paper Fig 13b: big cores 'waiting for little cores' — the
    measured +13.4% energy of symmetric scheduling comes from this)."""
    assert len(busy_s) <= len(profile.cores)
    e = 0.0
    for core, b in zip(profile.cores, busy_s):
        b = min(b, makespan_s)
        p_wait = 0.75 * core.p_active_w if spin_wait else core.p_idle_w
        e += core.p_active_w * b + p_wait * (makespan_s - b)
    return e
