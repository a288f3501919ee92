"""Solution-space planner (port of `repro/core/planner.py`; paper §5.1,
Fig 4).

Enumerates (codec x strategy x hardware-knob) candidates, measures each on a
sample window through the `CStreamEngine` shim (`evaluate`,
`enumerate_solutions`), filters by the user's constraints (min ratio, max
NRMSE, energy budget) and picks by lexicographic priority; the adaptive
tier controller (`core/controller.py`) ranks its ladder through
`choose_tier`. Measuring runs on `device` (CUDA when None, or raise).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import energy as energy_mod
from repro_torch.core.device import DeviceLike

# NOTE: repro_torch.core.engine is imported lazily inside `evaluate`: the
# engine is the legacy shim over repro_torch.api, and api imports the
# adaptive controller, which imports this planner
from repro_torch.core.strategies import (
    EngineConfig,
    ExecutionStrategy,
    SchedulingStrategy,
    StateStrategy,
    cache_aware_batch_bytes,
)


@dataclasses.dataclass
class Constraints:
    min_ratio: float = 1.0
    max_nrmse: float = 1.0
    max_energy_j_per_mb: float = float("inf")
    profile: str = "rk3399_amp"


@dataclasses.dataclass
class SolutionPoint:
    config: EngineConfig
    ratio: float
    nrmse: float
    throughput_mbps: float
    latency_s: float
    energy_j_per_mb: float

    def feasible(self, c: Constraints) -> bool:
        return (
            self.ratio >= c.min_ratio
            and self.nrmse <= c.max_nrmse
            and self.energy_j_per_mb <= c.max_energy_j_per_mb
        )


DEFAULT_CANDIDATES: List[Dict] = [
    {"codec": "pla", "codec_kwargs": {"window": 16}},
    {"codec": "pla", "codec_kwargs": {"window": 8}},
    {"codec": "uanuq", "codec_kwargs": {"qbits": 12}},
    {"codec": "uaadpcm", "codec_kwargs": {"qbits": 8}},
    {"codec": "adpcm"},
    {"codec": "leb128_nuq"},
    {"codec": "delta_leb128"},
    {"codec": "tcomp32"},
    {"codec": "tdic32"},
    {"codec": "leb128"},
    {"codec": "rle"},
]


def evaluate(
    cfg: EngineConfig,
    stream: np.ndarray,
    arrival_rate_tps: float,
    max_blocks: int = 16,
    device: DeviceLike = None,
) -> SolutionPoint:
    """Measure one candidate on the stream: ratio, throughput over the
    modeled makespan, latency and energy from one `compress` of at most
    `max_blocks` blocks, NRMSE from a framed roundtrip of four blocks
    (lossy codecs only)."""
    from repro_torch.core.engine import CStreamEngine

    engine = CStreamEngine(cfg, sample=stream[: 1 << 14], device=device)
    res = engine.compress(stream, arrival_rate_tps=arrival_rate_tps, max_blocks=max_blocks)
    err = engine.roundtrip_nrmse(stream[: engine._block_tuples() * 4]) if engine.codec.meta.lossy else 0.0
    mb = res.stats.input_bytes / 1e6
    return SolutionPoint(
        config=cfg,
        ratio=res.stats.ratio,
        nrmse=err,
        throughput_mbps=res.stats.input_bytes / 1e6 / max(res.makespan_s, 1e-12),
        latency_s=res.stats.latency_s or 0.0,
        energy_j_per_mb=(res.stats.energy_j or 0.0) / max(mb, 1e-12),
    )


def enumerate_solutions(
    stream: np.ndarray,
    arrival_rate_tps: float,
    constraints: Constraints,
    candidates: Sequence[Dict] = tuple(DEFAULT_CANDIDATES),
    lanes: int = 4,
    device: DeviceLike = None,
) -> List[SolutionPoint]:
    """`evaluate` over every candidate at the profile's cache-aware block
    size; candidates the codec refuses (ValueError) are skipped."""
    profile = energy_mod.PROFILES[constraints.profile]
    points = []
    for cand in candidates:
        cfg = EngineConfig(
            codec=cand["codec"],
            codec_kwargs=cand.get("codec_kwargs", {}),
            execution=ExecutionStrategy.LAZY,
            micro_batch_bytes=cache_aware_batch_bytes(profile),
            lanes=lanes,
            state=StateStrategy.PRIVATE,
            scheduling=SchedulingStrategy.ASYMMETRIC,
            profile=constraints.profile,
        )
        try:
            points.append(evaluate(cfg, stream, arrival_rate_tps, device=device))
        except ValueError:
            continue
    return points


def _config_key(cfg: EngineConfig) -> Tuple:
    """Canonical identity of a candidate config, independent of enumeration
    order: codec name, sorted resolved params, and the strategy knobs. The
    stable tie-break key for `choose`, and the identity `incumbent`
    matching uses, so hysteresis survives re-enumeration."""
    return (
        cfg.codec,
        tuple(sorted((str(k), str(v)) for k, v in cfg.codec_kwargs.items())),
        str(cfg.execution.value),
        str(cfg.state.value),
        str(cfg.scheduling.value),
        cfg.lanes,
        cfg.micro_batch_bytes,
    )


def _score(p: SolutionPoint, priority: Tuple[str, ...]) -> Tuple[float, ...]:
    """Lexicographic score tuple (higher is better). A metric name prefixed
    with '-' is minimized ('-energy_j_per_mb' prefers LOWER energy)."""
    out = []
    for k in priority:
        if k.startswith("-"):
            out.append(-float(getattr(p, k[1:])))
        else:
            out.append(float(getattr(p, k)))
    return tuple(out)


def choose(
    points: List[SolutionPoint],
    constraints: Constraints,
    priority: Tuple[str, ...] = ("ratio", "throughput_mbps"),
    incumbent: Optional[SolutionPoint] = None,
    hysteresis: float = 0.0,
) -> Optional[SolutionPoint]:
    """Pick the best feasible point by lexicographic priority.

    Ties resolve by the canonical config key, never by enumeration order.
    `incumbent` + `hysteresis` damp flapping for closed-loop callers: the
    incumbent (matched by config identity among the feasible points) is kept
    unless the challenger improves the FIRST priority metric by more than
    `hysteresis` (relative)."""
    feasible = [p for p in points if p.feasible(constraints)]
    if not feasible:
        return None
    best = max(
        feasible,
        key=lambda p: (_score(p, priority), tuple(map(str, _config_key(p.config)))),
    )
    if incumbent is not None and hysteresis > 0.0:
        inc_key = _config_key(incumbent.config)
        held = [p for p in feasible if _config_key(p.config) == inc_key]
        if held and _config_key(best.config) != inc_key:
            inc = held[0]
            b0, i0 = _score(best, priority)[0], _score(inc, priority)[0]
            # relative improvement on the lead metric; the sign guard makes
            # a minimized ('-'-prefixed) lead metric use the same margin rule
            if b0 <= i0 + abs(i0) * hysteresis:
                return inc
    return best


#: the adaptive tier ladder's ranking: end-to-end modeled throughput first,
#: then lower energy (ratio is already priced into throughput via transmit
#: time)
TIER_PRIORITY: Tuple[str, ...] = ("throughput_mbps", "-energy_j_per_mb")

#: tier points are modeled (lossless ladder, no budgets): always feasible
_TIER_CONSTRAINTS = Constraints(min_ratio=0.0, max_nrmse=1.0)


def choose_tier(
    points: List[SolutionPoint],
    incumbent: Optional[SolutionPoint] = None,
    hysteresis: float = 0.1,
) -> Optional[SolutionPoint]:
    """`choose` for the adaptive controller: the ladder's modeled points by
    TIER_PRIORITY, with the incumbent hysteresis margin."""
    return choose(
        points,
        _TIER_CONSTRAINTS,
        priority=TIER_PRIORITY,
        incumbent=incumbent,
        hysteresis=hysteresis,
    )
