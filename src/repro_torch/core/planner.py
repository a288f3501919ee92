"""Solution-space planner (port of `repro/core/planner.py`; paper §5.1,
Fig 4).

Filters candidate configurations by the user's constraints (min ratio, max
NRMSE, energy budget) and picks by lexicographic priority; the adaptive
tier controller (`core/controller.py`) ranks its ladder through
`choose_tier`. Measuring candidates on a sample window (`evaluate`,
`enumerate_solutions`) runs through the reference's `CStreamEngine` shim,
which waits for ROADMAP A6 here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.strategies import EngineConfig


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


_ENGINE_A6 = (
    "measures candidates through the CStreamEngine shim, which repro_torch "
    "does not have yet (ROADMAP A6); run it on repro"
)


def evaluate(
    cfg: EngineConfig, stream: np.ndarray, arrival_rate_tps: float, max_blocks: int = 16
) -> SolutionPoint:
    raise NotImplementedError(f"planner.evaluate {_ENGINE_A6}")


def enumerate_solutions(
    stream: np.ndarray,
    arrival_rate_tps: float,
    constraints: Constraints,
    candidates: Sequence[Dict] = (),
    lanes: int = 4,
) -> List[SolutionPoint]:
    raise NotImplementedError(f"planner.enumerate_solutions {_ENGINE_A6}")


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
