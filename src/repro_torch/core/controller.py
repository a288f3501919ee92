"""Adaptive selective-compression controller (port of
`repro/core/controller.py`).

The right compression choice depends on the hardware AND the stream, yet a
negotiated job normally pins one codec for its whole lifetime. When the
egress link is fast, or the payload incompressible, the cycles spent
compressing never pay for themselves. This module closes that loop per
stream:

    flush k commits --> observe(tier, tuples, payload_bits)   [EWMA drift]
                                   |
                                   v
    decide() --> tier ladder costed on (ratio est., compress cost from the
                 energy model, egress bandwidth from the modeled link)
                                   |
                                   v
    flush k+1 compresses under the chosen tier  (switches land ONLY at
    flush boundaries; frames are self-describing, decode stays oblivious)

The ladder has three rungs, {bypass, cheap, heavy}, resolved against the
codec registry at negotiation time (`JobSpec.adaptive=True`):

    bypass : raw32            no transform; wins on fast links / random data
    cheap  : leb128           one cheap pass; the broad middle of the sweep
    heavy  : delta_leb128+rANS  max ratio; wins when the link is the choke

Tier selection goes through `core.planner.choose_tier` (lexicographic
priority with deterministic tie-breaks) with an incumbent + hysteresis
margin. Every cost input is *modeled* (the energy model's per-profile
speeds price compress time, the ModeledLink prices transmit time), never
timed, so a stream's decisions are the reference's, run to run and device
to device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import energy as energy_mod
from repro_torch.core import planner
from repro_torch.core.algorithms import WIRE_CODEC_IDS, codec_names, make_codec
from repro_torch.core.strategies import (
    EngineConfig,
    ExecutionStrategy,
    SchedulingStrategy,
    StateStrategy,
)

# --------------------------------------------------------------- cost model
#: modeled codec throughput: tuples/s contributed per unit of relative core
#: speed at work factor 1.0 (the cheap tier's single transform pass). The
#: constant is pinned so the ladder's crossovers land INSIDE the 1-100 MB/s
#: link sweep on rk3399_amp (sum of speeds = 8): heavy->cheap near ~3 MB/s
#: and cheap->bypass near ~60 MB/s on zipf-compressible data.
MODEL_TUPLES_PER_S_PER_SPEED = 2.0e6

#: relative compress work per tier (multiplies the base pass above). bypass
#: still pays for the copy + frame build; heavy pays the transform AND the
#: interleaved rANS stage.
WORK_FACTORS = {"bypass": 0.3, "cheap": 1.0, "heavy": 4.0}

#: radio cost of pushing one MB over the egress link (J/MB) — mid-range of
#: published WiFi/LTE figures; only the RELATIVE weight vs compute matters.
TX_J_PER_MB = 0.55

#: wire overhead per tuple beyond codec payload bits: the frame's 7-bit
#: bitlen metadata stream (core/bits.py).
META_BITS_PER_TUPLE = 7.0

#: fixed per-frame wire overhead (header + block table), amortized per MB in
#: the model as a constant — negligible at flush sizes, kept for honesty.
HEADER_BYTES = 64

TUPLE_BYTES = 4
BITS_PER_TUPLE_RAW = 32.0


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the ladder: a codec + entropy combo with a modeled cost."""

    name: str  # "bypass" | "cheap" | "heavy"
    codec: str
    codec_kwargs: Tuple[Tuple[str, str], ...]
    entropy: str  # "none" | "rans"
    work_factor: float

    @property
    def kwargs_dict(self) -> Dict[str, str]:
        return dict(self.codec_kwargs)


def _tier(name: str, codec: str, entropy: str, **kwargs: object) -> TierSpec:
    return TierSpec(
        name=name,
        codec=codec,
        codec_kwargs=tuple(sorted((str(k), str(v)) for k, v in kwargs.items())),
        entropy=entropy,
        work_factor=WORK_FACTORS[name],
    )


DEFAULT_LADDER: Tuple[TierSpec, ...] = (
    _tier("bypass", "raw32", "none"),
    _tier("cheap", "leb128", "none"),
    _tier("heavy", "delta_leb128", "rans"),
)

#: prior payload bits/tuple per tier before any probe or observation — a
#: mildly-compressible prior so a cold controller starts on the cheap rung.
DEFAULT_PROBE_BITS = {"bypass": 32.0, "cheap": 14.0, "heavy": 9.0}


def resolve_ladder(
    cheap: str = "leb128",
    heavy: str = "delta_leb128",
    heavy_entropy: str = "rans",
) -> Tuple[TierSpec, ...]:
    """Validate and build the tier ladder from registry capabilities.

    Raises single-line ValueError (negotiation wraps it as NegotiationError):
    every rung must be a registered wire codec, every rung must be lossless
    (tier switches must never change fidelity mid-stream), and the bypass
    rung is always raw32.
    """
    names = set(codec_names())
    for role, cname in (("cheap", cheap), ("heavy", heavy)):
        if cname not in names:
            raise ValueError(
                f"adaptive {role} tier codec '{cname}' is not registered; "
                f"known: {sorted(names)}"
            )
        if cname not in WIRE_CODEC_IDS:
            raise ValueError(
                f"adaptive {role} tier codec '{cname}' has no wire id; "
                "adaptive sessions emit self-describing frames"
            )
        if make_codec(cname).meta.lossy:
            raise ValueError(
                f"adaptive {role} tier codec '{cname}' is lossy; tier "
                "switches must not change stream fidelity mid-session"
            )
    if heavy_entropy not in ("none", "rans"):
        raise ValueError(
            f"adaptive heavy tier entropy '{heavy_entropy}' unknown; "
            "expected 'none' or 'rans'"
        )
    return (
        _tier("bypass", "raw32", "none"),
        _tier("cheap", cheap, "none"),
        _tier("heavy", heavy, heavy_entropy),
    )


# ------------------------------------------------------------ modeled link
class ModeledLink:
    """Deterministic egress link: constant bandwidth or a per-flush trace.

    The serving runtime has no radio — the link is *modeled*, exactly like
    the energy model prices cores it does not own. A trace (MB/s per flush
    index, last value held) lets tests and benches script bandwidth drift.
    """

    def __init__(self, bandwidth_mbps: float | Sequence[float]):
        if isinstance(bandwidth_mbps, (int, float)):
            self._trace = [float(bandwidth_mbps)]
        else:
            self._trace = [float(b) for b in bandwidth_mbps]
        if not self._trace or min(self._trace) <= 0:
            raise ValueError("ModeledLink bandwidth trace must be positive")

    def bandwidth_mbps(self, flush_index: int) -> float:
        return self._trace[min(flush_index, len(self._trace) - 1)]

    def transmit_s(self, wire_bytes: int, flush_index: int) -> float:
        return wire_bytes / 1e6 / self.bandwidth_mbps(flush_index)


# ------------------------------------------------------------- tier costing
def compress_seconds_per_mb(tier: TierSpec, profile: str) -> float:
    """Modeled wall-clock to compress 1 MB of input under `tier`."""
    prof = energy_mod.PROFILES[profile]
    tuples_per_s = MODEL_TUPLES_PER_S_PER_SPEED * sum(prof.speeds)
    mb_per_s = tuples_per_s * TUPLE_BYTES / 1e6
    return tier.work_factor / mb_per_s


def wire_bits_per_tuple(payload_bits_per_tuple: float) -> float:
    return payload_bits_per_tuple + META_BITS_PER_TUPLE


def tier_point(
    tier: TierSpec,
    payload_bits_per_tuple: float,
    bandwidth_mbps: float,
    profile: str = "rk3399_amp",
    lanes: int = 4,
) -> planner.SolutionPoint:
    """Price one rung as a planner SolutionPoint (per MB of input).

    throughput = 1 / (compress time + transmit time); transmit is priced on
    WIRE bytes (payload + per-tuple metadata + amortized header), so bypass
    honestly pays its 7/32 metadata overhead. Energy = active-core compute
    energy + radio energy on wire bytes.
    """
    prof = energy_mod.PROFILES[profile]
    comp_s = compress_seconds_per_mb(tier, profile)
    wire_bits = wire_bits_per_tuple(payload_bits_per_tuple)
    tuples_per_mb = 1e6 / TUPLE_BYTES
    wire_mb = (wire_bits * tuples_per_mb / 8.0 + HEADER_BYTES) / 1e6
    tx_s = wire_mb / bandwidth_mbps
    active_w = sum(c.p_active_w for c in prof.cores)
    energy = comp_s * active_w + TX_J_PER_MB * wire_mb
    cfg = EngineConfig(
        codec=tier.codec,
        codec_kwargs=tier.kwargs_dict,
        execution=ExecutionStrategy.LAZY,
        micro_batch_bytes=1 << 16,
        lanes=lanes,
        state=StateStrategy.PRIVATE,
        scheduling=SchedulingStrategy.ASYMMETRIC,
        profile=profile,
    )
    return planner.SolutionPoint(
        config=cfg,
        ratio=BITS_PER_TUPLE_RAW / wire_bits,
        nrmse=0.0,
        throughput_mbps=1.0 / (comp_s + tx_s),
        latency_s=comp_s + tx_s,
        energy_j_per_mb=energy,
    )


# ------------------------------------------------------------- controllers
@dataclasses.dataclass
class Decision:
    """One controller step, kept for golden decision-table tests."""

    flush_index: int
    tier: str
    bandwidth_mbps: float
    est_bits_per_tuple: Dict[str, float]
    throughput_mbps: float
    energy_j_per_mb: float


class AdaptiveController:
    """Closed-loop tier selector: observe flush outcomes, decide the next.

    Drift tracking: the controller keeps ONE scalar compressibility
    multiplier as an EWMA — each observed flush's achieved payload bits per
    tuple, relative to the active tier's probe estimate, nudges it. The
    multiplier scales every non-bypass rung's estimate (bypass is exactly 32
    bits by construction), so a stream drifting toward incompressibility
    raises all compressed rungs' modeled wire size together even though only
    one rung is ever observed at a time.

    Decisions go through `planner.choose` with priority (throughput, then
    -energy) plus an incumbent hysteresis margin: a challenger rung must
    beat the incumbent's modeled throughput by `hysteresis` (relative)
    to take over. Fully deterministic: no randomness, EWMA state only.
    """

    def __init__(
        self,
        ladder: Sequence[TierSpec] = DEFAULT_LADDER,
        profile: str = "rk3399_amp",
        link: Optional[ModeledLink] = None,
        probe_bits: Optional[Mapping[str, float]] = None,
        alpha: float = 0.25,
        hysteresis: float = 0.1,
        lanes: int = 4,
    ):
        if not ladder:
            raise ValueError("adaptive ladder must have at least one tier")
        self.ladder = tuple(ladder)
        self.profile = profile
        self.link = link or ModeledLink(10.0)
        self.probe_bits = dict(DEFAULT_PROBE_BITS)
        if probe_bits:
            self.probe_bits.update({k: float(v) for k, v in probe_bits.items()})
        self.alpha = alpha
        self.hysteresis = hysteresis
        self.lanes = lanes
        self._drift = 1.0
        self._bw_ewma: Optional[float] = None
        self._incumbent: Optional[str] = None
        self.flushes = 0
        self.switches = 0
        self.decisions: List[Decision] = []

    # -- telemetry in ------------------------------------------------------
    def observe(
        self,
        tier_name: str,
        n_tuples: int,
        payload_bits: int,
        bandwidth_mbps: Optional[float] = None,
    ) -> None:
        """Feed one committed flush's outcome back into the loop."""
        self.flushes += 1
        if n_tuples > 0 and tier_name != "bypass":
            base = self.probe_bits.get(tier_name, 0.0)
            if base > 0:
                inst = (payload_bits / n_tuples) / base
                self._drift = self.alpha * inst + (1 - self.alpha) * self._drift
        if bandwidth_mbps is not None and bandwidth_mbps > 0:
            if self._bw_ewma is None:
                self._bw_ewma = float(bandwidth_mbps)
            else:
                self._bw_ewma = (
                    self.alpha * bandwidth_mbps + (1 - self.alpha) * self._bw_ewma
                )

    def est_bits(self, tier: TierSpec) -> float:
        """Current payload-bits/tuple estimate for a rung (drift-scaled)."""
        if tier.name == "bypass":
            return BITS_PER_TUPLE_RAW
        # leb-style codecs top out near 40 bits/tuple on adversarial input
        return min(40.0, self.probe_bits.get(tier.name, 16.0) * self._drift)

    # -- decision out ------------------------------------------------------
    def decide(self, bandwidth_mbps: Optional[float] = None) -> TierSpec:
        """Pick the tier for the NEXT flush (switches land at boundaries)."""
        bw = bandwidth_mbps
        if bw is None:
            bw = self._bw_ewma
        if bw is None:
            bw = self.link.bandwidth_mbps(self.flushes)
        est = {t.name: self.est_bits(t) for t in self.ladder}
        points = [
            tier_point(t, est[t.name], bw, self.profile, self.lanes)
            for t in self.ladder
        ]
        by_name = dict(zip([t.name for t in self.ladder], points))
        incumbent = by_name.get(self._incumbent) if self._incumbent else None
        best = planner.choose_tier(
            points, incumbent=incumbent, hysteresis=self.hysteresis
        )
        assert best is not None  # ladder points are always feasible
        chosen = self.ladder[points.index(best)]
        if self._incumbent is not None and chosen.name != self._incumbent:
            self.switches += 1
        self._incumbent = chosen.name
        self.decisions.append(
            Decision(
                flush_index=self.flushes,
                tier=chosen.name,
                bandwidth_mbps=bw,
                est_bits_per_tuple=est,
                throughput_mbps=best.throughput_mbps,
                energy_j_per_mb=best.energy_j_per_mb,
            )
        )
        return chosen


class ScriptedController:
    """Fixed tier schedule — drives the tier-switch correctness grid.

    Presents the same observe/decide surface as AdaptiveController but
    returns a pre-scripted sequence of rung names (last one held), so tests
    can force e.g. bypass->heavy at a known flush boundary.
    """

    def __init__(self, ladder: Sequence[TierSpec], schedule: Sequence[str]):
        self.ladder = tuple(ladder)
        by_name = {t.name: t for t in self.ladder}
        unknown = [s for s in schedule if s not in by_name]
        if unknown or not schedule:
            raise ValueError(f"scripted schedule names unknown tiers: {unknown}")
        self._schedule = [by_name[s] for s in schedule]
        self.flushes = 0
        self.switches = 0

    def observe(
        self,
        tier_name: str,
        n_tuples: int,
        payload_bits: int,
        bandwidth_mbps: Optional[float] = None,
    ) -> None:
        self.flushes += 1

    def decide(self, bandwidth_mbps: Optional[float] = None) -> TierSpec:
        i = min(self.flushes, len(self._schedule) - 1)
        chosen = self._schedule[i]
        prev = self._schedule[max(0, min(self.flushes - 1, len(self._schedule) - 1))]
        if self.flushes > 0 and chosen.name != prev.name:
            self.switches += 1
        return chosen


def probe_bits_from_wire(
    wire_bytes: Mapping[str, int], n_tuples: int
) -> Dict[str, float]:
    """Convert measured per-tier WIRE bytes (from real probe sessions) into
    the controller's payload-bits/tuple estimates, inverting the wire model
    (payload = wire - metadata - header). Exact probes make the controller's
    decisions provably frontier-optimal on stationary workloads."""
    out: Dict[str, float] = {}
    for name, wb in wire_bytes.items():
        payload_bits = max(0.0, (wb - HEADER_BYTES) * 8.0 - META_BITS_PER_TUPLE * n_tuples)
        out[name] = payload_bits / max(1, n_tuples)
    return out


__all__ = [
    "AdaptiveController",
    "Decision",
    "DEFAULT_LADDER",
    "DEFAULT_PROBE_BITS",
    "ModeledLink",
    "ScriptedController",
    "TierSpec",
    "WORK_FACTORS",
    "compress_seconds_per_mb",
    "probe_bits_from_wire",
    "resolve_ladder",
    "tier_point",
    "wire_bits_per_tuple",
]
