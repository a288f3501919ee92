"""Parallelization strategies (paper §3.4): execution, state management,
scheduling — plus the cache-aware micro-batch planner (port of
`repro/core/strategies.py`). The gang plan sizes the serving runtime's
gang waves; the fleet plan scales it over a device mesh (the job API's
`Plan.fleet` and the fleet server's per-signature wave caps and budgets)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Mapping, Protocol, Sequence, Tuple

from repro_torch.core import energy as energy_mod


class ExecutionStrategy(str, enum.Enum):
    EAGER = "eager"  # per-tuple, streaming-faithful, poor HW utilization
    LAZY = "lazy"  # micro-batched (paper default: 400B; tuned per Fig 11)


class StateStrategy(str, enum.Enum):
    PRIVATE = "private"  # per-worker state, zero coordination (paper pick)
    SHARED = "shared"  # merged dictionary per micro-batch (collective cost)


class SchedulingStrategy(str, enum.Enum):
    UNIFORM = "uniform"  # balanced partition / equal distribution [39]
    ASYMMETRIC = "asymmetric"  # asymmetry-aware (paper [4]): cost-model LPT


class SpecLike(Protocol):
    """Structural config carrier the executor/policy layers consume.

    Both the legacy `EngineConfig` and the job API's `repro_torch.api.JobSpec`
    satisfy it, so `plan_execution`, the pipelines and the serving runtime
    accept either without importing the API layer (no circular imports)."""

    @property
    def codec(self) -> str: ...

    @property
    def codec_kwargs(self) -> Mapping[str, Any]: ...

    @property
    def calibrate(self) -> bool: ...

    @property
    def execution(self) -> "ExecutionStrategy": ...

    @property
    def state(self) -> "StateStrategy": ...

    @property
    def scheduling(self) -> "SchedulingStrategy": ...

    @property
    def micro_batch_bytes(self) -> int: ...

    @property
    def lanes(self) -> int: ...

    @property
    def scan_chunk(self) -> int: ...

    def hardware(self) -> energy_mod.HardwareProfile: ...


@dataclasses.dataclass
class EngineConfig:
    codec: str = "tcomp32"
    codec_kwargs: Dict = dataclasses.field(default_factory=dict)
    execution: ExecutionStrategy = ExecutionStrategy.LAZY
    micro_batch_bytes: int = 8192
    lanes: int = 4  # parallel substreams (threads -> SIMD lanes/devices)
    state: StateStrategy = StateStrategy.PRIVATE
    scheduling: SchedulingStrategy = SchedulingStrategy.ASYMMETRIC
    profile: str = "rk3399_amp"
    calibrate: bool = True
    #: lazy-path scan fusion override: 0 = auto (plan_execution decides);
    #: 1 = one dispatch per micro-batch (streaming-faithful, a batch can't
    #: fuse with batches that haven't arrived yet); >1 = fixed fusion length
    scan_chunk: int = 0

    def hardware(self) -> energy_mod.HardwareProfile:
        return energy_mod.PROFILES[self.profile]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolved execution decisions for one stream/config (policy layer).

    `plan_execution` is the single place where batch sizing, scan fusion
    granularity and scheduling policy are decided; the executor
    (core/pipeline.py) and the serving runtime (runtime/server.py) both
    consume the plan instead of re-deriving these numbers locally
    (DESIGN.md §3)."""

    execution: ExecutionStrategy
    scheduling: SchedulingStrategy
    micro_batch_bytes: int  # resolved (cache-aware when the config says auto)
    per_lane: int  # tuples per lane per micro-batch block
    lanes: int
    scan_chunk: int  # blocks fused per chunk dispatch (1 = eager)

    @property
    def block_tuples(self) -> int:
        return self.per_lane * self.lanes


#: bytes of blocks one fused scan dispatch should cover — enough to amortize
#: a dispatch over many blocks without unbounded trace length
_SCAN_TARGET_BYTES = 4 << 20
_SCAN_CHUNK_MAX = 128


def plan_execution(
    config: SpecLike,
    profile: energy_mod.HardwareProfile = None,
    codec_align: int = 1,
) -> ExecutionPlan:
    """Decide block shaping, scan fusion and scheduling for a config.

    * micro-batch bytes: the config value, or the cache-aware optimum
      (paper Fig 11) when the config asks for auto (<= 0);
    * block tuples: micro-batch split over `lanes` substreams, aligned to
      `codec_align` (e.g. PLA superwindows need per-lane multiples of 2W);
    * scan chunk: how many blocks one fused chunk dispatch covers —
      eager keeps chunk 1 (per-block dispatch, the paper's per-tuple
      baseline), lazy amortizes dispatch over ~_SCAN_TARGET_BYTES.
    """
    profile = profile or config.hardware()
    mbb = config.micro_batch_bytes
    if mbb <= 0:
        mbb = cache_aware_batch_bytes(profile)
    if config.execution == ExecutionStrategy.EAGER:
        # one ALIGNED unit per lane per dispatch: pinning per_lane to 1 would
        # violate codec block constraints (PLA superwindows need per-lane
        # multiples of 2W) — eager means smallest legal block, not 1 tuple
        per_lane = codec_align
    else:
        per_lane = max(1, mbb // 4 // config.lanes)
        per_lane = max(codec_align, (per_lane // codec_align) * codec_align)
    block_bytes = per_lane * config.lanes * 4
    if config.execution == ExecutionStrategy.EAGER:
        scan_chunk = 1
    elif config.scan_chunk > 0:
        scan_chunk = config.scan_chunk
    else:
        scan_chunk = max(1, min(_SCAN_CHUNK_MAX, _SCAN_TARGET_BYTES // max(block_bytes, 1)))
    return ExecutionPlan(
        execution=config.execution,
        scheduling=config.scheduling,
        micro_batch_bytes=mbb,
        per_lane=per_lane,
        lanes=config.lanes,
        scan_chunk=scan_chunk,
    )


@dataclasses.dataclass(frozen=True)
class GangPlan:
    """Resolved inter-stream gang batching decisions.

    `max_gang` streams with the same dispatch signature would stack along a
    leading stream axis into ONE codec dispatch; `quantum_s` is the
    scheduling quantum a server collects flushes over before firing gangs;
    `budget` is the per-signature admission budget, past which a queue
    forces an immediate gang dispatch (backpressure)."""

    max_gang: int
    quantum_s: float
    budget: int
    block_bytes: int  # one gang member's micro-batch footprint
    cache_bytes: int  # budget the gang working set was sized against


#: never stack more streams than this in one dispatch, regardless of cache
#: headroom
_GANG_MAX = 64


def plan_gang(
    plan: ExecutionPlan,
    profile: energy_mod.HardwareProfile = None,
    flush_timeout_s: float = 0.25,
) -> GangPlan:
    """Size the gang for one dispatch signature (paper §3.4 applied ACROSS
    streams): stack streams while (a) the stacked working set stays inside
    the cache-aware byte budget (Fig 11's rule, applied to the gang), and
    (b) the modeled amortized makespan of scheduling the members' blocks
    over the asymmetric profile keeps improving."""
    profile = profile or energy_mod.PROFILES["rk3399_amp"]
    block_bytes = plan.block_tuples * 4
    cache_bytes = cache_aware_batch_bytes(profile)
    cache_cap = max(1, cache_bytes // max(block_bytes, 1))
    best_g, best_amortized = 1, None
    for g in range(1, min(cache_cap, _GANG_MAX) + 1):
        _, _, makespan = schedule_blocks(
            [1.0] * g, profile.speeds, SchedulingStrategy.ASYMMETRIC
        )
        amortized = makespan / g
        if best_amortized is None or amortized <= best_amortized:
            best_g, best_amortized = g, amortized
    return GangPlan(
        max_gang=best_g,
        # half a timeout: a quantum never delays a flush past the point
        # where its successor batch would also be due
        quantum_s=flush_timeout_s / 2.0,
        budget=2 * best_g,
        block_bytes=block_bytes,
        cache_bytes=cache_bytes,
    )


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A signature's GangPlan scaled out over a device mesh: one sharded
    wave covers `max_wave = devices x max_gang` streams, and the admission
    budget scales the same way."""

    devices: int
    max_wave: int  # streams per sharded dispatch
    budget: int  # fleet-wide per-signature backpressure budget
    quantum_s: float


def plan_fleet(gang: GangPlan, devices: int) -> FleetPlan:
    """Scale one dispatch signature's gang sizing across `devices` shards."""
    if devices < 1:
        raise ValueError(f"fleet needs >= 1 device, got {devices}")
    return FleetPlan(
        devices=devices,
        max_wave=gang.max_gang * devices,
        budget=gang.budget * devices,
        quantum_s=gang.quantum_s,
    )


def resolve_capacity(
    block_tuples: int, lanes: int, align: int, flush_tuples: int = 0
) -> int:
    """Session flush capacity: the requested tuple count (or one planned
    micro-batch block when 0), rounded UP to the lane-aligned unit the codec
    requires. The ONE definition — `StreamSession` and the job-API
    negotiation layer must agree or gang signatures diverge."""
    unit = lanes * align
    cap = flush_tuples if flush_tuples > 0 else block_tuples
    return max(unit, ((cap + unit - 1) // unit) * unit)


def cache_aware_batch_bytes(profile: energy_mod.HardwareProfile) -> int:
    """Paper Fig 11: optimal micro-batch ~= total L1D of the active cores.

    """
    return profile.total_l1d_bytes


# ------------------------------------------------------------- scheduling --
def block_costs(wall_s: float, per_block_bits) -> List[float]:
    """Per-block schedule costs from a measured run: mean per-block cost at
    speed 1.0, scaled by each block's share of emitted bits. The one cost
    model both the engine's schedule layer and the Fig 13 bench use."""
    n_blocks = len(per_block_bits)
    per_block_cost = wall_s / max(n_blocks, 1)
    mean = sum(per_block_bits) / max(n_blocks, 1)
    return [per_block_cost * b / max(mean, 1.0) for b in per_block_bits]


def schedule_blocks(
    costs: Sequence[float],
    speeds: Sequence[float],
    policy: SchedulingStrategy,
    stage_split: Tuple[float, float] = (0.3, 0.7),
) -> Tuple[List[List[int]], List[float], float]:
    """Assign micro-batch blocks to workers; return (assignment, busy_s, makespan).

    Asymmetry-aware policy is LPT with a stage-aware cost model: the memory
    bound fraction of a block (s0 load, `stage_split[0]`) gains little from a
    faster core (paper Fig 6a: out-of-order big cores are over-provisioned for
    s0), while transform/emit (s1+s2) scale with core speed.
    """
    n_workers = len(speeds)
    assignment: List[List[int]] = [[] for _ in range(n_workers)]
    busy = [0.0] * n_workers

    def block_time(cost: float, speed: float) -> float:
        mem_frac, cmp_frac = stage_split
        mem_speed = min(speed, 1.2)  # memory stage barely scales
        return cost * (mem_frac / mem_speed + cmp_frac / speed)

    if policy == SchedulingStrategy.UNIFORM:
        # balanced partition, equal distribution ratio [39]
        for i, c in enumerate(costs):
            w = i % n_workers
            assignment[w].append(i)
            busy[w] += block_time(c, speeds[w])
    else:
        # LPT greedy: biggest block to the worker that finishes it earliest
        order = sorted(range(len(costs)), key=lambda i: -costs[i])
        for i in order:
            w = min(
                range(n_workers), key=lambda j: busy[j] + block_time(costs[i], speeds[j])
            )
            assignment[w].append(i)
            busy[w] += block_time(costs[i], speeds[w])
    return assignment, busy, max(busy) if busy else 0.0
