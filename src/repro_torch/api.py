"""Job API, offline half (port of part of `repro/api.py`).

  * `JobSpec` — a frozen description of one compression job with the
    reference's fields, validation and `to_dict`/`from_dict` JSON, so a
    reference spec's dict loads here unchanged.
  * `run_compress` / `run_roundtrip` — one offline compression run
    (executor + schedule + latency layers), and compress -> frame ->
    decompress with the fidelity check.

`entropy="rans"` runs the rANS stage on the pipeline's device. The
pipelines refuse a spec whose `adaptive`, `dictionary`, `gang` or
`devices > 0` asks for a feature the port does not have yet, with a
one-line NotImplementedError naming the ROADMAP item. `negotiate`,
`open`/`StreamHandle` and `Dispatcher` come with a later slice.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import bits, metrics
from repro_torch.core.calibration import calibrated_kwargs
from repro_torch.core.energy import PROFILES, HardwareProfile, edge_energy_j
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline
from repro_torch.core.strategies import (
    ExecutionStrategy,
    SchedulingStrategy,
    StateStrategy,
    block_costs,
    schedule_blocks,
)

__all__ = [
    "JobSpec",
    "NegotiationError",
    "CompressResult",
    "RoundtripResult",
    "queueing_delay_s",
    "run_compress",
    "run_roundtrip",
    "ExecutionStrategy",
    "StateStrategy",
    "SchedulingStrategy",
]

#: scalar parameter types a JobSpec may carry (hashable, JSON-serializable)
_SCALAR = (bool, int, float, str)
#: trained-dictionary reference syntax: "topic", "topic:latest", "topic:vN"
_DICT_REF_RE = re.compile(r"^([A-Za-z0-9_.\-]+)(?::(latest|v?\d+))?$")


class NegotiationError(ValueError):
    """A JobSpec the API refuses; the message is one line and names the fix."""


def _err(msg: str) -> "NegotiationError":
    return NegotiationError(" ".join(msg.split()))


def parse_dict_ref(ref: str) -> Tuple[str, Optional[int]]:
    """Parse ``"topic"`` / ``"topic:latest"`` / ``"topic:v3"`` -> (topic,
    version); version is None for bare-topic and ``:latest`` refs."""
    m = _DICT_REF_RE.match(ref or "")
    if m is None:
        raise ValueError(
            f"malformed dictionary ref {ref!r}: expected 'topic', 'topic:latest', "
            f"or 'topic:vN' (topic chars: letters, digits, '_', '.', '-')"
        )
    topic, ver = m.group(1), m.group(2)
    if ver is None or ver == "latest":
        return topic, None
    return topic, int(ver.lstrip("v"))


# ------------------------------------------------------------------ JobSpec --
@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Declarative description of one compression job (the reference's
    fields and defaults). `params` are the RESOLVED codec parameters."""

    codec: str = "tcomp32"
    params: Tuple[Tuple[str, Any], ...] = ()
    # ---- block geometry / parallelization (paper §3.4) ----------------------
    lanes: int = 4
    micro_batch_bytes: int = 8192  # <= 0 = cache-aware auto (paper Fig 11)
    scan_chunk: int = 0  # 0 = auto, 1 = per-block dispatch, >1 = fixed fusion
    execution: ExecutionStrategy = ExecutionStrategy.LAZY
    state: StateStrategy = StateStrategy.PRIVATE
    scheduling: SchedulingStrategy = SchedulingStrategy.ASYMMETRIC
    #: hardware profile name (core/energy.py PROFILES)
    profile: str = "rk3399_amp"
    # ---- flush policy (serving runtime) -------------------------------------
    flush_tuples: int = 0  # 0 = one planned micro-batch block
    flush_timeout_s: float = 0.25
    # ---- egress / fidelity budget -------------------------------------------
    egress: bool = False
    max_abs_error: Optional[float] = None
    strict_masking: bool = False
    #: stage-2 entropy coder: "rans" codes each frame's sections with rANS
    entropy: Optional[str] = None
    #: adaptive tier selection (ROADMAP A8; refused by the port's pipelines)
    adaptive: bool = False
    #: gang dispatch (ROADMAP A6; refused by the port's pipelines)
    gang: bool = False
    #: arrival rate for the end-to-end latency model (paper §4.1)
    arrival_rate_tps: Optional[float] = None
    #: device-mesh width (ROADMAP A9; > 0 refused by the port's pipelines)
    devices: int = 0
    #: trained dictionary ref (ROADMAP A8; refused by the port's pipelines)
    dictionary: Optional[str] = None
    #: frame integrity: "crc32c" appends per-section CRC32C words
    integrity: Optional[str] = None

    # ------------------------------------------------------------ validation
    def __post_init__(self) -> None:
        object.__setattr__(self, "params", _freeze_params(self.codec, self.params))
        object.__setattr__(self, "execution", ExecutionStrategy(self.execution))
        object.__setattr__(self, "state", StateStrategy(self.state))
        object.__setattr__(self, "scheduling", SchedulingStrategy(self.scheduling))
        if not isinstance(self.codec, str) or not self.codec:
            raise _err(f"JobSpec.codec must be a codec name string, got {self.codec!r}")
        if not isinstance(self.lanes, int) or self.lanes < 1:
            raise _err(f"JobSpec.lanes must be an int >= 1, got {self.lanes!r}")
        if not isinstance(self.scan_chunk, int) or self.scan_chunk < 0:
            raise _err(f"JobSpec.scan_chunk must be an int >= 0 (0 = auto), got {self.scan_chunk!r}")
        if not isinstance(self.flush_tuples, int) or self.flush_tuples < 0:
            raise _err(f"JobSpec.flush_tuples must be an int >= 0 (0 = one block), got {self.flush_tuples!r}")
        if not self.flush_timeout_s > 0:
            raise _err(f"JobSpec.flush_timeout_s must be > 0, got {self.flush_timeout_s!r}")
        if self.max_abs_error is not None and not self.max_abs_error >= 0:
            raise _err(f"JobSpec.max_abs_error must be >= 0 or None, got {self.max_abs_error!r}")
        if self.arrival_rate_tps is not None and not self.arrival_rate_tps > 0:
            raise _err(f"JobSpec.arrival_rate_tps must be > 0 or None, got {self.arrival_rate_tps!r}")
        if not isinstance(self.devices, int) or self.devices < 0:
            raise _err(f"JobSpec.devices must be an int >= 0 (0 = dispatcher-local), got {self.devices!r}")
        if self.entropy not in (None, "rans"):
            raise _err(f"JobSpec.entropy must be None or 'rans', got {self.entropy!r}")
        if self.integrity is not None and self.integrity not in bits.INTEGRITY_KINDS:
            raise _err(
                f"JobSpec.integrity must be None or one of "
                f"{', '.join(map(repr, bits.INTEGRITY_KINDS))}, got {self.integrity!r}"
            )
        if not isinstance(self.adaptive, bool):
            raise _err(f"JobSpec.adaptive must be a bool, got {self.adaptive!r}")
        if self.dictionary is not None:
            if not isinstance(self.dictionary, str):
                raise _err(
                    f"JobSpec.dictionary must be a 'topic[:vN|:latest]' string "
                    f"or None, got {self.dictionary!r}"
                )
            try:
                parse_dict_ref(self.dictionary)
            except ValueError as e:
                raise _err(f"JobSpec.dictionary: {e}") from None
            if self.adaptive:
                raise _err(
                    "JobSpec.dictionary cannot combine with adaptive=True: the "
                    "tier ladder swaps codecs per flush and its rungs take no "
                    "dictionary; pin a tdic32 job instead"
                )

    # ------------------------------------------------------------ accessors
    @property
    def codec_kwargs(self) -> Dict[str, Any]:
        """Resolved codec parameters as a plain dict."""
        return dict(self.params)

    def hardware(self) -> HardwareProfile:
        """The resolved hardware profile."""
        if self.profile not in PROFILES:
            raise _err(
                f"unknown hardware profile {self.profile!r}; "
                f"available: {', '.join(sorted(PROFILES))}"
            )
        return PROFILES[self.profile]

    # ------------------------------------------------------------ transforms
    def replace(self, **changes: Any) -> "JobSpec":
        return dataclasses.replace(self, **changes)

    def calibrated(self, sample: np.ndarray) -> "JobSpec":
        """Bake sample-tuned codec parameters in (explicit params win)."""
        kwargs = self.codec_kwargs
        for k, v in calibrated_kwargs(self.codec, sample).items():
            kwargs.setdefault(k, v)
        return self.replace(params=kwargs)

    # ------------------------------------------------------- (de)serialization
    def to_dict(self) -> Dict[str, Any]:
        """JSON-able dict; `from_dict` inverts it exactly."""
        return {
            "codec": self.codec,
            "params": self.codec_kwargs,
            "lanes": self.lanes,
            "micro_batch_bytes": self.micro_batch_bytes,
            "scan_chunk": self.scan_chunk,
            "execution": self.execution.value,
            "state": self.state.value,
            "scheduling": self.scheduling.value,
            "profile": self.profile,
            "flush_tuples": self.flush_tuples,
            "flush_timeout_s": self.flush_timeout_s,
            "egress": self.egress,
            "max_abs_error": self.max_abs_error,
            "strict_masking": self.strict_masking,
            "entropy": self.entropy,
            "adaptive": self.adaptive,
            "gang": self.gang,
            "arrival_rate_tps": self.arrival_rate_tps,
            "devices": self.devices,
            "dictionary": self.dictionary,
            "integrity": self.integrity,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JobSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise _err(
                f"JobSpec.from_dict got unknown key(s) {', '.join(map(repr, unknown))}; "
                f"accepted: {', '.join(sorted(fields))}"
            )
        return cls(**dict(d))

    @property
    def calibrate(self) -> bool:
        return False  # a JobSpec's params are resolved by construction


def _freeze_params(codec: str, params: Any) -> Tuple[Tuple[str, Any], ...]:
    """Normalize codec params to a sorted tuple of (name, scalar) pairs."""
    items = list(params.items()) if isinstance(params, Mapping) else [tuple(p) for p in params]
    out = []
    for k, v in sorted(items):
        if isinstance(v, np.generic):
            v = v.item()
        if not isinstance(v, _SCALAR):
            raise _err(
                f"JobSpec param {k!r} of codec {codec!r} must be a scalar "
                f"(bool/int/float/str), got {type(v).__name__} — array-valued "
                "tuning belongs in the codec's calibration, not the spec"
            )
        out.append((str(k), v))
    return tuple(out)


# ------------------------------------------------------------- result types --
@dataclasses.dataclass
class CompressResult:
    stats: metrics.RunStats
    total_bits: float
    n_tuples: int
    per_block_bits: np.ndarray
    makespan_s: float
    busy_s: List[float]
    blocked_s: float  # dispatch/sync overhead (paper Fig 10b 'blocked time')
    running_s: float  # pure compression time
    frame: Optional[bits.Frame] = None  # wire-format payload (emit_frame=True)


@dataclasses.dataclass
class RoundtripResult:
    """compress -> framed bitstream -> decompress, with the fidelity check."""

    compress: CompressResult
    values: np.ndarray  # reconstructed stream (uint32[n_tuples])
    fidelity: metrics.Fidelity
    decode_wall_s: float
    wire_bytes: int  # serialized frame size (header + metadata + payload)


def queueing_delay_s(proc_s: float, batch_fill_s: float, max_factor: float = 20.0) -> float:
    """Smoothed M/D/1-style queueing term for the latency model (paper §4.1):
    `rho / (1 - rho)` growth clamped to `max_factor`, continuous through
    saturation."""
    rho = proc_s / max(batch_fill_s, 1e-12)
    growth = rho / (1.0 - rho) if rho < 1.0 else float("inf")
    return 0.5 * proc_s * min(growth, max_factor)


# ---------------------------------------------------------- offline executors --
def run_compress(
    pipe: CompressionPipeline,
    spec: JobSpec,
    values: np.ndarray,
    arrival_rate_tps: Optional[float] = None,
    emit_frame: bool = False,
) -> CompressResult:
    """One offline compression run: executor + schedule + latency layers.
    With `emit_frame` the egress takes the device compaction path."""
    shaped = pipe.shape_blocks(np.asarray(values, np.uint32))

    res = pipe.execute(shaped, collect_payload=emit_frame)
    wall = res.wall_s
    per_block_bits = res.per_block_bits
    total_bits = float(per_block_bits.sum())
    n_tuples = res.n_tuples
    n_blocks = shaped.n_blocks

    # ---- schedule layer: map blocks onto the hardware profile ---------
    profile = spec.hardware()
    per_block_cost = wall / max(n_blocks, 1)
    costs = block_costs(wall, per_block_bits)
    _, busy, makespan = schedule_blocks(costs, profile.speeds, spec.scheduling)
    # uniform scheduling implies barrier spin-wait (paper Fig 13b)
    energy = edge_energy_j(
        profile, busy, makespan,
        spin_wait=spec.scheduling == SchedulingStrategy.UNIFORM,
    )

    # ---- latency model (paper §4.1 end-to-end latency) -----------------
    latency = None
    if arrival_rate_tps:
        batch_fill_s = pipe.block_tuples / arrival_rate_tps
        proc = per_block_cost
        latency = batch_fill_s / 2.0 + proc + queueing_delay_s(proc, batch_fill_s)

    input_bytes = n_tuples * 4
    stats = metrics.RunStats(
        name=f"{pipe.codec.name}/{spec.execution.value}/{spec.state.value}/{spec.scheduling.value}",
        input_bytes=input_bytes,
        output_bytes=total_bits / 8.0,
        wall_s=wall,
        ratio=metrics.compression_ratio(input_bytes * 8, total_bits),
        latency_s=latency,
        energy_j=energy,
    )
    running = min(per_block_cost * n_blocks, wall)
    return CompressResult(
        stats=stats,
        total_bits=total_bits,
        n_tuples=n_tuples,
        per_block_bits=per_block_bits,
        makespan_s=makespan,
        busy_s=busy,
        blocked_s=max(wall - running, 0.0),
        running_s=running,
        frame=pipe.frame_from(shaped, res) if emit_frame else None,
    )


def run_roundtrip(
    pipe: CompressionPipeline,
    decomp: DecompressionPipeline,
    spec: JobSpec,
    values: np.ndarray,
    arrival_rate_tps: Optional[float] = None,
) -> RoundtripResult:
    """Compress to the wire frame, decode it back, check fidelity: lossless
    codecs must come back bit-exact."""
    values = np.asarray(values, np.uint32).ravel()
    res = run_compress(pipe, spec, values, arrival_rate_tps=arrival_rate_tps, emit_frame=True)
    dec = decomp.decompress(res.frame)
    fid = metrics.fidelity(
        values[: dec.n_tuples], dec.values, bound=pipe.codec.error_bound()
    )
    return RoundtripResult(
        compress=res,
        values=dec.values,
        fidelity=fid,
        decode_wall_s=dec.wall_s,
        wire_bytes=res.frame.wire_bytes,
    )
