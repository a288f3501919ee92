"""The job API, offline half (port of `repro/api.py`), exported as
`repro_torch.cstream`:

    spec   = cstream.JobSpec(codec="rle", egress=True)        # declare
    plan   = cstream.negotiate(spec)                          # capability check
    handle = cstream.open(spec)                               # execute
    handle.push(values); handle.flush(); report = handle.close()

  * `JobSpec` — a frozen description of one compression job with the
    reference's fields, validation and `to_dict`/`from_dict` JSON, so a
    reference spec's dict loads here unchanged.
  * `negotiate(spec) -> Plan` — codecs declare what they can do
    (`CodecCapability`) and negotiation composes `plan_execution`/
    `plan_gang`, a trained dictionary (`dictstore`) and the adaptive tier
    ladder (`controller`), turning every invalid combination into the
    reference's single-line `NegotiationError`.
  * `StreamHandle` — `open(spec)`: push/flush/frames/report/close over
    independent segments, with `swap_dictionary` and the adaptive ladder;
    or `Dispatcher.open(spec)`: a server session whose timestamped feed
    `Dispatcher.run()` replays (size-or-timeout flushes, optional gang
    dispatch, `topic:latest` hot swaps on publish).
  * `run_compress` / `run_roundtrip` / `run_gang_compress` — one offline
    compression run, compress -> frame -> decompress with the fidelity
    check, and S same-geometry streams through one gang execution
    (`gang_compress`, `negotiate_gang`).

Negotiation, handles, dispatchers and pipelines run on the card unless the
caller passes `device="cpu"` (a keyword the reference does not have).
`JobSpec.devices >= 1` and `Dispatcher(mesh=...)` count the devices visible
on that device's type (`core/device.py` `visible_devices`); the one refusal
whose text differs from the reference's is a mesh wider than that count,
which names the visible device count where the reference names an XLA flag.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bits, metrics
from repro_torch.core import entropy as entropy_stage
from repro_torch.core.algorithms import (
    PAPER_TABLE1,
    WIRE_CODEC_IDS,
    Codec,
    accepted_params,
    check_codec_params,
    codec_factory,
    codec_names,
    make_codec,
)
from repro_torch.core.calibration import calibrated_kwargs
from repro_torch.core.controller import (
    AdaptiveController,
    ModeledLink,
    ScriptedController,
    TierSpec,
    resolve_ladder,
)
from repro_torch.core.device import DeviceLike, resolve_device, visible_devices
from repro_torch.core.dictstore import (
    DictRegistry,
    TrainedDict,
    default_registry,
    parse_dict_ref,
    train_dict,
)
from repro_torch.core.energy import PROFILES, HardwareProfile, edge_energy_j
from repro_torch.core.pipeline import (
    CompressionPipeline,
    DecompressionPipeline,
    codec_align,
    dispatch_signature,
)
from repro_torch.core.strategies import (
    EngineConfig,
    ExecutionPlan,
    ExecutionStrategy,
    FleetPlan,
    GangPlan,
    SchedulingStrategy,
    StateStrategy,
    block_costs,
    plan_execution,
    plan_fleet,
    plan_gang,
    resolve_capacity,
    schedule_blocks,
)
from repro_torch.runtime.elastic import ElasticSession
from repro_torch.runtime.server import (
    ServerCore,
    ServerReport,
    SessionReport,
    SignatureStats,
    StreamSession,
)

__all__ = [
    "JobSpec",
    "Plan",
    "CodecCapability",
    "EntropyCapability",
    "IntegrityCapability",
    "DictCapability",
    "DictRegistry",
    "TrainedDict",
    "train_dict",
    "default_registry",
    "parse_dict_ref",
    "NegotiationError",
    "negotiate",
    "negotiate_gang",
    "capability",
    "capabilities",
    "open",
    "gang_compress",
    "AdaptiveController",
    "ModeledLink",
    "ScriptedController",
    "TierSpec",
    "StreamHandle",
    "Dispatcher",
    "JobReport",
    "CompressResult",
    "GangCompressResult",
    "RoundtripResult",
    "queueing_delay_s",
    "run_compress",
    "run_gang_compress",
    "run_roundtrip",
    "ExecutionStrategy",
    "StateStrategy",
    "SchedulingStrategy",
    "SessionReport",
    "ServerReport",
    "SignatureStats",
]

#: scalar parameter types a JobSpec may carry (hashable, JSON-serializable)
_SCALAR = (bool, int, float, str)
_PaperNameByCodec = {v: k for k, v in PAPER_TABLE1.items()}


class NegotiationError(ValueError):
    """A JobSpec the API refuses; the message is one line and names the fix."""


def _err(msg: str) -> "NegotiationError":
    return NegotiationError(" ".join(msg.split()))


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
    #: adaptive tier selection: the controller re-decides {bypass, cheap,
    #: heavy} per flush; `codec` names the CHEAP rung, bypass is raw32 and
    #: heavy is delta_leb128 + rANS. Requires egress; `entropy` stays None
    adaptive: bool = False
    #: gang dispatch: the job's flushes may share one launch of each kernel
    #: with same-signature sessions of a `Dispatcher(gang=True)`
    gang: bool = False
    #: arrival rate for the end-to-end latency model (paper §4.1)
    arrival_rate_tps: Optional[float] = None
    #: minimum device-mesh width this job's waves must shard over
    #: (0 = wherever the dispatcher runs; >1 requires gang=True and a
    #: Dispatcher(mesh=...) at least that wide — DESIGN.md §14)
    devices: int = 0
    #: trained per-topic dictionary: "topic" / "topic:latest" (the
    #: registry's pinned or newest version at negotiation) or "topic:v3";
    #: requires a dictionary-state codec (tdic32)
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

    # ------------------------------------------------------ EngineConfig bridge
    @classmethod
    def from_engine_config(
        cls, config: EngineConfig, sample: Optional[np.ndarray] = None
    ) -> "JobSpec":
        """An `EngineConfig` (+ optional calibration sample) as the
        equivalent resolved JobSpec."""
        spec = cls(
            codec=config.codec,
            params=_freeze_params(config.codec, config.codec_kwargs),
            lanes=config.lanes,
            micro_batch_bytes=config.micro_batch_bytes,
            # the legacy planner pinned eager execution to per-block dispatch
            # whatever scan_chunk said; the bridge keeps that instead of
            # raising negotiation's error
            scan_chunk=(
                0 if config.execution == ExecutionStrategy.EAGER
                else config.scan_chunk
            ),
            execution=config.execution,
            state=config.state,
            scheduling=config.scheduling,
            profile=config.profile,
        )
        if config.calibrate and sample is not None:
            spec = spec.calibrated(sample)
        return spec

    def engine_config(self) -> EngineConfig:
        """The equivalent legacy `EngineConfig` (params already resolved)."""
        return EngineConfig(
            codec=self.codec,
            codec_kwargs=self.codec_kwargs,
            execution=self.execution,
            micro_batch_bytes=self.micro_batch_bytes,
            lanes=self.lanes,
            state=self.state,
            scheduling=self.scheduling,
            profile=self.profile,
            calibrate=False,
            scan_chunk=self.scan_chunk,
        )

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


# --------------------------------------------------------------- capabilities --
@dataclasses.dataclass(frozen=True)
class CodecCapability:
    """What one registry codec declares it can do (negotiation input)."""

    name: str
    paper_name: Optional[str]  # paper Table 1 name (None for extensions)
    wire_id: Optional[int]  # frame-header id; None = no egress/wire support
    lossy: bool
    stateful: bool
    state_kind: str  # 'none' | 'value' | 'dictionary' | 'model'
    scope: str  # 'block' | 'stream' (decode locality)
    maskable: bool  # pad symbols may be dropped from the wire
    aligned: bool  # byte-aligned symbol output
    accepted_params: Tuple[str, ...]
    default_error_bound: Optional[float]  # at default params; None = unbounded
    #: stage-2 entropy coders this codec's frames compose with (every codec
    #: with a wire id)
    entropy: Tuple[str, ...] = ()
    #: frame integrity kinds this codec's frames compose with (every codec
    #: with a wire id)
    integrity: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class EntropyCapability:
    """The negotiated stage-2 entropy coder."""

    kind: str  # "rans"
    lanes: int  # interleaved decoder lanes per chunk
    prob_bits: int  # frequency-table denominator = 2**prob_bits
    chunk_bytes: int  # bytes per independently-decodable chunk


@dataclasses.dataclass(frozen=True)
class IntegrityCapability:
    """The negotiated frame-integrity protection."""

    kind: str  # "crc32c"
    sections: Tuple[str, ...]  # wire sections covered, in trailer order
    trailer_bytes: int  # fixed per-frame wire overhead


@dataclasses.dataclass(frozen=True)
class DictCapability:
    """The negotiated trained dictionary. All-scalar so it hashes with the
    Plan; the seed arrays live on the codec instance (and in the registry
    under `(topic, version)`)."""

    topic: str
    version: int  # the RESOLVED version
    idx_bits: int
    n_entries: int
    content_hash: str
    #: True when the spec tracked "topic"/"topic:latest"
    follow_latest: bool


#: (name, factory) -> capability; keyed on the factory object so a
#: re-registered codec never serves a stale record
_CAP_CACHE: Dict[Tuple[str, Any], CodecCapability] = {}


def capability(name: str) -> CodecCapability:
    """Capability record for one registry codec (negotiation reads these)."""
    if name not in codec_names():
        raise _err(f"unknown codec {name!r}; available: {', '.join(codec_names())}")
    key = (name, codec_factory(name))
    cached = _CAP_CACHE.get(key)
    if cached is not None:
        return cached
    inst = make_codec(name)
    meta = inst.meta
    wired = WIRE_CODEC_IDS.get(name) is not None
    cap = CodecCapability(
        name=name,
        paper_name=_PaperNameByCodec.get(name),
        wire_id=WIRE_CODEC_IDS.get(name),
        lossy=meta.lossy,
        stateful=meta.stateful,
        state_kind=meta.state_kind,
        scope=meta.scope,
        maskable=meta.maskable,
        aligned=meta.aligned,
        accepted_params=tuple(accepted_params(name)),
        default_error_bound=inst.error_bound(),
        entropy=("rans",) if wired else (),
        integrity=bits.INTEGRITY_KINDS if wired else (),
    )
    _CAP_CACHE[key] = cap
    return cap


def capabilities() -> Tuple[CodecCapability, ...]:
    """All registry codecs' capabilities, in deterministic (sorted) order."""
    return tuple(capability(n) for n in codec_names())


# ---------------------------------------------------------------------- Plan --
@dataclasses.dataclass(frozen=True)
class Plan:
    """A negotiated, executable plan for one JobSpec: the policy layer's
    `ExecutionPlan` and `GangPlan`, the codec instance (resolved params,
    seeded when the spec names a dictionary), session flush capacity,
    per-lane alignment and the gang dispatch signature."""

    spec: JobSpec
    codec: Codec
    cap: CodecCapability
    execution: ExecutionPlan
    gang: GangPlan
    align: int  # per-lane tuple alignment the codec requires
    capacity: int  # session flush capacity in tuples (unit-rounded)
    signature: Tuple[Any, ...]  # gang dispatch signature (codec+params+geometry)
    notes: Tuple[str, ...] = ()  # non-fatal negotiation outcomes
    #: fleet wave sizing when the spec asked for a device mesh (devices >= 1)
    fleet: Optional[FleetPlan] = None
    #: resolved stage-2 entropy coder (spec.entropy="rans"); None = off
    entropy: Optional[EntropyCapability] = None
    #: adaptive tier ladder (spec.adaptive=True): one (TierSpec, Plan) per
    #: rung, each negotiated on its own with the same flush capacity
    tiers: Optional[Tuple[Tuple[TierSpec, "Plan"], ...]] = None
    #: resolved trained dictionary (spec.dictionary set); the codec
    #: instance is already seeded with it
    dictionary: Optional[DictCapability] = None
    #: resolved frame-integrity protection (spec.integrity="crc32c")
    integrity: Optional[IntegrityCapability] = None
    #: where the job's pipelines run (the port's `device` keyword)
    device: Optional[torch.device] = None

    @property
    def block_tuples(self) -> int:
        return self.execution.block_tuples


def negotiate(
    spec: JobSpec, registry: Optional[DictRegistry] = None, device: DeviceLike = None
) -> Plan:
    """Validate a JobSpec against the codec registry's capabilities and
    resolve it to an executable Plan for `device` (CUDA when None, or
    raise).

    `registry` overrides the process default dictstore registry for
    `spec.dictionary` resolution. Every rejected combination raises the
    reference's single-line `NegotiationError`; `devices` beyond the
    devices visible on `device`'s type names that count instead of the
    reference's XLA flag."""
    dev = resolve_device(device)
    names = codec_names()
    if spec.codec not in names:
        raise _err(f"unknown codec {spec.codec!r}; available: {', '.join(names)}")
    try:
        check_codec_params(spec.codec, spec.codec_kwargs)
    except ValueError as exc:
        raise _err(str(exc)) from exc
    if spec.profile not in PROFILES:
        raise _err(
            f"unknown hardware profile {spec.profile!r}; "
            f"available: {', '.join(sorted(PROFILES))}"
        )
    if spec.execution == ExecutionStrategy.EAGER and spec.scan_chunk > 1:
        raise _err(
            f"eager execution dispatches per block; scan_chunk={spec.scan_chunk} "
            "cannot apply — use execution='lazy' or scan_chunk<=1"
        )
    try:
        codec = make_codec(spec.codec, **spec.codec_kwargs)
    except (ValueError, TypeError, AssertionError) as exc:
        raise _err(
            f"codec {spec.codec!r} rejected params {spec.codec_kwargs}: {exc}"
        ) from exc
    cap = capability(spec.codec)

    notes: List[str] = []
    if spec.strict_masking and not cap.maskable:
        maskables = [c.name for c in capabilities() if c.maskable]
        raise _err(
            f"codec {spec.codec!r} is not maskable (its decoder replays state "
            "from the symbols themselves, so pad symbols must travel on the "
            f"wire); drop strict_masking or pick one of: {', '.join(maskables)}"
        )
    if spec.egress and cap.wire_id is None:
        wired = [c.name for c in capabilities() if c.wire_id is not None]
        raise _err(
            f"codec {spec.codec!r} has no wire-format id, so egress frames "
            f"cannot be built; drop egress or pick one of: {', '.join(wired)}"
        )
    if spec.entropy is not None and not spec.egress:
        raise _err(
            f"JobSpec.entropy={spec.entropy!r} codes the serialized wire "
            "sections, which only exist on egress frames; set egress=True "
            "or drop entropy"
        )
    if spec.entropy is not None and spec.entropy not in cap.entropy:
        raise _err(
            f"codec {spec.codec!r} offers no {spec.entropy!r} entropy stage "
            f"(its frames have no wire sections to code); drop entropy"
        )
    if spec.integrity is not None and not spec.egress:
        raise _err(
            f"JobSpec.integrity={spec.integrity!r} protects serialized wire "
            "sections, which only exist on egress frames; set egress=True "
            "or drop integrity"
        )
    if spec.integrity is not None and spec.integrity not in cap.integrity:
        raise _err(
            f"codec {spec.codec!r} offers no {spec.integrity!r} frame "
            "integrity (its frames have no wire sections to protect); "
            "drop integrity"
        )
    if spec.max_abs_error is not None:
        bound = codec.error_bound()
        if bound is None:
            raise _err(
                f"codec {spec.codec!r} has no hard error bound (fidelity is "
                "measured, not guaranteed); drop max_abs_error or pick a "
                "bounded codec (lossless, or pla/uanuq/leb128_nuq)"
            )
        if bound > spec.max_abs_error:
            raise _err(
                f"codec {spec.codec!r} guarantees max-abs error {bound:.6g} > "
                f"budget {spec.max_abs_error:.6g}; raise the budget or tighten "
                "the quantizer (more qbits / smaller eps)"
            )
    if spec.state == StateStrategy.SHARED and cap.state_kind != "dictionary":
        notes.append(
            f"shared state is a no-op for {spec.codec!r} (state_kind="
            f"{cap.state_kind!r}); only dictionary codecs merge tables"
        )
    if spec.devices > 1 and not spec.gang:
        raise _err(
            f"JobSpec.devices={spec.devices} shards gang waves over a device "
            "mesh, but gang=False keeps every flush a solo device-local "
            "dispatch; set gang=True (and open on a Dispatcher(mesh=...))"
        )
    if spec.devices >= 1:
        avail = len(visible_devices(dev))
        if spec.devices > avail:
            raise _err(
                f"JobSpec.devices={spec.devices} exceeds the {avail} visible "
                f"device(s) of type {dev.type}; open it on a Dispatcher(gang="
                "True, mesh=ElasticSession(..., devices=[...])) that names "
                "its slots (or shrink devices)"
            )

    dict_cap: Optional[DictCapability] = None
    if spec.dictionary is not None:
        if cap.state_kind != "dictionary":
            dict_codecs = [
                c.name for c in capabilities() if c.state_kind == "dictionary"
            ]
            raise _err(
                f"codec {spec.codec!r} takes no trained dictionary (state_kind="
                f"{cap.state_kind!r}); drop JobSpec.dictionary or pick one of: "
                f"{', '.join(dict_codecs)}"
            )
        topic, version = parse_dict_ref(spec.dictionary)
        try:
            trained = (registry or default_registry()).get(topic, version)
        except KeyError as exc:
            raise _err(
                f"JobSpec.dictionary={spec.dictionary!r}: {exc.args[0]}"
            ) from exc
        want_bits = spec.codec_kwargs.get("idx_bits")
        if want_bits is not None and int(want_bits) != trained.idx_bits:
            raise _err(
                f"JobSpec.dictionary={spec.dictionary!r} was trained with "
                f"idx_bits={trained.idx_bits} but params pin idx_bits="
                f"{want_bits}; retrain the dictionary or drop the param"
            )
        # rebuild with the dictionary's table size and seed the instance:
        # the seed arrays ride vars(codec) into the dispatch signature
        codec = _seeded_codec(spec, trained)
        dict_cap = DictCapability(
            topic=trained.topic,
            version=trained.version,
            idx_bits=trained.idx_bits,
            n_entries=trained.n_entries,
            content_hash=trained.content_hash,
            follow_latest=version is None,
        )

    align = codec_align(codec)
    exec_plan = plan_execution(spec, codec_align=align)
    capacity = resolve_capacity(
        exec_plan.block_tuples, spec.lanes, align, spec.flush_tuples
    )
    gang_plan = plan_gang(
        exec_plan, spec.hardware(), flush_timeout_s=spec.flush_timeout_s
    )
    try:
        signature = dispatch_signature(
            codec, spec.lanes, capacity // spec.lanes,
            entropy=spec.entropy or "none",
            integrity=spec.integrity or "none",
        )
    except TypeError as exc:
        if spec.gang:
            raise _err(
                f"codec {spec.codec!r} cannot join a gang: {exc}"
            ) from exc
        signature = ("ungangable", spec.codec, id(codec))
        notes.append(f"gang disabled for {spec.codec!r}: {exc}")
    tiers = _negotiate_tiers(spec, capacity, dev) if spec.adaptive else None
    return Plan(
        spec=spec,
        codec=codec,
        cap=cap,
        execution=exec_plan,
        gang=gang_plan,
        align=align,
        capacity=capacity,
        signature=signature,
        notes=tuple(notes),
        fleet=plan_fleet(gang_plan, spec.devices) if spec.devices >= 1 else None,
        entropy=(
            EntropyCapability(
                kind="rans",
                lanes=entropy_stage.N_LANES,
                prob_bits=entropy_stage.PROB_BITS,
                chunk_bytes=entropy_stage.CHUNK_BYTES,
            )
            if spec.entropy == "rans"
            else None
        ),
        tiers=tiers,
        dictionary=dict_cap,
        integrity=(
            IntegrityCapability(
                kind=spec.integrity,
                sections=bits._CRC_SECTIONS,
                trailer_bytes=4 * bits._CRC_TRAILER_WORDS,
            )
            if spec.integrity is not None
            else None
        ),
        device=dev,
    )


def _seeded_codec(spec: JobSpec, trained: TrainedDict) -> Codec:
    """The spec's codec at the dictionary's table size, seeded with it."""
    return make_codec(
        spec.codec, **{**spec.codec_kwargs, "idx_bits": trained.idx_bits}
    ).seed_dictionary(trained)


def _negotiate_tiers(
    spec: JobSpec, capacity: int, device: torch.device
) -> Tuple[Tuple[TierSpec, Plan], ...]:
    """Resolve and negotiate the adaptive tier ladder (spec.adaptive=True).

    The spec's codec is the CHEAP rung; bypass is raw32 and heavy is
    delta_leb128 + rANS (`core.controller.resolve_ladder` validates every
    rung: lossless, wire id). Each rung negotiates as its own non-adaptive
    spec, and every rung must resolve the SAME flush capacity: tier switches
    land at flush boundaries, so the batch geometry cannot move with the
    rung."""
    if not spec.egress:
        raise _err(
            "JobSpec.adaptive=True switches wire codecs at flush boundaries, "
            "which needs self-describing egress frames; set egress=True"
        )
    if spec.entropy is not None:
        raise _err(
            f"JobSpec.adaptive=True owns the entropy stage (the heavy tier "
            f"applies rans per flush); drop entropy={spec.entropy!r}"
        )
    if spec.devices >= 1:
        raise _err(
            f"JobSpec.adaptive=True cannot shard over a device mesh yet "
            f"(fleet wave replay assumes a stable dispatch signature); drop "
            f"devices={spec.devices}"
        )
    try:
        ladder = resolve_ladder(cheap=spec.codec)
    except ValueError as exc:
        raise _err(f"adaptive ladder: {exc}") from exc
    out: List[Tuple[TierSpec, Plan]] = []
    for tier in ladder:
        tier_spec = spec.replace(
            codec=tier.codec,
            params=(spec.params if tier.codec == spec.codec else tier.kwargs_dict),
            entropy=(tier.entropy if tier.entropy != "none" else None),
            adaptive=False,
        )
        tier_plan = negotiate(tier_spec, device=device)
        if tier_plan.capacity != capacity:
            raise _err(
                f"adaptive tier {tier.name!r} ({tier.codec!r}) resolves flush "
                f"capacity {tier_plan.capacity} != the session's {capacity}; "
                "set JobSpec.flush_tuples to a common multiple of every "
                "tier's block alignment"
            )
        out.append((tier, tier_plan))
    return tuple(out)


def negotiate_gang(specs: Sequence[JobSpec], device: DeviceLike = None) -> List[Plan]:
    """Negotiate a set of specs that must gang into ONE dispatch on
    `device` (CUDA when None, or raise).

    Members gang only when codec (including resolved parameters), block
    geometry and dtype agree — a mismatch is a NegotiationError naming the
    first divergent member, not a silent fall-back to solo dispatch."""
    if not specs:
        raise _err("negotiate_gang needs at least one JobSpec")
    plans = [negotiate(s if s.gang else s.replace(gang=True), device=device) for s in specs]
    ref = plans[0]
    for i, p in enumerate(plans[1:], start=1):
        if p.signature != ref.signature:
            raise _err(
                f"gang members disagree on dispatch signature: spec[0] "
                f"({ref.spec.codec!r}, params {ref.spec.codec_kwargs}, "
                f"capacity {ref.capacity}x{ref.spec.lanes} lanes) vs spec[{i}] "
                f"({p.spec.codec!r}, params {p.spec.codec_kwargs}, capacity "
                f"{p.capacity}x{p.spec.lanes} lanes); codec, resolved params, "
                "block geometry and dtype must all match"
            )
    return plans


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
class GangCompressResult:
    """Offline gang run over S same-config streams (DESIGN.md §11).

    `results` has one CompressResult per stream; `wall_s` is the SHARED
    gang wall (the streams moved through one sequence of launches, so
    per-stream `stats.wall_s` is the even split); `dispatches` counts the
    gang's chunk and tail dispatches — compare against S x the solo count."""

    results: List[CompressResult]
    n_streams: int
    wall_s: float
    dispatches: int
    makespan_s: float  # all streams' blocks scheduled together
    energy_j: float


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
    max_blocks: Optional[int] = None,
    breakdown: bool = False,
    emit_frame: bool = False,
    compact: bool = True,
) -> CompressResult:
    """One offline compression run: executor + schedule + latency layers.
    With `emit_frame` the egress takes the device compaction path;
    `compact=False` replays the legacy worst-case-buffer collection. With
    `breakdown` a per-block-dispatch plan is replayed fused to split the
    wall into running and blocked time (paper Fig 10b)."""
    shaped = pipe.shape_blocks(np.asarray(values, np.uint32), max_blocks=max_blocks)

    res = pipe.execute(shaped, collect_payload=emit_frame, compact=compact)
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
    if breakdown and pipe.plan.scan_chunk <= 1:
        # per-block-dispatch timed run: measure 'running' by force-fusing
        # the same blocks
        running = min(pipe.execute(shaped, fused=True).wall_s, wall)
    elif breakdown:
        running = wall  # the timed run already WAS the fused replay
    else:
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


def run_gang_compress(
    pipe: CompressionPipeline,
    spec: JobSpec,
    streams: Sequence[np.ndarray],
    emit_frames: bool = False,
    compact: bool = True,
) -> GangCompressResult:
    """Offline gang execution over S same-geometry streams (DESIGN.md §11):
    each chunk is one launch of each kernel for all S streams. Shared by
    `gang_compress` and the `CStreamEngine.gang_compress` shim."""
    if not streams:
        raise _err("gang compression needs at least one stream")
    shaped = [pipe.shape_blocks(np.asarray(v, np.uint32)) for v in streams]
    d0 = pipe.dispatches
    exec_results, wall = pipe.execute_gang(
        shaped, collect_payload=emit_frames, compact=compact
    )
    dispatches = pipe.dispatches - d0

    profile = spec.hardware()
    spin = spec.scheduling == SchedulingStrategy.UNIFORM
    all_costs: List[float] = []
    results: List[CompressResult] = []
    for sh, res in zip(shaped, exec_results):
        per_block_bits = res.per_block_bits
        total_bits = float(per_block_bits.sum())
        costs = block_costs(res.wall_s, per_block_bits)
        all_costs.extend(costs)
        _, busy, makespan = schedule_blocks(costs, profile.speeds, spec.scheduling)
        energy = edge_energy_j(profile, busy, makespan, spin_wait=spin)
        input_bytes = res.n_tuples * 4
        stats = metrics.RunStats(
            name=f"{pipe.codec.name}/gang/{spec.state.value}/{spec.scheduling.value}",
            input_bytes=input_bytes,
            output_bytes=total_bits / 8.0,
            wall_s=res.wall_s,
            ratio=metrics.compression_ratio(input_bytes * 8, total_bits),
            latency_s=None,
            energy_j=energy,
        )
        results.append(
            CompressResult(
                stats=stats,
                total_bits=total_bits,
                n_tuples=res.n_tuples,
                per_block_bits=per_block_bits,
                makespan_s=makespan,
                busy_s=busy,
                blocked_s=0.0,
                running_s=res.wall_s,
                frame=pipe.frame_from(sh, res) if emit_frames else None,
            )
        )
    _, gang_busy, gang_makespan = schedule_blocks(
        all_costs, profile.speeds, spec.scheduling
    )
    gang_energy = edge_energy_j(profile, gang_busy, gang_makespan, spin_wait=spin)
    return GangCompressResult(
        results=results,
        n_streams=len(streams),
        wall_s=wall,
        dispatches=dispatches,
        makespan_s=gang_makespan,
        energy_j=gang_energy,
    )


def run_roundtrip(
    pipe: CompressionPipeline,
    decomp: DecompressionPipeline,
    spec: JobSpec,
    values: np.ndarray,
    arrival_rate_tps: Optional[float] = None,
    max_blocks: Optional[int] = None,
) -> RoundtripResult:
    """Compress to the wire frame, decode it back, check fidelity: lossless
    codecs must come back bit-exact."""
    values = np.asarray(values, np.uint32).ravel()
    res = run_compress(
        pipe, spec, values,
        arrival_rate_tps=arrival_rate_tps, max_blocks=max_blocks, emit_frame=True,
    )
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


# ----------------------------------------------------------------- JobReport --
@dataclasses.dataclass
class JobReport:
    """What one StreamHandle produced, summed over its segments."""

    spec: JobSpec
    n_tuples: int
    total_bits: float
    ratio: float
    wall_s: float  # measured compression compute
    makespan_s: float  # modeled schedule over the hardware profile
    energy_j: float
    latency_s: Optional[float]
    n_frames: int
    #: egress jobs only: the WORST segment's fidelity (per-segment detail
    #: lives in `roundtrips`)
    fidelity: Optional[metrics.Fidelity] = None
    wire_bytes: Optional[int] = None
    segments: List[CompressResult] = dataclasses.field(default_factory=list)
    roundtrips: List[RoundtripResult] = dataclasses.field(default_factory=list)
    session: Optional[SessionReport] = None  # dispatcher-bound handles only


# -------------------------------------------------------------- StreamHandle --
class StreamHandle:
    """One stream driven through a negotiated plan: push/flush/frames/
    report/close — offline compression, a wire roundtrip, a server session
    or a gang-dispatched session.

    * Standalone (`cstream.open(spec)`): `push` buffers values; each `flush`
      compresses everything buffered as one independent segment (fresh
      codec state per segment). With `spec.egress` every segment also
      carries its wire frame and a decoded roundtrip fidelity check. With
      `spec.adaptive` the controller picks each segment's rung before it
      compresses, and the segment runs under that rung's own plan. The
      pipelines run on `device` (the plan's when None).
    * Dispatcher-bound (`Dispatcher.open(spec)`): `push(values, timestamps)`
      stages an arrival feed; `Dispatcher.run()` replays all handles' feeds
      in merged time order through the serving runtime (size-or-timeout
      flushes, optional cross-session gang dispatch). Codec state persists
      across flushes, as a session demands.
    """

    def __init__(
        self,
        spec: JobSpec,
        plan: Plan,
        session: Optional[StreamSession] = None,
        dispatcher: Optional["Dispatcher"] = None,
        controller: Any = None,
        device: DeviceLike = None,
    ):
        self.spec = spec
        self.plan = plan
        self._session = session
        self._dispatcher = dispatcher
        self._closed = False
        if session is not None:
            self.device = session.device
            self._staged_values: List[np.ndarray] = []
            self._staged_ts: List[np.ndarray] = []
            return
        self.device = resolve_device(device if device is not None else plan.device)
        self._buffer: List[np.ndarray] = []
        self._segments: List[CompressResult] = []
        self._roundtrips: List[RoundtripResult] = []
        self._decomp: Optional[DecompressionPipeline] = None
        self._controller = None
        if spec.adaptive:
            # each flush is an independent segment, so the controller
            # decides a rung per segment
            self._tier_plans: Dict[str, Tuple[TierSpec, Plan]] = {
                t.name: (t, p) for t, p in plan.tiers
            }
            self._controller = controller or AdaptiveController(
                ladder=tuple(t for t, _ in plan.tiers), profile=spec.profile
            )
            self._tier_pipes: Dict[str, CompressionPipeline] = {}
            self._tier_decomps: Dict[str, DecompressionPipeline] = {}
            self.tier_log: List[str] = []  # rung used per segment
            self._pipe = self._tier_pipe("cheap")
        else:
            self._pipe = self._pipeline(CompressionPipeline, plan)

    def _pipeline(self, cls, plan: Plan, codec: Optional[Codec] = None):
        return cls(plan.spec, codec=codec or plan.codec, plan=plan.execution, device=self.device)

    def _tier_pipe(self, name: str) -> CompressionPipeline:
        if name not in self._tier_pipes:
            self._tier_pipes[name] = self._pipeline(CompressionPipeline, self._tier_plans[name][1])
        return self._tier_pipes[name]

    def _tier_decompressor(self, name: str) -> DecompressionPipeline:
        if name not in self._tier_decomps:
            self._tier_decomps[name] = self._pipeline(
                DecompressionPipeline, self._tier_plans[name][1]
            )
        return self._tier_decomps[name]

    # ----------------------------------------------------------- dictionary
    def swap_dictionary(self, trained: TrainedDict) -> "StreamHandle":
        """Hot-swap to a newer trained dictionary at the next flush boundary.

        Dispatcher-bound handles seal the current segment and open the next
        flush under the new version (the registry's publish subscription
        calls this for "topic:latest" jobs); offline handles compress the
        following segments under the new seed. Decode needs no
        coordination: every frame declares the `(topic, version)` it was
        encoded under."""
        self._check_open()
        if self.plan.dictionary is None:
            raise _err(
                "this job negotiated no trained dictionary; set "
                "JobSpec.dictionary='topic[:vN|:latest]' and reopen"
            )
        if self._session is not None:
            self._session.swap_dictionary(trained)
            return self
        self._pipe = self._pipeline(
            CompressionPipeline, self.plan, codec=_seeded_codec(self.spec, trained)
        )
        self._decomp = None  # rebuilt lazily against the plan's codec
        return self

    # ------------------------------------------------------------- plumbing
    @property
    def topic(self) -> Optional[str]:
        return self._session.topic if self._session is not None else None

    @property
    def pipeline(self) -> CompressionPipeline:
        return self._pipe if self._session is None else self._session.pipeline

    @property
    def decompressor(self) -> DecompressionPipeline:
        """Lazily built egress executor sharing this handle's plan codec."""
        if self._session is not None:
            raise _err(
                "dispatcher-bound handles decode through the session's egress "
                "path; use frames()/report() instead"
            )
        if self._decomp is None:
            self._decomp = self._pipeline(DecompressionPipeline, self.plan)
        return self._decomp

    def _check_open(self) -> None:
        if self._closed:
            raise _err("StreamHandle is closed; open a new one from the spec")

    # ----------------------------------------------------------------- push
    def push(
        self, values: np.ndarray, timestamps: Optional[np.ndarray] = None
    ) -> "StreamHandle":
        """Feed tuples. Offline handles buffer them until `flush`;
        dispatcher-bound handles stage an (values, arrival-timestamps) feed
        that `Dispatcher.run()` replays in merged time order."""
        self._check_open()
        values = np.ascontiguousarray(values, np.uint32).ravel()
        if self._session is None:
            if timestamps is not None:
                raise _err(
                    "arrival timestamps only apply to dispatcher-bound "
                    "handles; open this spec via Dispatcher.open for a "
                    "timestamped session"
                )
            self._buffer.append(values)
            return self
        if timestamps is None:
            raise _err(
                f"session handle {self.topic!r} needs arrival timestamps: "
                "push(values, timestamps) — the serving runtime replays "
                "them for size-or-timeout flushing"
            )
        ts = np.asarray(timestamps, np.float64).ravel()
        if len(ts) != len(values):
            raise _err(
                f"session handle {self.topic!r}: {len(values)} values vs "
                f"{len(ts)} timestamps"
            )
        self._staged_values.append(values)
        self._staged_ts.append(ts)
        return self

    # ---------------------------------------------------------------- flush
    def flush(self) -> Optional[CompressResult]:
        """Offline: compress everything buffered as one segment and return
        its CompressResult (None if nothing is buffered). Dispatcher-bound:
        replay any staged feed now and drain the session's partial batch."""
        self._check_open()
        if self._session is not None:
            self._dispatcher.run()  # replay staged feeds (all handles)
            s = self._session
            deadline = s.flush_deadline
            if deadline is not None:
                s.flush(now=deadline)
            self._dispatcher._drain_gang()
            return None
        if not self._buffer:
            return None
        values = np.concatenate(self._buffer)
        self._buffer.clear()
        if self._controller is not None:
            # the rung is decided BEFORE compression, from previous
            # outcomes; the controller then observes the realized payload
            tier = self._controller.decide()
            rt = run_roundtrip(
                self._tier_pipe(tier.name),
                self._tier_decompressor(tier.name),
                self._tier_plans[tier.name][1].spec, values,
                arrival_rate_tps=self.spec.arrival_rate_tps,
            )
            self._controller.observe(
                tier.name, rt.compress.n_tuples, int(rt.compress.total_bits)
            )
            self.tier_log.append(tier.name)
            self._pipe = self._tier_pipes[tier.name]
            self._roundtrips.append(rt)
            self._segments.append(rt.compress)
            return rt.compress
        if self.spec.egress:
            rt = run_roundtrip(
                self.pipeline, self.decompressor, self.spec, values,
                arrival_rate_tps=self.spec.arrival_rate_tps,
            )
            self._roundtrips.append(rt)
            res = rt.compress
        else:
            res = run_compress(
                self.pipeline, self.spec, values,
                arrival_rate_tps=self.spec.arrival_rate_tps,
            )
        self._segments.append(res)
        return res

    # ---------------------------------------------------------------- frames
    def frames(self) -> List[bits.Frame]:
        """Wire-format frames this handle produced (egress specs only): one
        per offline segment, or the session's sealed tier/dictionary
        segments plus its closing frame. Readable after `close`."""
        if not self.spec.egress:
            return []
        if self._session is None:
            return [rt.compress.frame for rt in self._roundtrips]
        if not self._session.flushes:
            return []
        return self._session.egress_frames()

    # ---------------------------------------------------------------- report
    def report(self) -> JobReport:
        """Aggregate job metrics; egress jobs carry the fidelity contract,
        dispatcher-bound jobs embed their SessionReport."""
        if self._session is not None:
            server_rep = self._dispatcher.report()
            sess = server_rep.sessions[self._session.topic]
            return JobReport(
                spec=self.spec,
                n_tuples=sess.n_tuples,
                total_bits=sess.output_bytes * 8.0,
                ratio=sess.ratio,
                wall_s=sess.compute_s,
                makespan_s=server_rep.makespan_s,
                energy_j=sess.energy_j,
                latency_s=sess.mean_latency_s,
                n_frames=self._session.n_segments if self.spec.egress else 0,
                fidelity=sess.fidelity,
                wire_bytes=sess.wire_bytes,
                session=sess,
            )
        segs = self._segments
        n_tuples = sum(r.n_tuples for r in segs)
        total_bits = sum(r.total_bits for r in segs)
        # the aggregate carries the WORST segment's fidelity: a violated
        # bound in any flush must surface even if later segments were clean
        fid = (
            min(
                (rt.fidelity for rt in self._roundtrips),
                key=lambda f: (f.within_bound, -f.max_abs, -f.nrmse),
            )
            if self._roundtrips
            else None
        )
        wire = sum(rt.wire_bytes for rt in self._roundtrips) if self._roundtrips else None
        latencies = [r.stats.latency_s for r in segs if r.stats.latency_s is not None]
        return JobReport(
            spec=self.spec,
            n_tuples=n_tuples,
            total_bits=total_bits,
            ratio=metrics.compression_ratio(n_tuples * 32, total_bits),
            wall_s=sum(r.stats.wall_s for r in segs),
            makespan_s=sum(r.makespan_s for r in segs),
            energy_j=sum(r.stats.energy_j or 0.0 for r in segs),
            latency_s=max(latencies) if latencies else None,
            n_frames=len(self._roundtrips),
            fidelity=fid,
            wire_bytes=wire,
            segments=list(segs),
            roundtrips=list(self._roundtrips),
        )

    # ----------------------------------------------------------------- close
    def close(self) -> JobReport:
        """Flush anything pending, return the final report, seal the handle."""
        if self._closed:
            raise _err("StreamHandle is already closed")
        pending = (
            bool(self._buffer) if self._session is None
            else bool(self._staged_values) or bool(self._session.buffered)
        )
        if pending:
            self.flush()
        rep = self.report()
        self._closed = True
        return rep

    def __enter__(self) -> "StreamHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._closed and exc_type is None:
            self.close()

    # dispatcher plumbing ----------------------------------------------------
    def _take_staged(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self._session is None or not self._staged_values:
            return None
        feed = (np.concatenate(self._staged_values), np.concatenate(self._staged_ts))
        self._staged_values.clear()
        self._staged_ts.clear()
        return feed


# --------------------------------------------------------------------- open --
def open(
    spec: JobSpec,
    sample: Optional[np.ndarray] = None,
    dispatcher: Optional["Dispatcher"] = None,
    topic: Optional[str] = None,
    controller: Any = None,
    device: DeviceLike = None,
) -> StreamHandle:
    """Negotiate a JobSpec and open the StreamHandle that drives it on
    `device` (CUDA when None, or raise).

    `sample` bakes calibration into the spec first (`JobSpec.calibrated`).
    With `dispatcher` the handle is a server session on that dispatcher,
    on the dispatcher's device — sugar for `dispatcher.open(spec, topic,
    sample)`. `controller` overrides the adaptive tier controller
    (spec.adaptive=True only; default is an `AdaptiveController` over the
    negotiated ladder)."""
    if dispatcher is not None:
        return dispatcher.open(spec, topic=topic, sample=sample, controller=controller)
    if sample is not None:
        spec = spec.calibrated(sample)
    plan = negotiate(spec, device=device)
    if spec.gang:
        raise _err(
            "spec.gang=True needs a shared dispatcher: use "
            "Dispatcher(gang=True).open(spec) (or gang_compress for offline "
            "same-geometry streams)"
        )
    if controller is not None and not spec.adaptive:
        raise _err(
            "a tier controller only applies to adaptive jobs; set "
            "JobSpec.adaptive=True (or drop controller)"
        )
    return StreamHandle(spec, plan, controller=controller)


def gang_compress(
    spec: JobSpec,
    streams: Sequence[np.ndarray],
    sample: Optional[np.ndarray] = None,
    emit_frames: bool = False,
    device: DeviceLike = None,
) -> GangCompressResult:
    """Offline gang: S same-geometry streams through one launch of each
    kernel per chunk on `device` (CUDA when None, or raise), bit-identical
    to solo runs (frames/records)."""
    if sample is not None:
        spec = spec.calibrated(sample)
    plan = negotiate(spec.replace(gang=True), device=device)
    pipe = CompressionPipeline(
        plan.spec, codec=plan.codec, plan=plan.execution, device=plan.device
    )
    return run_gang_compress(pipe, plan.spec, streams, emit_frames=emit_frames)


# --------------------------------------------------------------- Dispatcher --
class Dispatcher:
    """Shared serving runtime behind dispatcher-bound StreamHandles.

    Wraps the multi-stream server core (runtime/server.py): admission cap,
    size-or-timeout flushing over merged arrival order, worker scheduling
    over the hardware profile, and — with `gang=True` — the cross-session
    gang dispatcher (DESIGN.md §11) that folds same-signature flushes into
    one launch of each kernel. `StreamServer` is the deprecated shim over
    the same core. Sessions run on `device` (CUDA when None, or raise).

    Flush policy is per-JOB: `open(spec)` applies the spec's
    `flush_tuples`/`flush_timeout_s` to its session; the constructor's
    `flush_timeout_s` is only the core default for legacy `admit` paths.

    `fault_injector`/`heartbeat` wire the chaos-drill and liveness hooks
    through to the server core, and `breaker` (True, or CircuitBreaker
    kwargs) turns on per-signature admission breakers (DESIGN.md §18).

    `mesh=N` (requires `gang=True`) shards every gang wave over the first N
    devices visible on `device`'s type, as a pure-data device mesh
    (DESIGN.md §14); `mesh=ElasticSession(N, profile="cstream",
    devices=[...])` names each slot's device (a device may fill several
    slots). One wave covers N x max_gang sessions, one launch of each
    kernel per shard, and a device loss mid-wave re-meshes onto the
    survivors and replays the wave from its members' last committed
    FlushRecords."""

    def __init__(
        self,
        profile: str = "rk3399_amp",
        scheduling: SchedulingStrategy = SchedulingStrategy.ASYMMETRIC,
        max_sessions: int = 16,
        flush_timeout_s: float = 0.25,
        gang: bool = False,
        gang_quantum_s: Optional[float] = None,
        max_gang: Optional[int] = None,
        gang_budget: Optional[int] = None,
        mesh: Union[None, int, ElasticSession] = None,
        fault_injector: Any = None,
        heartbeat: Any = None,
        breaker: Any = None,
        device: DeviceLike = None,
    ):
        if profile not in PROFILES:
            raise _err(
                f"unknown hardware profile {profile!r}; "
                f"available: {', '.join(sorted(PROFILES))}"
            )
        try:
            self._core = ServerCore(
                profile=profile,
                scheduling=SchedulingStrategy(scheduling),
                max_sessions=max_sessions,
                flush_timeout_s=flush_timeout_s,
                gang=gang,
                gang_quantum_s=gang_quantum_s,
                max_gang=max_gang,
                gang_budget=gang_budget,
                mesh=mesh,
                fault_injector=fault_injector,
                heartbeat=heartbeat,
                breaker=breaker,
                device=device,
            )
        except NegotiationError:
            raise
        except ValueError as exc:  # core mesh validation -> negotiation error
            raise _err(str(exc)) from exc
        self._handles: Dict[str, StreamHandle] = {}
        #: live "topic:latest" registry subscriptions; dropped on close
        self._subscriptions: List[Tuple[DictRegistry, str, Any]] = []

    @property
    def device(self) -> torch.device:
        return self._core.device

    @property
    def gang(self) -> bool:
        return self._core.gang

    @property
    def devices(self) -> int:
        """Current fleet mesh width (1 = device-local dispatch; shrinks
        when a device loss re-meshes onto the survivors)."""
        fleet = self._core.fleet
        return fleet.n_devices if fleet is not None else 1

    @property
    def sessions(self) -> Dict[str, StreamSession]:
        return self._core.sessions

    # ----------------------------------------------------------------- open
    def open(
        self,
        spec: JobSpec,
        topic: Optional[str] = None,
        sample: Optional[np.ndarray] = None,
        controller: Any = None,
    ) -> StreamHandle:
        """Admit a session for this spec and return its StreamHandle.
        `controller` overrides the adaptive tier controller (adaptive
        specs only)."""
        if sample is not None:
            spec = spec.calibrated(sample)
        return self._open_negotiated(
            spec, negotiate(spec, device=self.device), topic, controller
        )

    def open_many(
        self,
        spec: JobSpec,
        count: Optional[int] = None,
        topics: Optional[Sequence[str]] = None,
        sample: Optional[np.ndarray] = None,
    ) -> List[StreamHandle]:
        """Admit many same-spec sessions with ONE negotiation; they share
        the signature owner's pipeline (codec state stays per-session).
        Pass `count` for auto-named topics or an explicit `topics` list
        (exactly one of the two)."""
        if (count is None) == (topics is None):
            raise _err(
                "open_many needs exactly one of count= (auto-named topics) "
                "or topics= (explicit names)"
            )
        if topics is None:
            if count < 1:
                raise _err(f"open_many count must be >= 1, got {count}")
            names: List[str] = []
            n = len(self._core.sessions)
            while len(names) < count:
                candidate = f"job-{n}"
                n += 1
                if candidate not in self._core.sessions:
                    names.append(candidate)
            topics = names
        if sample is not None:
            spec = spec.calibrated(sample)
        plan = negotiate(spec, device=self.device)
        return [self._open_negotiated(spec, plan, t) for t in topics]

    def _open_negotiated(
        self,
        spec: JobSpec,
        plan: Plan,
        topic: Optional[str],
        controller: Any = None,
    ) -> StreamHandle:
        if controller is not None and not spec.adaptive:
            raise _err(
                "a tier controller only applies to adaptive jobs; set "
                "JobSpec.adaptive=True (or drop controller)"
            )
        if spec.gang and not self._core.gang:
            raise _err(
                "spec.gang=True but this dispatcher was built with gang=False; "
                "construct Dispatcher(gang=True) to gang-dispatch sessions"
            )
        if spec.devices > self.devices:
            raise _err(
                f"JobSpec.devices={spec.devices} but this dispatcher runs a "
                f"{self.devices}-device mesh; construct "
                f"Dispatcher(gang=True, mesh={spec.devices}) (or lower "
                "spec.devices)"
            )
        if topic is None:
            n = len(self._core.sessions)
            topic = f"job-{n}"
            while topic in self._core.sessions:  # user-supplied names may clash
                n += 1
                topic = f"job-{n}"
        admit_spec, admit_codec, admit_plan = spec, plan.codec, plan.execution
        tiers = active_tier = None
        if spec.adaptive:
            # the controller picks the starting rung; the session admits ON
            # that rung's negotiated plan, carrying the whole ladder for
            # flush-boundary switches (runtime/server.py, DESIGN.md §16)
            if controller is None:
                controller = AdaptiveController(
                    ladder=tuple(t for t, _ in plan.tiers), profile=spec.profile
                )
            by_name = {t.name: p for t, p in plan.tiers}
            active_tier = controller.decide().name
            start = by_name[active_tier]
            admit_spec, admit_codec, admit_plan = start.spec, start.codec, start.execution
            tiers = {name: (p.spec, p.codec, p.execution) for name, p in by_name.items()}
        session = self._core.admit(
            topic,
            admit_spec,
            flush_tuples=spec.flush_tuples,
            flush_timeout_s=spec.flush_timeout_s,
            egress=spec.egress,
            codec=admit_codec,
            plan=admit_plan,
            controller=controller if spec.adaptive else None,
            tiers=tiers,
            active_tier=active_tier,
        )
        handle = StreamHandle(spec, plan, session=session, dispatcher=self)
        if plan.dictionary is not None and plan.dictionary.follow_latest:
            # "topic:latest" jobs track the registry: a publish hot-swaps the
            # session at its next flush boundary (sealed segment + new seed)
            reg = default_registry()
            dict_topic = plan.dictionary.topic

            def _on_publish(trained: TrainedDict, _s: StreamSession = session) -> None:
                _s.swap_dictionary(trained)

            reg.subscribe(dict_topic, _on_publish)
            self._subscriptions.append((reg, dict_topic, _on_publish))
        self._handles[topic] = handle
        return handle

    def open_gang(
        self,
        specs: Sequence[JobSpec],
        topics: Optional[Sequence[str]] = None,
        samples: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[StreamHandle]:
        """Open a set of sessions that MUST share one gang signature
        (`negotiate_gang` rejects mismatches with an actionable error)."""
        if not self._core.gang:
            raise _err("open_gang needs Dispatcher(gang=True)")
        if topics is not None and len(topics) != len(specs):
            raise _err(
                f"open_gang got {len(specs)} specs but {len(topics)} topics; "
                "pass one topic per spec (or none)"
            )
        if samples is not None:
            if len(samples) != len(specs):
                raise _err(
                    f"open_gang got {len(specs)} specs but {len(samples)} "
                    "samples; pass one sample per spec (or none)"
                )
            specs = [
                s if smp is None else s.calibrated(smp)
                for s, smp in zip(specs, samples)
            ]
        # one negotiation per member: signature agreement or a single-line
        # error, and the same Plans drive admission (no re-negotiation)
        plans = negotiate_gang([s.replace(gang=True) for s in specs], device=self.device)
        topic_list = list(topics) if topics is not None else [None] * len(plans)
        return [
            self._open_negotiated(p.spec, p, t) for p, t in zip(plans, topic_list)
        ]

    # ------------------------------------------------------------------ run
    def run(self) -> Optional[ServerReport]:
        """Replay every handle's staged feed in merged arrival order through
        the serving runtime; returns the ServerReport (None if nothing was
        staged). Identical semantics to `StreamServer.run(feeds)`."""
        feeds: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for topic, h in self._handles.items():
            staged = h._take_staged()
            if staged is not None:
                feeds[topic] = staged
        if not feeds:
            return None
        return self._core.run(feeds)

    def report(self) -> ServerReport:
        """Schedule-layer report over all sessions (makespan/energy/ratio)."""
        return self._core.report()

    def _drain_gang(self) -> None:
        if self._core.gang:
            self._core._dispatch_all()

    def close(self) -> ServerReport:
        """Run any staged feeds, drain every session, and report."""
        self.run()
        for s in self._core.sessions.values():
            deadline = s.flush_deadline
            if deadline is not None:
                s.flush(now=deadline)
        self._drain_gang()
        for reg, dict_topic, fn in self._subscriptions:
            reg.unsubscribe(dict_topic, fn)
        self._subscriptions.clear()
        return self.report()

    def __enter__(self) -> "Dispatcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()

    def __iter__(self) -> Iterator[StreamHandle]:
        return iter(self._handles.values())


# ------------------------------------------------------------- deprecation --
def warn_deprecated_shim(old: str, new: str) -> None:
    """One warning per call site for the legacy surface (DESIGN.md §12:
    shims stay bit-identical for two release cycles, then go)."""
    warnings.warn(
        f"{old} is deprecated; use {new} (repro_torch.cstream) instead — "
        "see DESIGN.md §12 for the migration table",
        DeprecationWarning,
        stacklevel=3,
    )
