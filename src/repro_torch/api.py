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
    independent segments, with `swap_dictionary` and the adaptive ladder.
  * `run_compress` / `run_roundtrip` — one offline compression run, and
    compress -> frame -> decompress with the fidelity check.

Negotiation, handles and pipelines run on the card unless the caller passes
`device="cpu"` (a keyword the reference does not have). Not here yet, and
refused naming their ROADMAP item: dispatcher-bound handles, `Dispatcher`,
`negotiate_gang` and `gang_compress` (A6), and device meshes,
`JobSpec.devices >= 1` (A9, the one refusal whose text differs from the
reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

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
from repro_torch.core.device import resolve_device
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
    plan_gang,
    resolve_capacity,
    schedule_blocks,
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
    "capability",
    "capabilities",
    "open",
    "AdaptiveController",
    "ModeledLink",
    "ScriptedController",
    "TierSpec",
    "StreamHandle",
    "JobReport",
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
_PaperNameByCodec = {v: k for k, v in PAPER_TABLE1.items()}
DeviceLike = Union[None, str, torch.device]


class NegotiationError(ValueError):
    """A JobSpec the API refuses; the message is one line and names the fix."""


def _err(msg: str) -> "NegotiationError":
    return NegotiationError(" ".join(msg.split()))


def _not_here(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}, which repro_torch does not have yet (ROADMAP {item}); "
        "run this job on repro"
    )


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
    #: gang dispatch (ROADMAP A6: negotiated as a plan, refused to run)
    gang: bool = False
    #: arrival rate for the end-to-end latency model (paper §4.1)
    arrival_rate_tps: Optional[float] = None
    #: device-mesh width (ROADMAP A9; > 0 refused by the port's pipelines)
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
    #: fleet wave sizing for a device mesh; always None here, since
    #: `devices >= 1` is refused (ROADMAP A9)
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
    reference's single-line `NegotiationError`, except `devices >= 1`,
    which names ROADMAP A9."""
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
        # the reference checks the visible device count here; the port has
        # no device mesh to shard over yet
        raise _err(
            f"JobSpec.devices={spec.devices} shards gang waves over a device "
            "mesh, which repro_torch does not have yet (ROADMAP A9); drop "
            "devices or run this job on repro"
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


# -------------------------------------------------------------- StreamHandle --
class StreamHandle:
    """One stream driven through a negotiated plan: push/flush/frames/
    report/close (the reference's offline handle; dispatcher-bound handles
    wait for ROADMAP A6).

    `push` buffers values; each `flush` compresses everything buffered as
    one independent segment (fresh codec state per segment). With
    `spec.egress` every segment also carries its wire frame and a decoded
    roundtrip fidelity check. With `spec.adaptive` the controller picks each
    segment's rung before it compresses, and the segment runs under that
    rung's own plan. The pipelines run on `device` (the plan's when None)."""

    def __init__(
        self,
        spec: JobSpec,
        plan: Plan,
        controller: Any = None,
        device: DeviceLike = None,
    ):
        self.spec = spec
        self.plan = plan
        self.device = resolve_device(device if device is not None else plan.device)
        self._closed = False
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
        """Compress the following segments under a newer trained
        dictionary. Decode needs no coordination: every frame declares the
        `(topic, version)` it was encoded under."""
        self._check_open()
        if self.plan.dictionary is None:
            raise _err(
                "this job negotiated no trained dictionary; set "
                "JobSpec.dictionary='topic[:vN|:latest]' and reopen"
            )
        self._pipe = self._pipeline(
            CompressionPipeline, self.plan, codec=_seeded_codec(self.spec, trained)
        )
        self._decomp = None  # rebuilt lazily against the plan's codec
        return self

    # ------------------------------------------------------------- plumbing
    @property
    def pipeline(self) -> CompressionPipeline:
        return self._pipe

    @property
    def decompressor(self) -> DecompressionPipeline:
        """Lazily built egress executor sharing this handle's plan codec."""
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
        """Buffer tuples until `flush`. Arrival timestamps belong to
        dispatcher-bound handles (ROADMAP A6)."""
        self._check_open()
        if timestamps is not None:
            raise _err(
                "arrival timestamps only apply to dispatcher-bound handles, "
                "which repro_torch does not have yet (ROADMAP A6); push "
                "values alone"
            )
        self._buffer.append(np.ascontiguousarray(values, np.uint32).ravel())
        return self

    # ---------------------------------------------------------------- flush
    def flush(self) -> Optional[CompressResult]:
        """Compress everything buffered as one segment and return its
        CompressResult (None if nothing is buffered)."""
        self._check_open()
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
        """Wire-format frames this handle produced (egress specs only), one
        per segment. Readable after `close`."""
        if not self.spec.egress:
            return []
        return [rt.compress.frame for rt in self._roundtrips]

    # ---------------------------------------------------------------- report
    def report(self) -> JobReport:
        """Aggregate job metrics; egress jobs carry the fidelity contract."""
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
        if self._buffer:
            self.flush()
        rep = self.report()
        self._closed = True
        return rep

    def __enter__(self) -> "StreamHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._closed and exc_type is None:
            self.close()


# --------------------------------------------------------------------- open --
def open(
    spec: JobSpec,
    sample: Optional[np.ndarray] = None,
    dispatcher: Any = None,
    topic: Optional[str] = None,
    controller: Any = None,
    device: DeviceLike = None,
) -> StreamHandle:
    """Negotiate a JobSpec and open the StreamHandle that drives it on
    `device` (CUDA when None, or raise).

    `sample` bakes calibration into the spec first (`JobSpec.calibrated`).
    `controller` overrides the adaptive tier controller (spec.adaptive=True
    only; default is an `AdaptiveController` over the negotiated ladder).
    A `dispatcher` and `topic`, and a gang spec, need the serving runtime
    (ROADMAP A6)."""
    if dispatcher is not None or topic is not None:
        raise _not_here("open(dispatcher=...) binds a handle to a server session", "A6")
    if sample is not None:
        spec = spec.calibrated(sample)
    plan = negotiate(spec, device=device)
    if spec.gang:
        raise _not_here("spec.gang=True needs a shared gang dispatcher", "A6")
    if controller is not None and not spec.adaptive:
        raise _err(
            "a tier controller only applies to adaptive jobs; set "
            "JobSpec.adaptive=True (or drop controller)"
        )
    return StreamHandle(spec, plan, controller=controller)
