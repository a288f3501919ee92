"""Multi-stream serving runtime: StreamSession + StreamServer (port of
`repro/runtime/server.py`; DESIGN.md §3).

The session/server layer sits on top of the executor (core/pipeline.py) and
policy (core/strategies.py `plan_execution`) layers:

  * `StreamSession` — one per topic: private codec state that persists across
    micro-batches, plus an arrival-timestamp-driven accumulator. A batch is
    flushed when it reaches the planned micro-batch size OR when its oldest
    tuple has waited `flush_timeout_s` (the size-or-timeout batcher of edge
    telemetry collectors; bursty `zipf_timestamps` streams hit both paths).
    Partial (timeout) flushes are edge-padded and mask out pad slots, so the
    bitstream and the ratio/latency accounting stay exact.
  * `StreamServer` — admits up to `max_sessions` concurrent sessions and
    replays their merged arrival order. Flushed blocks carry measured
    compression costs; the server maps them onto the hardware profile's
    cores via `schedule_blocks` (worker schedule layer) and reports modeled
    makespan + energy next to per-session ratio / throughput / latency.

  * **Gang dispatcher** (`gang=True`, DESIGN.md §11) — sessions flushing
    within one scheduling quantum with the same (codec, block geometry,
    dtype) signature are folded into one state of S*L lanes and pushed
    through ONE launch of each kernel (`CompressionPipeline.gang_step`);
    per-session states, wire frames and flush records scatter back out
    bit-identical to solo runs. Per-signature queues buffer flush snapshots
    between quantum edges, and a queue that exceeds its admission budget
    dispatches immediately (backpressure).
  * **Fleet dispatcher** (`mesh=`, DESIGN.md §14) — gang waves shard over a
    pure ("data",) device mesh (`runtime/elastic.py`): a wave is padded to
    a multiple of the mesh width by replicating member 0, each mesh slot
    compresses its contiguous shard of whole members on its own device,
    and a device lost mid-wave re-meshes onto the survivors and replays the
    wave from its members' last committed FlushRecords.

Arrival replay is a simulation driven by `data/stream.py` timestamps — the
wall clock measures only compression compute, never the synthetic waiting;
every flush's wall ends after a device synchronize. Sessions run on
`torch.device("cuda")` unless the server or session is given `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bits, metrics
from repro_torch.core.algorithms import Codec
from repro_torch.core.device import DeviceLike, resolve_device, visible_devices
from repro_torch.core.energy import PROFILES, edge_energy_j
from repro_torch.core.pipeline import (
    CompressionPipeline,
    DecompressionPipeline,
    codec_align,
    dispatch_signature,
)
from repro_torch.core.strategies import (
    EngineConfig,  # noqa: F401  (re-exported for legacy callers)
    ExecutionPlan,
    FleetPlan,
    GangPlan,
    SchedulingStrategy,
    SpecLike,
    plan_fleet,
    plan_gang,
    resolve_capacity,
    schedule_blocks,
)
from repro_torch.runtime.fault import (
    CircuitBreaker,
    DeviceLoss,
    HeartbeatMonitor,
    with_backoff,
)
from repro_torch.runtime.elastic import ElasticSession


@dataclasses.dataclass
class FlushRecord:
    """One flushed micro-batch: what it cost and how long its tuples waited."""

    n_tuples: int
    bits: float
    cost_s: float  # measured compression wall time for this block
    mean_wait_s: float  # arrival -> flush wait, averaged over the batch
    max_wait_s: float
    timeout: bool  # flushed by timeout (partial) rather than by size

    def key(self) -> tuple:
        """Timing-independent identity: every field except the measured
        cost. Determinism and gang-equivalence tests compare these — two
        runs of the same feeds must produce identical keys, but wall-clock
        cost is measurement, not semantics."""
        return (
            self.n_tuples,
            self.bits,
            round(self.mean_wait_s, 12),
            round(self.max_wait_s, 12),
            self.timeout,
        )


@dataclasses.dataclass
class FlushRequest:
    """A flush snapshot awaiting compression (the gang dispatcher's unit).

    Everything the latency/ratio accounting needs is captured at snapshot
    time — padded values, pad mask, per-tuple waits stamped against the
    flush deadline — so WHEN the gang executes the compression changes
    nothing but the measured cost."""

    values: np.ndarray  # uint32[capacity], edge-padded past n
    mask: np.ndarray  # bool[capacity], True = real tuple
    n: int
    waits: np.ndarray  # float64[n], arrival -> flush-stamp waits
    timeout: bool


@dataclasses.dataclass
class SessionReport:
    topic: str
    codec: str
    n_tuples: int
    n_flushes: int
    n_timeout_flushes: int
    input_bytes: int
    output_bytes: float
    ratio: float
    compute_s: float  # sum of per-flush compression costs
    throughput_mbps: float  # input bytes over compute time
    mean_latency_s: float  # per-tuple wait + processing, flush-weighted
    p95_latency_s: float
    energy_j: float  # session's share of the scheduled profile energy
    # egress accounting (sessions created with egress=True only)
    fidelity: Optional[metrics.Fidelity] = None  # decoded-vs-fed contract check
    wire_bytes: Optional[int] = None  # serialized egress frame size
    decode_s: Optional[float] = None  # egress decode wall time
    # adaptive sessions (DESIGN.md §16) only
    tier_switches: int = 0  # tier changes applied at flush boundaries
    tier_history: Tuple[str, ...] = ()  # tier that compressed each flush
    # trained-dictionary sessions (DESIGN.md §17) only
    dict_swaps: int = 0  # dictionary versions hot-swapped at flush boundaries


@dataclasses.dataclass
class SignatureStats:
    """Per-signature dispatch accounting (gang/fleet waves, DESIGN.md §14).

    Lets benches attribute throughput: how many sessions rode each wave,
    how much of the sharded device grid carried real work (`occupancy` —
    pad replicas burned to fill mesh shards dilute it), and how often the
    dispatcher degenerated to solo launches."""

    codec: str
    lanes: int
    per_lane: int
    n_sessions: int = 0  # sessions admitted under this signature
    n_waves: int = 0  # multi-member (gang) dispatches
    n_solo: int = 0  # degenerate single-member dispatches
    sessions_dispatched: int = 0  # real wave members across all dispatches
    max_wave: int = 0  # largest wave observed
    padded_slots: int = 0  # pad replicas burned to fill mesh shards

    @property
    def label(self) -> str:
        return f"{self.codec}/{self.lanes}x{self.per_lane}"

    @property
    def mean_wave(self) -> float:
        n = self.n_waves + self.n_solo
        return self.sessions_dispatched / n if n else 0.0

    @property
    def occupancy(self) -> float:
        """Real members / dispatch slots (1.0 = every sharded slot did
        useful work; solo launches count as fully occupied)."""
        slots = self.sessions_dispatched + self.padded_slots
        return self.sessions_dispatched / slots if slots else 1.0


@dataclasses.dataclass
class ServerReport:
    sessions: Dict[str, SessionReport]
    n_sessions: int
    total_tuples: int
    total_input_bytes: int
    total_output_bytes: float
    ratio: float
    compute_s: float
    makespan_s: float  # modeled: flushes scheduled across the profile cores
    busy_s: List[float]
    energy_j: float
    aggregate_mbps: float  # input bytes over modeled makespan
    n_dispatches: int = 0  # kernel launches issued (gangs amortize these)
    # ---- fleet accounting (gang servers; devices > 1 = sharded waves) ----
    devices: int = 1  # current mesh width (shrinks after a device loss)
    #: per-signature dispatch breakdown keyed by `SignatureStats.label`
    dispatch_stats: Dict[str, SignatureStats] = dataclasses.field(
        default_factory=dict
    )
    #: device-loss recoveries this server survived ({wave, device, n_devices})
    fault_events: List[dict] = dataclasses.field(default_factory=list)
    #: modeled per-device busy time: each sharded wave's measured wall is
    #: charged at shard width (wall x shard/padded slots) — the fleet
    #: analogue of `makespan_s`'s modeled-profile convention, and exactly
    #: `compute_s` on a 1-device mesh
    device_makespan_s: float = 0.0
    fleet_mbps: float = 0.0  # input bytes over modeled device makespan
    #: per-signature circuit-breaker snapshots keyed by `SignatureStats.
    #: label` (breaker-enabled servers only; DESIGN.md §18)
    breakers: Dict[str, dict] = dataclasses.field(default_factory=dict)


class StreamSession:
    """Per-topic codec state + size-or-timeout micro-batch accumulator."""

    def __init__(
        self,
        topic: str,
        config: SpecLike,
        sample: Optional[np.ndarray] = None,
        flush_tuples: int = 0,
        flush_timeout_s: float = 0.25,
        egress: bool = False,
        codec: Optional[Codec] = None,
        plan: Optional[ExecutionPlan] = None,
        compact: bool = True,
        pipeline: Optional[CompressionPipeline] = None,
        controller: Any = None,
        tiers: Optional[Dict[str, tuple]] = None,
        active_tier: Optional[str] = None,
        device: DeviceLike = None,
    ):
        """`config` is any spec carrier with the EngineConfig attribute
        surface (EngineConfig or `repro_torch.cstream.JobSpec`); a pre-negotiated
        `codec`/`plan` (from `cstream.negotiate`) is consumed directly.
        `compact=True` (default) routes egress through the device-resident
        compaction path (DESIGN.md §13): flush dispatches hand back the
        exact live word prefix plus 7-bit-packed metadata, so per-session
        egress transfers shrink to wire size; `compact=False` keeps the
        legacy worst-case-buffer collection (the oracle baseline).

        `pipeline` shares a sibling session's pipeline instead of building
        one: safe whenever the dispatch signature matches (the gang
        dispatcher already runs every member through the signature owner's
        pipeline — sharing merely extends that to solo flushes), and one
        codec and plan serve 10k admitted sessions. Codec STATE stays
        per-session.

        `controller` + `tiers` make the session ADAPTIVE (DESIGN.md §16):
        `tiers` maps rung name -> (config, codec, plan) for each negotiated
        tier; after every committed flush the controller observes the
        outcome and decides the next flush's rung. Switches land only at
        flush boundaries — the active segment seals into its own
        self-describing frame, the new tier starts with fresh codec state,
        and the dispatch signature re-registers with the server so gang
        waves regroup. Every rung must share the session's flush capacity
        (negotiation enforces it; asserted here).

        `device` places the session's pipelines (CUDA when None, or raise);
        a shared `pipeline` brings its own."""
        self.topic = topic
        self.config = config
        self.pipeline = (
            pipeline
            if pipeline is not None
            else CompressionPipeline(
                config, sample=sample, codec=codec, plan=plan, device=device
            )
        )
        self.device = self.pipeline.device
        self.capacity = resolve_capacity(
            self.pipeline.plan.block_tuples,
            config.lanes,
            self.pipeline.align,
            flush_tuples,
        )
        self.flush_timeout_s = flush_timeout_s
        self.lanes = config.lanes
        self.state = self.pipeline.init_state()
        #: gang hook: when set, `flush` hands its FlushRequest snapshot to
        #: this callable (the server's per-signature queue) instead of
        #: compressing inline; results come back through `commit`
        self.flush_sink = None
        self._signature: Optional[tuple] = None  # memoized dispatch signature
        self._values = np.zeros(self.capacity, np.uint32)
        self._arrivals = np.zeros(self.capacity, np.float64)
        self._count = 0
        self.flushes: List[FlushRecord] = []
        #: egress=True keeps each flush's wire contribution (and the fed
        #: values, for the fidelity check) so the session can be closed into
        #: one wire-format frame and decoded back — the per-session egress
        #: path. Off by default: the hot ingest path pays no host copies.
        self.egress = egress
        #: compacted egress: fetch exact word prefixes; device-pack the
        #: 7-bit metadata only when session blocks splice word-aligned
        #: into the frame's global bitlen stream (capacity % 32 == 0)
        self._compact = compact
        self._meta_packed = compact and (self.capacity % 32 == 0)
        #: compact: (payload_exact, nbits, meta, valid) — meta is the packed
        #: uint32 stream when `_meta_packed` else raw int32 bitlens;
        #: legacy: (worst-case words, nbits, raw bitlens, valid)
        self._egress_blocks: List[tuple] = []
        self._egress_values: List[np.ndarray] = []
        self._egress_cache: Optional[tuple] = None  # (n_blocks, fidelity triple)
        self._decompressor: Optional[DecompressionPipeline] = None
        # ---- adaptive tier state (controller + tiers; DESIGN.md §16) ------
        #: the controller observing flush outcomes and picking rungs; None
        #: for ordinary (static) sessions
        self.controller = controller
        #: rung name -> (config, codec, plan); every rung pre-negotiated
        self._tiers: Dict[str, tuple] = dict(tiers or {})
        #: rung name -> lazily-built CompressionPipeline (fresh state per
        #: switch; the kernel compile is shared across return visits)
        self._tier_pipelines: Dict[str, CompressionPipeline] = {}
        self._tier_decomp: Dict[str, DecompressionPipeline] = {}
        self.active_tier: Optional[str] = active_tier
        #: rung decided for the NEXT flush while earlier snapshots are still
        #: uncommitted (gang waves in flight) — applied at the next flush()
        #: once the session has nothing outstanding
        self._pending_tier: Optional[str] = None
        self._inflight = 0  # enqueued-but-uncommitted flush snapshots
        #: sealed closed segments: (frame, fed_values, tier_name)
        self._sealed: List[tuple] = []
        self.tier_switches = 0
        #: tier that compressed each flush, parallel to `self.flushes`
        self.tier_history: List[str] = []
        #: server hook: called as listener(self, old_signature) after a tier
        #: switch so the gang dispatcher registers the new signature
        self.signature_listener = None
        # ---- trained dictionary hot-swap state (DESIGN.md §17) ------------
        #: dictionary published mid-stream, waiting for the next flush
        #: boundary with nothing in flight
        self._pending_dict = None
        self.dict_swaps = 0
        #: dict ref -> CompressionPipeline (a republished version switches
        #: back to its compiled pipeline instead of recompiling)
        self._dict_pipelines: Dict[str, CompressionPipeline] = {}
        #: frame dict_id -> seeded codec / decompressor, so egress decode of
        #: sealed pre-swap segments never depends on the process registry
        self._dict_codecs: Dict[Optional[tuple], Codec] = {}
        self._dict_decomp: Dict[Optional[tuple], DecompressionPipeline] = {}
        _topic0 = getattr(self.pipeline.codec, "dict_topic", None)
        if _topic0 is not None:
            did0 = (_topic0, self.pipeline.codec.dict_version)
            self._dict_codecs[did0] = self.pipeline.codec
            self._dict_pipelines[f"{did0[0]}:v{did0[1]}"] = self.pipeline
        if self.controller is not None:
            if active_tier is None or active_tier not in self._tiers:
                raise ValueError(
                    f"adaptive session {topic!r} needs active_tier naming one "
                    f"of its tiers, got {active_tier!r}"
                )
            if self._tiers:
                self._tier_pipelines[active_tier] = self.pipeline
        self._warm()

    def _warm(self) -> None:
        """Build and load the CUDA kernels up front so per-flush timings are
        compute, not nvcc (a no-op on the CPU, and once per process)."""
        self.pipeline.warmup()

    # ------------------------------------------------------- adaptive tiers
    def _seal_segment(self) -> None:
        """Close the active tier's accumulated blocks into one
        self-describing frame (fresh codec state follows, so stateful
        decode replays each segment independently)."""
        if not self.egress or not self._egress_blocks:
            return
        frame = self.egress_frame()
        fed = (
            np.concatenate(self._egress_values)
            if self._egress_values
            else np.zeros(0, np.uint32)
        )
        self._sealed.append((frame, fed, self.active_tier))
        self._egress_blocks = []
        self._egress_values = []
        self._egress_cache = None

    def _switch_tier(self, name: str) -> None:
        """Swap the session onto another rung AT a flush boundary: seal the
        open segment, install the rung's pipeline with fresh codec state,
        and re-register the dispatch signature so gang waves regroup."""
        if name == self.active_tier:
            return
        tier_cfg, tier_codec, tier_plan = self._tiers[name]
        self._seal_segment()
        pipe = self._tier_pipelines.get(name)
        if pipe is None:
            pipe = CompressionPipeline(
                tier_cfg, codec=tier_codec, plan=tier_plan, device=self.device
            )
            self._tier_pipelines[name] = pipe
        old_sig = self._signature
        self.config = tier_cfg
        self.pipeline = pipe
        tier_capacity = resolve_capacity(
            pipe.plan.block_tuples, tier_cfg.lanes, pipe.align,
            getattr(tier_cfg, "flush_tuples", 0),
        )
        assert tier_capacity == self.capacity, (
            f"tier {name!r} capacity {tier_capacity} != session capacity "
            f"{self.capacity} (negotiation must reject unequal ladders)"
        )
        self.state = pipe.init_state()
        self._signature = None
        self.active_tier = name
        self.tier_switches += 1
        self._warm()
        if self.signature_listener is not None:
            self.signature_listener(self, old_sig)

    # ------------------------------------------- trained dictionary hot-swap
    def swap_dictionary(self, trained) -> None:
        """Stage a published dictionary version; applied at the next flush
        boundary with nothing in flight (same deferral discipline as tier
        switches). The registry's publish subscription calls this for
        "topic:latest" jobs; embedders may call it directly."""
        codec = self.pipeline.codec
        if codec.meta.state_kind != "dictionary":
            raise ValueError(
                f"session {self.topic!r} runs codec {codec.name!r} which takes "
                "no trained dictionary"
            )
        if trained.idx_bits != codec.idx_bits:
            raise ValueError(
                f"dictionary '{trained.ref}' has idx_bits={trained.idx_bits}, "
                f"session {self.topic!r} runs idx_bits={codec.idx_bits}; "
                "retrain at the session's table size"
            )
        if trained.ref == getattr(codec, "dict_id", None):
            self._pending_dict = None  # already active; cancel any staged swap
            return
        self._pending_dict = trained

    def _switch_dict(self, trained) -> None:
        """Swap the session onto a new dictionary version AT a flush
        boundary: seal the open segment (its frames declare the OLD
        version), install a pipeline seeded with the new table, and
        re-register the dispatch signature so gang waves regroup — waves
        never mix dictionary versions."""
        self._seal_segment()
        old_sig = self._signature
        pipe = self._dict_pipelines.get(trained.ref)
        if pipe is None:
            codec = type(self.pipeline.codec)(
                idx_bits=trained.idx_bits, mode=self.pipeline.codec.mode
            ).seed_dictionary(trained)
            pipe = CompressionPipeline(
                self.config, codec=codec, plan=self.pipeline.plan, device=self.device
            )
            self._dict_pipelines[trained.ref] = pipe
        self.pipeline = pipe
        self._dict_codecs[trained.dict_id] = pipe.codec
        self.state = pipe.init_state()
        self._signature = None
        self._decompressor = None  # rebuilt lazily against the new seed
        self.dict_swaps += 1
        self._warm()
        if self.signature_listener is not None:
            self.signature_listener(self, old_sig)

    def egress_frames(self) -> List[bits.Frame]:
        """All wire frames this session produced, in stream order: sealed
        tier segments plus the open segment. Static sessions yield exactly
        [egress_frame()]."""
        frames = [f for f, _, _ in self._sealed]
        if self._egress_blocks:
            frames.append(self.egress_frame())
        return frames

    @property
    def n_segments(self) -> int:
        return len(self._sealed) + (1 if self._egress_blocks else 0)

    def _flush_step_fn(self):
        """The step one flush dispatch runs: the egress-compacted variant
        additionally packs the bitlen metadata in the same B1 launch (B4
        fused in; same dispatch count, wire-width transfer)."""
        if self.egress and self._meta_packed:
            return self.pipeline.masked_step_meta7
        return self.pipeline.masked_step

    # ------------------------------------------------------------- ingest
    @property
    def buffered(self) -> int:
        return self._count

    @property
    def oldest_arrival(self) -> Optional[float]:
        return float(self._arrivals[0]) if self._count else None

    @property
    def flush_deadline(self) -> Optional[float]:
        """When the buffered batch's flush timer fires: oldest arrival +
        timeout. None with nothing buffered. The ONE definition of the
        deadline — `poll`, the server's drain path, and tests all read this
        instead of poking `_arrivals`."""
        if not self._count:
            return None
        return float(self._arrivals[0]) + self.flush_timeout_s

    @property
    def signature(self) -> tuple:
        """Gang dispatch signature: sessions stack into one gang dispatch
        only when codec (including resolved/calibrated parameters), block
        geometry, and dtype all match — anything else would run a member
        under the wrong kernel or the wrong quantizer. Immutable after
        construction, so computed once and cached (the sink calls this on
        every flush)."""
        if self._signature is None:
            self._signature = dispatch_signature(
                self.pipeline.codec, self.lanes, self.capacity // self.lanes,
                entropy=self.pipeline.entropy,
                integrity=self.pipeline.integrity,
            )
        return self._signature

    def due(self, now: float) -> bool:
        """Size reached, or the oldest buffered tuple timed out."""
        if self._count >= self.capacity:
            return True
        deadline = self.flush_deadline
        return deadline is not None and now >= deadline

    def poll(self, now: float) -> Optional[FlushRecord]:
        """Fire the flush timer if it is due by `now`. The flush is stamped
        at the DEADLINE (oldest arrival + timeout), not at `now` — the clock
        may have advanced well past the deadline before the server polled
        (e.g. another topic's long arrival run), and the batch's tuples
        stopped waiting when the timer fired."""
        if not self.due(now):
            return None
        return self.flush(now=min(now, self.flush_deadline))

    def offer(self, value: int, ts: float) -> Optional[FlushRecord]:
        """Buffer one tuple; flush (and return the record) when full."""
        self._values[self._count] = value
        self._arrivals[self._count] = ts
        self._count += 1
        if self._count >= self.capacity:
            return self.flush(now=ts)
        return None

    def offer_many(self, values: np.ndarray, tss: np.ndarray) -> List[FlushRecord]:
        """Buffer a run of tuples (same topic, ascending timestamps),
        flushing whenever a batch fills OR a batch's deadline (oldest
        arrival + timeout) passes before the next tuple arrives.

        Returns the records of flushes executed inline; in gang mode
        (`flush_sink` set) flushes only enqueue, so the list is empty and
        their records land in `self.flushes` at gang dispatch."""
        out: List[FlushRecord] = []

        def _flushed(rec: Optional[FlushRecord]) -> None:
            if rec is not None:
                out.append(rec)

        i, n = 0, len(values)
        while i < n:
            if self._count == 0:
                deadline = float(tss[i]) + self.flush_timeout_s
            else:
                deadline = self.flush_deadline
                if float(tss[i]) > deadline:  # timer fired before this tuple
                    _flushed(self.flush(now=deadline))
                    continue
            space = self.capacity - self._count
            # tuples that arrive before the current batch's deadline join it
            take = int(np.searchsorted(tss[i : i + space], deadline, side="right"))
            take = max(take, 1)  # tss[i] <= deadline by construction
            self._values[self._count : self._count + take] = values[i : i + take]
            self._arrivals[self._count : self._count + take] = tss[i : i + take]
            self._count += take
            i += take
            if self._count >= self.capacity:
                _flushed(self.flush(now=float(tss[i - 1])))
        return out

    # -------------------------------------------------------------- flush
    def flush(self, now: float) -> Optional[FlushRecord]:
        """Compress the buffered batch (edge-padded if partial).

        Partial batches are padded with repeats of the batch's last value.
        What happens to the pad SYMBOLS depends on the codec's masking
        policy (DESIGN.md §10): maskable codecs (stateless decode) drop
        them from the bitstream; non-maskable codecs (ADPCM, Delta,
        Tdic32, RLE — their decoders replay state from the symbols
        themselves) ship them on the wire, because a decoder cannot
        regenerate the encoder's pad symbols and dropping them would fork
        encoder/decoder state at every partial flush. Either way the
        frame's per-block valid counts trim the pads after decode, so the
        reconstruction and accounting stay exact."""
        n = self._count
        if n == 0:
            return None
        # a decided tier switch lands HERE, at the flush boundary: the
        # buffered tuples have not been compressed yet, and nothing of this
        # session is still in flight under the old signature
        if self._pending_tier is not None and self._inflight == 0:
            self._switch_tier(self._pending_tier)
            self._pending_tier = None
        # a published dictionary lands at the same boundary: the sealed
        # segment's frames declare the old version, this batch the new one
        if self._pending_dict is not None and self._inflight == 0:
            self._switch_dict(self._pending_dict)
            self._pending_dict = None
        vals = np.full(self.capacity, self._values[max(n - 1, 0)], np.uint32)
        vals[:n] = self._values[:n]
        mask = np.zeros(self.capacity, bool)
        mask[:n] = True
        req = FlushRequest(
            values=vals,
            mask=mask,
            n=n,
            waits=np.maximum(now - self._arrivals[:n], 0.0),
            timeout=n < self.capacity,
        )
        self._count = 0
        if self.flush_sink is not None:
            # gang mode: the snapshot queues for a gang dispatch; the record
            # lands in `self.flushes` when the server scatters results back
            self._inflight += 1
            self.flush_sink(self, req)
            return None
        return self.compress_request(req)

    def compress_request(self, req: FlushRequest) -> FlushRecord:
        """Compress one flush snapshot inline (the solo dispatch path)."""
        block = bits.u32_tensor(req.values.reshape(self.lanes, -1), self.device)
        mask_dev = torch.from_numpy(req.mask.reshape(self.lanes, -1)).to(self.device)
        t0 = time.perf_counter()
        self.pipeline.dispatches += 1
        state, words, total_bits, meta = self._flush_step_fn()(self.state, block, mask_dev)
        total_bits = int(total_bits.item())  # the device sync ends the wall
        cost = time.perf_counter() - t0
        return self.commit(
            req, state, words, total_bits, meta, cost,
            meta_packed=self.egress and self._meta_packed,
        )

    def commit(
        self,
        req: FlushRequest,
        state,
        words,
        total_bits,
        meta,
        cost_s: float,
        meta_packed: bool = False,
    ) -> FlushRecord:
        """Install one compressed flush's results — shared by the inline
        path and the gang scatter. Ordering contract: a session's requests
        commit in flush order, each consuming the state the previous one
        produced.

        `words` is a device row: egress host copies happen here, after the
        timed region, and on the compacted path only the live
        `ceil(bits/32)`-word prefix crosses device->host. `meta` is raw
        int32 bitlens, or (meta_packed=True) the 7-bit-packed words a
        wave/solo egress dispatch produced; commit converts to the form
        this session stores, so mixed-mode gang waves stay consistent."""
        self.state = state
        if self.egress:  # host copies after the timed region
            tbi = int(total_bits)
            # egress fetches retry transient transfer errors with backoff
            # (DESIGN.md §18): the device row is immutable, so a retried
            # host copy is idempotent
            meta_np = with_backoff(
                lambda: bits.u32_numpy(meta) if meta_packed else meta.cpu().numpy()
            )
            # the only possible mismatch: a wave ran the meta7 dispatch for
            # an egress sibling, but THIS session stores raw bitlens (the
            # reverse cannot occur — a packed-storing session's presence is
            # exactly what makes a wave run meta7)
            if meta_packed and not self._meta_packed:
                meta_np = bits._unpack_bitlens(
                    meta_np.astype(np.uint32), self.capacity
                )
            if not self._meta_packed:
                meta_np = np.asarray(meta_np, np.int32).reshape(-1)
            if self._compact:
                payload = with_backoff(lambda: bits.u32_numpy(words[: (tbi + 31) // 32]))
            else:
                # legacy: full worst-case buffer
                payload = with_backoff(lambda: bits.u32_numpy(words))
            self.pipeline.d2h_payload_bytes += payload.nbytes
            self.pipeline.d2h_meta_bytes += meta_np.nbytes
            self.pipeline.d2h_ctrl_bytes += 4
            self._egress_blocks.append((payload, tbi, meta_np, req.n))
            self._egress_values.append(req.values[: req.n].copy())
        rec = FlushRecord(
            n_tuples=req.n,
            bits=float(total_bits),
            cost_s=cost_s,
            mean_wait_s=float(req.waits.mean()),
            max_wait_s=float(req.waits.max()),
            timeout=req.timeout,
        )
        self.flushes.append(rec)
        self._inflight = max(0, self._inflight - 1)
        if self.controller is not None:
            # close the loop: feed the outcome back, decide the NEXT flush's
            # rung. The switch itself is deferred to the next flush boundary
            # (and further, while earlier snapshots are still in flight).
            self.tier_history.append(self.active_tier or "")
            self.controller.observe(self.active_tier, req.n, int(total_bits))
            nxt = self.controller.decide()
            # a later decision may revert an unapplied switch — the LAST
            # decision before the boundary wins
            self._pending_tier = nxt.name if nxt.name != self.active_tier else None
        return rec

    # ------------------------------------------------------------- egress
    def egress_frame(self) -> bits.Frame:
        """Close the session's bitstream into one wire-format frame.

        All flushed micro-batches become full blocks of the session's
        capacity shape with per-block valid counts (partial/timeout flushes
        were padded); `Codec.flush`'s trailing symbols (RLE's open run) are
        packed as the flush mini-block. Leaves the session state untouched.

        The frame covers the session FROM ITS START: stateful decode must
        replay from the initial codec state, so egress blocks accumulate
        for the session's lifetime. For long-lived topics, rotate the
        session (close + re-admit) per retention interval rather than
        letting one frame grow without bound."""
        if not self.egress:
            raise RuntimeError("session was not created with egress=True")
        flush_entry = self.pipeline.flush_block_entry(self.state)
        flush_slots = 0 if flush_entry is None else self.pipeline.flush_slots
        n_full = len(self._egress_blocks)
        n_valid = sum(b[3] for b in self._egress_blocks)
        per_lane = self.capacity // self.lanes
        if not self._compact:
            blocks = list(self._egress_blocks)
            if flush_entry is not None:
                blocks.append(flush_entry)
            return self.pipeline.marshal_frame(
                blocks,
                per_lane=per_lane,
                n_full=n_full,
                tail_per_lane=0,
                flush_slots=flush_slots,
                n_valid=n_valid,
            )
        # compacted fast path: stored blocks are already wire-shaped —
        # concatenate segments + splice the flush mini-block, header math only
        segments = [b[0] for b in self._egress_blocks]
        block_bits = [b[1] for b in self._egress_blocks]
        block_valid = [b[3] for b in self._egress_blocks]
        flush_raw = np.zeros(0, np.int32)
        if flush_entry is not None:
            fw, fb, fbl, _ = flush_entry
            segments.append(np.asarray(fw[: (int(fb) + 31) // 32], np.uint32))
            block_bits.append(int(fb))
            block_valid.append(0)
            flush_raw = np.asarray(fbl, np.int32).ravel()
        payload = (
            np.concatenate(segments) if segments else np.zeros(0, np.uint32)
        )
        bitlen = packed_meta = None
        if self._meta_packed:
            # session blocks splice word-aligned; the flush mini-block's raw
            # bitlens host-pack onto the end (prefix symbols % 32 == 0)
            packed_meta = np.concatenate(
                [b[2] for b in self._egress_blocks]
                + [bits._pack_bitlens(flush_raw)]
            ) if self._egress_blocks or flush_raw.size else np.zeros(0, np.uint32)
        else:
            bitlen = np.concatenate(
                [b[2] for b in self._egress_blocks] + [flush_raw]
            ) if self._egress_blocks or flush_raw.size else np.zeros(0, np.int32)
        return self.pipeline.marshal_compacted(
            per_lane=per_lane,
            n_full=n_full,
            tail_per_lane=0,
            flush_slots=flush_slots,
            n_valid=n_valid,
            block_bits=np.asarray(block_bits, np.int64),
            block_valid=np.asarray(block_valid, np.int64),
            payload=payload,
            bitlen=bitlen,
            packed_meta=packed_meta,
        )

    def egress_fidelity(self):
        """Decode the session's frame and check the fidelity contract.

        Returns (Fidelity, wire_bytes, decode_wall_s): bit-exact for
        lossless codecs, within `Codec.error_bound` for bounded lossy ones,
        measured max-abs/RMSE/NRMSE regardless. Memoized on the segment +
        flush counts, so repeated `report()` calls between flushes do not
        re-frame and re-decode the whole session history.

        Adaptive sessions decode EVERY sealed tier segment with that tier's
        decompressor plus the open segment, and check the contract over the
        concatenation — a tier switch that corrupted either side of its
        boundary fails here."""
        cache_key = (len(self._sealed), len(self._egress_blocks))
        if self._egress_cache is not None and self._egress_cache[0] == cache_key:
            return self._egress_cache[1]
        decoded: List[np.ndarray] = []
        feds: List[np.ndarray] = []
        wire = 0
        wall = 0.0
        for frame, fed, tier in self._sealed:
            if tier is not None and tier in self._tiers:
                decomp = self._tier_decomp.get(tier)
                if decomp is None:
                    tier_cfg, tier_codec, _ = self._tiers[tier]
                    decomp = DecompressionPipeline(
                        tier_cfg, codec=tier_codec, device=self.device
                    )
                    self._tier_decomp[tier] = decomp
            else:
                # dictionary-swap seal (static session): decode with a codec
                # carrying the frame's declared seed, so the check never
                # depends on the process registry
                decomp = self._dict_decomp.get(frame.dict_id)
                if decomp is None:
                    codec = self._dict_codecs.get(frame.dict_id, self.pipeline.codec)
                    decomp = DecompressionPipeline(
                        self.config, codec=codec, device=self.device
                    )
                    self._dict_decomp[frame.dict_id] = decomp
            dec = decomp.decompress(frame)
            decoded.append(dec.values)
            feds.append(fed)
            wire += frame.wire_bytes
            wall += dec.wall_s
        if self._egress_blocks:
            frame = self.egress_frame()
            if self.controller is not None:
                # adaptive: the open segment's codec tracks the active tier
                decomp = self._tier_decomp.get(self.active_tier or "")
                if decomp is None:
                    decomp = DecompressionPipeline(
                        self.config, codec=self.pipeline.codec, device=self.device
                    )
                    self._tier_decomp[self.active_tier or ""] = decomp
            else:
                if self._decompressor is None:
                    self._decompressor = DecompressionPipeline(
                        self.config, codec=self.pipeline.codec, device=self.device
                    )
                decomp = self._decompressor
            dec = decomp.decompress(frame)
            decoded.append(dec.values)
            feds.append(
                np.concatenate(self._egress_values)
                if self._egress_values
                else np.zeros(0, np.uint32)
            )
            wire += frame.wire_bytes
            wall += dec.wall_s
        fed_all = np.concatenate(feds) if feds else np.zeros(0, np.uint32)
        dec_all = np.concatenate(decoded) if decoded else np.zeros(0, np.uint32)
        fid = metrics.fidelity(
            fed_all, dec_all, bound=self.pipeline.codec.error_bound()
        )
        out = (fid, wire, wall)
        self._egress_cache = (cache_key, out)
        return out

    # ------------------------------------------------------------- report
    def report(self, energy_j: float = 0.0) -> SessionReport:
        n_tuples = sum(f.n_tuples for f in self.flushes)
        bits = sum(f.bits for f in self.flushes)
        compute = sum(f.cost_s for f in self.flushes)
        input_bytes = n_tuples * 4
        lat = [f.mean_wait_s + f.cost_s for f in self.flushes]
        weights = np.array([f.n_tuples for f in self.flushes], np.float64)
        lat_arr = np.array(lat, np.float64)
        mean_lat = float((lat_arr * weights).sum() / max(weights.sum(), 1.0))
        p95 = float(np.percentile(lat_arr, 95)) if len(lat_arr) else 0.0
        fid = wire = dec_s = None
        if self.egress and self.flushes:
            fid, wire, dec_s = self.egress_fidelity()
        return SessionReport(
            topic=self.topic,
            codec=self.pipeline.codec.name,
            n_tuples=n_tuples,
            n_flushes=len(self.flushes),
            n_timeout_flushes=sum(f.timeout for f in self.flushes),
            input_bytes=input_bytes,
            output_bytes=bits / 8.0,
            ratio=(input_bytes * 8.0) / max(bits, 1.0),
            compute_s=compute,
            throughput_mbps=input_bytes / 1e6 / max(compute, 1e-12),
            mean_latency_s=mean_lat,
            p95_latency_s=p95,
            energy_j=energy_j,
            fidelity=fid,
            wire_bytes=wire,
            decode_s=dec_s,
            tier_switches=self.tier_switches,
            tier_history=tuple(self.tier_history),
            dict_swaps=self.dict_swaps,
        )


class ServerCore:
    """Admits N concurrent sessions; flushes size-or-timeout; schedules
    flushed blocks across the hardware profile.

    This is the serving/dispatch implementation behind BOTH public
    surfaces: `repro_torch.cstream.Dispatcher` (the job API) composes it, and
    `StreamServer` (deprecated) subclasses it unchanged.

    With `gang=True` the server runs the cross-session gang dispatcher
    (DESIGN.md §11): sessions that flush within the same scheduling quantum
    with the same (codec, block geometry, dtype) signature are folded into
    one state of S*L lanes and compressed by ONE launch of each kernel,
    then results/frames/metrics scatter back per session. Per-signature
    queues hold flush snapshots between quantum edges; a queue that exceeds
    its admission budget forces an immediate dispatch (backpressure), so
    deferred work is bounded."""

    def __init__(
        self,
        profile: str = "rk3399_amp",
        scheduling: SchedulingStrategy = SchedulingStrategy.ASYMMETRIC,
        max_sessions: int = 16,
        flush_timeout_s: float = 0.25,
        egress: bool = False,
        gang: bool = False,
        gang_quantum_s: Optional[float] = None,
        max_gang: Optional[int] = None,
        gang_budget: Optional[int] = None,
        mesh: Union[None, int, ElasticSession] = None,
        fault_injector: Any = None,
        heartbeat: Optional[HeartbeatMonitor] = None,
        breaker: Any = None,
        device: DeviceLike = None,
    ):
        #: where admitted sessions run (CUDA when None, or raise)
        self.device = resolve_device(device)
        self.profile = PROFILES[profile]
        self.scheduling = scheduling
        self.max_sessions = max_sessions
        self.flush_timeout_s = flush_timeout_s
        #: egress=True: every session keeps its wire payload, and reports
        #: carry the decoded-roundtrip fidelity contract next to ratio/
        #: throughput/latency/energy
        self.egress = egress
        self.sessions: Dict[str, StreamSession] = {}
        # ---- gang dispatcher state ----------------------------------------
        self.gang = gang
        self.gang_quantum_s = gang_quantum_s
        self.max_gang = max_gang
        self.gang_budget = gang_budget
        #: per-signature FIFO of (session, FlushRequest) awaiting a gang
        self._queues: Dict[tuple, List[Tuple[StreamSession, FlushRequest]]] = {}
        #: per-signature session whose (compiled) pipeline runs the gangs
        self._gang_owner: Dict[tuple, StreamSession] = {}
        #: per-signature compiled pipeline, captured at registration — waves
        #: must NOT read it through the owner session, whose `pipeline`
        #: attribute moves when an adaptive owner switches tiers
        self._gang_pipelines: Dict[tuple, CompressionPipeline] = {}
        self._gang_plans: Dict[tuple, GangPlan] = {}
        # ---- fleet dispatcher state (DESIGN.md §14) ------------------------
        #: `mesh` shards gang waves over a pure ("data",) device mesh: an int
        #: builds an ElasticSession over the first N devices visible on the
        #: server's device type; a prebuilt cstream-profile ElasticSession
        #: (which may name its slots' devices) is consumed as-is
        self.fleet: Optional[ElasticSession] = None
        #: injector with a `maybe_fail(wave)` raising DeviceLoss (chaos
        #: drills); real device loss surfaces the same way once mapped
        self.fault_injector = fault_injector
        #: serving-liveness heartbeat: beaten after every completed wave and
        #: after every device-loss recovery
        self.heartbeat = heartbeat
        self.fault_events: List[dict] = []
        self._wave_counter = 0
        self._device_busy_s = 0.0
        self._fleet_plans: Dict[tuple, FleetPlan] = {}
        self._stats: Dict[tuple, SignatureStats] = {}
        # ---- circuit-breaker admission (DESIGN.md §18) ---------------------
        #: `breaker` turns on per-signature admission breakers: True uses
        #: CircuitBreaker defaults, a dict is passed as its kwargs, and
        #: None/False runs without breakers (the historical behavior).
        #: While a signature's breaker is open its queued flushes stay
        #: PARKED — deferred, never dropped — and re-dispatch once the
        #: breaker's probe succeeds (or unconditionally at the final drain).
        if breaker is None or breaker is False:
            self._breaker_cfg: Optional[dict] = None
        elif breaker is True:
            self._breaker_cfg = {}
        else:
            self._breaker_cfg = dict(breaker)
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        if mesh is not None:
            if not gang:
                raise ValueError(
                    "mesh shards gang waves over devices; construct the "
                    "server with gang=True to use a fleet mesh"
                )
            if isinstance(mesh, ElasticSession):
                self.fleet = mesh
            else:
                n = int(mesh)
                avail = len(visible_devices(self.device))
                if n < 1:
                    raise ValueError(f"mesh must be >= 1 device, got {n}")
                if n > avail:
                    raise ValueError(
                        f"mesh={n} exceeds the {avail} visible device(s) of "
                        f"type {self.device.type}; pass ElasticSession({n}, "
                        "profile='cstream', devices=[...]) naming each slot's "
                        "device, or shrink the mesh"
                    )
                self.fleet = ElasticSession(n_devices=n, profile="cstream", device=self.device)
            if tuple(self.fleet.mesh.axis_names) != ("data",):
                raise ValueError(
                    "fleet mesh must be a pure ('data',) axis — build it "
                    "with ElasticSession(profile='cstream')"
                )

    # ------------------------------------------------------ gang dispatcher
    def _enqueue_flush(self, session: StreamSession, req: FlushRequest) -> None:
        """Session flush sink: queue the snapshot under its signature.

        Backpressure: when a signature's queue reaches its admission
        budget, the dispatcher fires immediately instead of waiting for
        the quantum edge — deferred flushes stay bounded even if one
        signature's sessions all burst at once."""
        sig = session.signature
        q = self._queues.setdefault(sig, [])
        q.append((session, req))
        if self.gang_budget is not None:
            budget = self.gang_budget
        elif sig in self._fleet_plans:
            budget = self._fleet_plans[sig].budget
        else:
            budget = self._gang_plans[sig].budget
        if len(q) >= budget:
            self._dispatch_signature(sig)

    def _dispatch_all(self, final: bool = False) -> None:
        """Quantum edge: drain every signature's queue as gang waves.

        Iteration follows queue creation order (first flush wins), which is
        deterministic because `run` replays merged arrivals over sorted
        topics — no dependence on feed dict ordering. `final=True` (the
        end-of-run drain) dispatches even through an OPEN breaker: parked
        work is deferred load, and the drain is its last chance to land —
        zero acknowledged frames may be lost to shedding."""
        for sig in list(self._queues):
            self._dispatch_signature(sig, force=final)

    def _dispatch_signature(self, sig: tuple, force: bool = False) -> None:
        q = self._queues.get(sig)
        if not q:
            return
        plan = self._gang_plans[sig]
        cap = self.max_gang if self.max_gang is not None else plan.max_gang
        if self.fleet is not None:
            # one sharded wave carries max_gang sessions PER DEVICE
            cap *= self.fleet.n_devices
        breaker = self._breakers.get(sig)
        while q:
            # breaker admission gate: an open breaker parks the queue in
            # place (deferred, never dropped); half-open lets ONE probe wave
            # through and stops until its outcome lands. The final drain
            # (`force`) bypasses the gate so nothing acknowledged is shed.
            probe = False
            if breaker is not None and not force:
                if not breaker.allow():
                    return
                probe = breaker.state == "half_open"
            # one wave: the oldest pending request of each distinct session,
            # up to the planned gang size. A session with several queued
            # flushes keeps FIFO order across waves (state carries).
            wave: List[Tuple[StreamSession, FlushRequest]] = []
            in_wave = set()
            rest: List[Tuple[StreamSession, FlushRequest]] = []
            for s, req in q:
                if s.topic not in in_wave and len(wave) < cap:
                    in_wave.add(s.topic)
                    wave.append((s, req))
                else:
                    rest.append((s, req))
            q[:] = rest
            done = self._execute_wave(sig, wave, force=force)
            if not done or (probe and breaker.state != "closed"):
                return  # wave parked back / probe failed: keep the rest parked

    def _execute_wave(
        self,
        sig: tuple,
        wave: List[Tuple[StreamSession, FlushRequest]],
        force: bool = False,
    ) -> bool:
        """Run one wave, surviving device loss (DESIGN.md §14).

        The recovery invariant: session state and flush records mutate ONLY
        in `commit`, after the dispatch completed — so when a device dies
        mid-wave, every member is still at its last committed FlushRecord
        and the wave replays exactly on the shrunk mesh. Orphaned sessions
        are re-admitted by re-running the same wave; nothing acknowledged
        is ever lost.

        With a breaker (DESIGN.md §18) every DeviceLoss records a failure
        and every completed wave a success; when repeated losses TRIP the
        breaker mid-retry, the wave parks back at the front of its queue
        (returning False) instead of hot-looping against a failing mesh —
        it replays after the cooldown probe, or at the final drain
        (`force=True`, which never parks)."""
        wave_idx = self._wave_counter
        self._wave_counter += 1
        breaker = self._breakers.get(sig)
        while True:
            try:
                if self.fault_injector is not None:
                    self.fault_injector.maybe_fail(wave_idx)
                self._run_wave(sig, wave)
                if breaker is not None:
                    breaker.record_success()
                if self.heartbeat is not None:
                    self.heartbeat.beat()
                return True
            except DeviceLoss as loss:
                if breaker is not None:
                    breaker.record_failure()
                self._on_device_loss(loss)
                if breaker is not None and not force and breaker.state == "open":
                    self._queues.setdefault(sig, [])[:0] = wave
                    return False

    def _on_device_loss(self, loss: DeviceLoss) -> None:
        """Re-mesh onto the surviving devices and re-plan wave sizing.

        The lost wave's members replay from their last committed
        FlushRecord (the caller retries the wave); fleet budgets/caps
        shrink with the mesh so backpressure keeps holding. `device` in
        the fault event is the lost slot's `str(torch.device)`."""
        if self.fleet is None:
            raise loss  # not a fleet server: nothing to re-mesh
        devs = list(self.fleet.mesh.devices)
        if loss.device_index >= len(devs):
            return  # stale report: that mesh slot is already gone
        healthy = [d for i, d in enumerate(devs) if i != loss.device_index]
        if not healthy:
            raise loss  # no survivors to re-admit the orphans onto
        self.fault_events.append(
            {
                "wave": loss.wave,
                "device": str(devs[loss.device_index]),
                "n_devices": len(healthy),
            }
        )
        self.fleet.resize(len(healthy), devices=healthy)
        for s, gp in self._gang_plans.items():
            self._fleet_plans[s] = plan_fleet(gp, self.fleet.n_devices)
        if self.heartbeat is not None:
            self.heartbeat.beat()  # recovery progress counts as liveness

    def _run_wave(
        self, sig: tuple, wave: List[Tuple[StreamSession, FlushRequest]]
    ) -> None:
        """Compress one gang wave: stack members' batches/masks/states,
        run ONE gang dispatch on the signature owner's pipeline, and
        scatter states, bitstreams and flush records back per member.
        Degenerate single-member waves take the inline solo path — exactly
        what a non-gang server would have run.

        On a fleet server the wave additionally shards over the mesh: it is
        padded to a multiple of the mesh width by replicating member 0 (pad
        outputs are discarded before commit, so member 0 advances once),
        and each slot compresses its contiguous shard on its own device.

        Egress scatter is compacted (DESIGN.md §13): only the per-member
        bit counts always cross device->host; each egress member's commit
        then slices its exact live word prefix (plus wire-width packed
        metadata when the wave ran the meta7 dispatch) out of the device
        rows — non-egress waves fetch no payload at all."""
        stats = self._stats.get(sig)
        if len(wave) == 1:
            s, req = wave[0]
            rec = s.compress_request(req)
            self._device_busy_s += rec.cost_s
            if stats is not None:
                stats.n_solo += 1
                stats.sessions_dispatched += 1
                stats.max_wave = max(stats.max_wave, 1)
            return
        pipe = self._gang_pipelines[sig]
        lanes = wave[0][0].lanes  # the signature fixes (lanes, per_lane)
        meta7 = any(s.egress and s._meta_packed for s, _ in wave)
        mesh = None
        members = wave
        pad = 0
        if self.fleet is not None and self.fleet.n_devices > 1:
            mesh = self.fleet.mesh
            pad = (-len(wave)) % self.fleet.n_devices
            members = wave + [wave[0]] * pad
        states = pipe.stack_states([s.state for s, _ in members])
        blocks = bits.u32_tensor(
            np.stack([req.values.reshape(lanes, -1) for _, req in members]), pipe.device
        )
        masks = torch.from_numpy(
            np.stack([req.mask.reshape(lanes, -1) for _, req in members])
        ).to(pipe.device)
        states, words, tbs, metas, wall = pipe.gang_step(
            states, blocks, masks, meta7=meta7, mesh=mesh
        )
        tb_np = tbs.cpu().numpy()
        cost = wall / len(wave)  # the dispatch is shared; so is its cost
        for i, (s, req) in enumerate(wave):  # pad slots sit past len(wave)
            s.commit(
                req,
                pipe.unstack_state(states, i),
                words[i],
                int(tb_np[i]),
                metas[i],
                cost,
                meta_packed=meta7,
            )
        # modeled per-device time: the measured wall covers ALL padded
        # slots' work serialized; one device carried slots/mesh-width of it
        total_slots = len(members)
        shard_slots = total_slots // mesh.size if mesh is not None else total_slots
        self._device_busy_s += wall * (shard_slots / total_slots)
        if stats is not None:
            stats.n_waves += 1
            stats.sessions_dispatched += len(wave)
            stats.max_wave = max(stats.max_wave, len(wave))
            stats.padded_slots += pad

    # -------------------------------------------------------------- admit
    def admit(
        self,
        topic: str,
        config: SpecLike,
        sample: Optional[np.ndarray] = None,
        flush_tuples: int = 0,
        flush_timeout_s: Optional[float] = None,
        egress: Optional[bool] = None,
        codec: Optional[Codec] = None,
        plan: Optional[ExecutionPlan] = None,
        compact: bool = True,
        controller: Any = None,
        tiers: Optional[Dict[str, tuple]] = None,
        active_tier: Optional[str] = None,
    ) -> StreamSession:
        """Admit one session on the server's device. `config` may be an
        `EngineConfig` or a `repro_torch.cstream.JobSpec`; `egress=None` inherits the server default;
        a pre-negotiated `codec`/`plan` is consumed as-is (the Dispatcher
        path, so negotiation happens exactly once). `compact=False` opts a
        session out of the compacted egress (the oracle baseline).
        `controller`/`tiers`/`active_tier` admit an ADAPTIVE session
        (DESIGN.md §16) whose signature re-registers on tier switches."""
        if topic in self.sessions:
            raise ValueError(f"session {topic!r} already admitted")
        if len(self.sessions) >= self.max_sessions:
            raise RuntimeError(
                f"server full: {len(self.sessions)}/{self.max_sessions} sessions"
            )
        # gang admission with a pre-negotiated codec+plan knows the dispatch
        # signature BEFORE building the session, so same-signature sessions
        # share the owner's pipeline (codec state stays per-session; waves
        # already run on the owner's pipeline regardless) — admitting 10k
        # sessions builds one codec and pipeline, not 10k
        shared: Optional[CompressionPipeline] = None
        if self.gang and codec is not None and plan is not None:
            cap = resolve_capacity(
                plan.block_tuples, config.lanes, codec_align(codec), flush_tuples
            )
            sig = dispatch_signature(
                codec, config.lanes, cap // config.lanes,
                entropy=getattr(config, "entropy", None) or "none",
                integrity=getattr(config, "integrity", None) or "none",
            )
            # the signature fixes (lanes, per_lane), so a registered
            # pipeline always matches this capacity
            shared = self._gang_pipelines.get(sig)
        session = StreamSession(
            topic,
            config,
            sample=sample,
            flush_tuples=flush_tuples,
            flush_timeout_s=(
                self.flush_timeout_s if flush_timeout_s is None else flush_timeout_s
            ),
            egress=self.egress if egress is None else egress,
            codec=codec,
            plan=plan,
            compact=compact,
            pipeline=shared,
            controller=controller,
            tiers=tiers,
            active_tier=active_tier,
            device=self.device,
        )
        self.sessions[topic] = session
        if self.gang:
            session.flush_sink = self._enqueue_flush
            self._register_signature(session)
            # every gang session listens for signature changes: adaptive
            # tier switches AND dictionary hot-swaps both re-key the queue,
            # and an unregistered signature would KeyError at enqueue
            session.signature_listener = self._on_signature_change
        return session

    def _register_signature(self, session: StreamSession) -> None:
        """Register a session under its CURRENT dispatch signature: the
        first arrival owns the gang's compiled pipeline and fixes the gang
        plan. Called at admit and again whenever an adaptive session's tier
        switch lands it on a new signature — the wave regrouping half of
        the flush-boundary switch invariant (DESIGN.md §16)."""
        sig = session.signature
        if sig not in self._gang_owner:
            self._gang_owner[sig] = session
            self._gang_pipelines[sig] = session.pipeline
            self._gang_plans[sig] = plan_gang(
                session.pipeline.plan,
                self.profile,
                flush_timeout_s=session.flush_timeout_s,
            )
            self._stats[sig] = SignatureStats(
                codec=session.pipeline.codec.name,
                lanes=session.lanes,
                per_lane=session.capacity // session.lanes,
            )
            if self.fleet is not None:
                self._fleet_plans[sig] = plan_fleet(
                    self._gang_plans[sig], self.fleet.n_devices
                )
            if self._breaker_cfg is not None:
                self._breakers[sig] = CircuitBreaker(**self._breaker_cfg)
        self._stats[sig].n_sessions += 1

    def _on_signature_change(
        self, session: StreamSession, old_sig: Optional[tuple]
    ) -> None:
        """Adaptive tier switch landed: future flushes of this session
        queue under the new signature; anything already dispatched under
        the old one committed before the switch (flush() defers switches
        while snapshots are in flight)."""
        self._register_signature(session)
        # the switched session also shares the registered compiled pipeline
        # when one exists for the new signature (capacity is signature-fixed)
        shared = self._gang_pipelines[session.signature]
        if shared is not session.pipeline:
            session.pipeline = shared
            if session.active_tier is not None:
                session._tier_pipelines[session.active_tier] = shared
            ref = getattr(shared.codec, "dict_id", None)
            if ref is not None:  # dictionary swap: cache for return visits
                session._dict_pipelines[ref] = shared
                session._dict_codecs[
                    (shared.codec.dict_topic, shared.codec.dict_version)
                ] = shared.codec
            session._warm()

    def session(self, topic: str) -> StreamSession:
        return self.sessions[topic]

    # ---------------------------------------------------------------- run
    def run(self, feeds: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> ServerReport:
        """Replay per-topic (values, arrival_timestamps) in merged time order.

        Tuples are offered to their session as their timestamps fire; any
        session whose oldest buffered tuple exceeds its flush timeout is
        flushed as the simulated clock passes the deadline."""
        unknown = set(feeds) - set(self.sessions)
        if unknown:
            raise KeyError(f"feeds for unadmitted topics: {sorted(unknown)}")
        topics = sorted(feeds)
        values = [np.ascontiguousarray(feeds[t][0], np.uint32).ravel() for t in topics]
        tss = [np.asarray(feeds[t][1], np.float64).ravel() for t in topics]
        for t, v, ts in zip(topics, values, tss):
            if len(v) != len(ts):
                raise ValueError(f"{t}: {len(v)} values vs {len(ts)} timestamps")

        # merged arrival order (stable: ties keep topic order)
        all_ts = np.concatenate(tss) if tss else np.zeros(0)
        topic_idx = np.concatenate(
            [np.full(len(ts), i, np.int32) for i, ts in enumerate(tss)]
        ) if tss else np.zeros(0, np.int32)
        within = np.concatenate(
            [np.arange(len(ts), dtype=np.int64) for ts in tss]
        ) if tss else np.zeros(0, np.int64)
        order = np.argsort(all_ts, kind="stable")

        sess = [self.sessions[t] for t in topics]
        # gang mode: collect flush snapshots between quantum edges; fire a
        # signature's gang dispatch whenever the simulated clock crosses its
        # next edge. Quanta come from the signature's GangPlan (half its
        # sessions' flush timeout) unless the server pins one globally.
        next_edges: Dict[tuple, float] = {}

        def _quantum(sig: tuple) -> float:
            if self.gang_quantum_s is not None:
                return self.gang_quantum_s
            return self._gang_plans[sig].quantum_s

        def _poll_gang_edges(now: float) -> None:
            for sig in list(self._queues):
                if not self._queues[sig]:
                    # drained (quantum or backpressure): drop the stale edge
                    # so the next burst collects a fresh quantum instead of
                    # firing an un-amortized wave of 1 on its first flush
                    next_edges.pop(sig, None)
                    continue
                q_s = _quantum(sig)
                edge = next_edges.get(sig)
                if edge is None:
                    next_edges[sig] = (np.floor(now / q_s) + 1.0) * q_s
                elif now >= edge:
                    self._dispatch_signature(sig)
                    next_edges[sig] = (np.floor(now / q_s) + 1.0) * q_s

        # deadline heap: only sessions whose flush timer can actually fire
        # are examined per clock step. Entries are (deadline, topic index)
        # pushed whenever a session buffers; stale entries (the batch
        # already flushed, so the live deadline moved) are dropped on pop.
        # Replaces the poll-every-session sweep, which made the replay
        # quadratic in the session count — at 10k+ fleet sessions that
        # sweep WAS the server.
        pending: List[Tuple[float, int]] = []

        def _note(k: int) -> None:
            d = sess[k].flush_deadline
            if d is not None:
                heapq.heappush(pending, (d, k))

        # walk the merged order in runs of equal topic so full batches move
        # through offer_many; timeout flushes fire as the clock advances
        i, n = 0, len(order)
        while i < n:
            j = i
            tpi = topic_idx[order[i]]
            while j < n and topic_idx[order[j]] == tpi:
                j += 1
            run_idx = within[order[i:j]]
            now = float(all_ts[order[j - 1]])
            sess[tpi].offer_many(values[tpi][run_idx], tss[tpi][run_idx])
            _note(tpi)
            while pending and pending[0][0] <= now:
                d, k = heapq.heappop(pending)
                if sess[k].flush_deadline == d:  # else stale: batch moved on
                    sess[k].poll(now)
                    _note(k)
            if self.gang:
                _poll_gang_edges(now)
            i = j
        # drain: every residual batch's timer fires after its oldest arrival
        for s in sess:
            if s.buffered:
                s.flush(s.flush_deadline)
        if self.gang:
            self._dispatch_all(final=True)

        return self.report(topics)

    # ------------------------------------------------------------- report
    def report(self, topics: Optional[List[str]] = None) -> ServerReport:
        topics = sorted(self.sessions) if topics is None else topics
        sess = [self.sessions[t] for t in topics]
        records = [f for s in sess for f in s.flushes]
        costs = [f.cost_s for f in records]
        _, busy, makespan = schedule_blocks(costs, self.profile.speeds, self.scheduling)
        energy = edge_energy_j(
            self.profile, busy, makespan,
            spin_wait=self.scheduling == SchedulingStrategy.UNIFORM,
        )
        total_cost = sum(costs)
        reports = {}
        for s in sess:
            share = sum(f.cost_s for f in s.flushes) / max(total_cost, 1e-12)
            reports[s.topic] = s.report(energy_j=energy * share)
        total_tuples = sum(r.n_tuples for r in reports.values())
        input_bytes = sum(r.input_bytes for r in reports.values())
        output_bytes = sum(r.output_bytes for r in reports.values())
        # over ALL admitted sessions, not just the reported topics: gang
        # waves count on the signature owner's pipeline, and the owner may
        # not be among the fed topics. Deduplicate by pipeline identity —
        # same-signature sessions SHARE the owner's pipeline, and summing
        # per session would count each shared launch once per member.
        pipes = {id(s.pipeline): s.pipeline for s in self.sessions.values()}
        n_dispatches = sum(p.dispatches for p in pipes.values())
        dispatch_stats = {}
        breakers = {}
        for sig, st in self._stats.items():
            label = st.label
            while label in dispatch_stats:  # same codec+geometry, other params
                label += "'"
            dispatch_stats[label] = st
            br = self._breakers.get(sig)
            if br is not None:
                breakers[label] = br.snapshot()
        # fleet throughput model: per-device busy time accumulated at wave
        # execution (wall x shard/padded slots). On a 1-device mesh (or no
        # mesh) it is the summed wave walls, which is compute_s exactly.
        device_makespan = self._device_busy_s if self.gang else total_cost
        return ServerReport(
            sessions=reports,
            n_sessions=len(sess),
            total_tuples=total_tuples,
            total_input_bytes=input_bytes,
            total_output_bytes=output_bytes,
            ratio=(input_bytes * 8.0) / max(output_bytes * 8.0, 1.0),
            compute_s=total_cost,
            makespan_s=makespan,
            busy_s=busy,
            energy_j=energy,
            aggregate_mbps=input_bytes / 1e6 / max(makespan, 1e-12),
            n_dispatches=n_dispatches,
            devices=self.fleet.n_devices if self.fleet is not None else 1,
            dispatch_stats=dispatch_stats,
            fault_events=list(self.fault_events),
            device_makespan_s=device_makespan,
            fleet_mbps=input_bytes / 1e6 / max(device_makespan, 1e-12),
            breakers=breakers,
        )


class StreamServer(ServerCore):
    """Deprecated shim: the pre-job-API entry point (DESIGN.md §12).

    Bit-identical to `ServerCore` — it IS `ServerCore`, plus a
    DeprecationWarning. New code declares sessions as `repro_torch.cstream`
    JobSpecs and drives them through `Dispatcher.open(spec)` handles."""

    def __init__(self, *args: Any, **kwargs: Any):
        warnings.warn(
            "StreamServer is deprecated; use repro_torch.cstream.Dispatcher "
            "(JobSpec-driven session handles) instead — see DESIGN.md §12 "
            "for the migration table",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
