"""Fault tolerance (port of `repro/runtime/fault.py`; DESIGN.md §8).

Three cooperating pieces, all host-side (no device state):

  HeartbeatMonitor — the train loop beats once per step; a watchdog thread
      flags a STALL if no beat lands within `timeout_s` (hung collective,
      dead host).  At 1000+ nodes this is the per-host agent the cluster
      scheduler scrapes; here the same object drives the in-process restart
      policy and is unit-tested directly.

  StragglerDetector — keeps a rolling window of step times and flags steps
      slower than `threshold` x the rolling median: the multi-device analogue of
      the paper's asymmetry problem (one slow worker drags the makespan —
      exactly Fig 13b's "big cores waiting for little cores").  The driver
      responds by logging + optionally re-balancing grad-accumulation
      micro-batches (the asymmetry-aware knob) rather than blocking.

  run_with_restarts — supervisor loop: run the step function; on failure
      (or injected fault) restore the latest COMMITTED checkpoint and
      resume.  Resume-exactness is tested in tests/test_torch_fault.py.

The chaos harness (DESIGN.md §18) adds a CircuitBreaker for per-signature
admission shedding, with_backoff for transient egress-fetch failures, and
three wire/registry injectors (FrameCorruptor, TruncationInjector,
RegistryOutageInjector) that a chaos drill drives against live sessions.
Everything here is host Python; nothing imports torch. `run_with_restarts`
takes any checkpoint manager with `save_async`/`wait`/`restore_latest`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Type, Union


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 300.0
    on_stall: Optional[Callable[[float], None]] = None
    _last_beat: float = dataclasses.field(default_factory=time.monotonic)
    _stalled: bool = False
    _stop: threading.Event = dataclasses.field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None

    def beat(self):
        self._last_beat = time.monotonic()
        self._stalled = False

    @property
    def stalled(self) -> bool:
        return self._stalled

    def start(self, poll_s: float = 1.0):
        def watch():
            while not self._stop.wait(poll_s):
                silent = time.monotonic() - self._last_beat
                if silent > self.timeout_s and not self._stalled:
                    self._stalled = True
                    if self.on_stall:
                        self.on_stall(silent)

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()


@dataclasses.dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 2.0
    _times: Deque[float] = dataclasses.field(default_factory=deque)
    events: List[dict] = dataclasses.field(default_factory=list)

    def record(self, step: int, step_time_s: float) -> bool:
        """Returns True if this step is a straggler vs the rolling median."""
        med = self.median()
        self._times.append(step_time_s)
        if len(self._times) > self.window:
            self._times.popleft()
        if med is not None and step_time_s > self.threshold * med:
            self.events.append({"step": step, "time_s": step_time_s, "median_s": med})
            return True
        return False

    def median(self) -> Optional[float]:
        if len(self._times) < 4:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule for tests/drills: raises at given steps."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class DeviceLoss(RuntimeError):
    """A device dropped out of the serving mesh mid-wave (DESIGN.md §14).

    Carries which mesh slot died and during which wave, so the fleet
    dispatcher can re-mesh onto the survivors and replay the wave — wave
    results only commit AFTER a dispatch completes, so the lost wave's
    sessions are still at their last committed FlushRecord and the replay
    is exact (zero acknowledged frames lost)."""

    def __init__(self, device_index: int, wave: int = -1):
        super().__init__(f"device {device_index} lost during wave {wave}")
        self.device_index = device_index
        self.wave = wave


@dataclasses.dataclass
class DeviceLossInjector:
    """Deterministic kill-a-device schedule for fleet chaos drills.

    `fail_at_waves` maps wave index -> mesh slot to kill, or a sequence of
    slots for double-fault drills (one loss per retry attempt of the same
    wave). Each scheduled loss fires exactly once; the wave must then
    SUCCEED on the shrunk mesh (like `FaultInjector`'s once-per-step
    contract)."""

    fail_at_waves: Dict[int, Union[int, Tuple[int, ...], List[int]]] = (
        dataclasses.field(default_factory=dict)
    )
    fired: set = dataclasses.field(default_factory=set)
    _counts: Dict[int, int] = dataclasses.field(default_factory=dict)

    def maybe_fail(self, wave: int):
        sched = self.fail_at_waves.get(wave)
        if sched is None:
            return
        slots = [sched] if isinstance(sched, int) else list(sched)
        count = self._counts.get(wave, 0)
        if count >= len(slots):
            return
        self._counts[wave] = count + 1
        self.fired.add(wave)
        raise DeviceLoss(slots[count], wave)


# ======================================================================
# Circuit-breaker admission + retry-with-backoff (DESIGN.md §18)
# ======================================================================


@dataclasses.dataclass
class CircuitBreaker:
    """Closed / open / half-open admission breaker on an EWMA failure rate.

    `record_success` / `record_failure` feed outcomes; `allow()` gates
    admission. The breaker opens when the EWMA failure rate exceeds
    `trip_rate` after at least `min_events` observations, sheds while
    open, lets exactly ONE probe through after `cooldown_s`, and closes
    again on a probe success (reopens on probe failure). Per-signature
    instances live in `ServerCore`; parked work is re-admitted when the
    breaker allows, so shedding defers load instead of dropping it."""

    alpha: float = 0.3  # EWMA weight of the newest outcome
    trip_rate: float = 0.5  # open when the failure EWMA exceeds this
    min_events: int = 3  # never trip before this many observations
    cooldown_s: float = 0.25  # open -> half-open (probe) after this long
    clock: Callable[[], float] = time.monotonic
    state: str = "closed"
    failure_rate: float = 0.0
    events: int = 0
    trips: int = 0
    shed: int = 0  # admissions refused while open
    _opened_at: float = 0.0
    _probing: bool = False

    def record_success(self) -> None:
        self.events += 1
        self.failure_rate *= 1.0 - self.alpha
        if self.state in ("half_open", "open"):
            # a success observed while open/half-open closes the breaker:
            # the downstream recovered (the probe, or a replayed wave)
            self.state = "closed"
            self._probing = False
            self.failure_rate = 0.0

    def record_failure(self) -> None:
        self.events += 1
        self.failure_rate = self.alpha + (1.0 - self.alpha) * self.failure_rate
        if self.state == "half_open":
            self.state = "open"
            self._opened_at = self.clock()
            self._probing = False
        elif (
            self.state == "closed"
            and self.events >= self.min_events
            and self.failure_rate > self.trip_rate
        ):
            self.state = "open"
            self._opened_at = self.clock()
            self.trips += 1

    def allow(self) -> bool:
        """True when work may be admitted now; counts sheds while open."""
        if self.state == "closed":
            return True
        if self.state == "open" and self.clock() - self._opened_at >= self.cooldown_s:
            self.state = "half_open"
            self._probing = False
        if self.state == "half_open" and not self._probing:
            self._probing = True  # exactly one probe until its outcome lands
            return True
        self.shed += 1
        return False

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "failure_rate": round(self.failure_rate, 4),
            "events": self.events,
            "trips": self.trips,
            "shed": self.shed,
        }


def with_backoff(
    fn: Callable[[], Any],
    attempts: int = 3,
    base_s: float = 0.005,
    retry_on: Tuple[Type[BaseException], ...] = (RuntimeError, OSError),
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run `fn`, retrying transient failures with exponential backoff.

    Used on egress host-copy fetches: a transient device/transfer error
    gets `attempts` tries (base_s, 2*base_s, ...); the last failure
    propagates so callers see the real error, not a swallowed one."""
    for i in range(attempts):
        try:
            return fn()
        except retry_on:
            if i == attempts - 1:
                raise
            sleep(base_s * (1 << i))
    raise AssertionError("unreachable")


# ======================================================================
# Wire & registry chaos injectors (DESIGN.md §18)
# ======================================================================


@dataclasses.dataclass
class FrameCorruptor:
    """Deterministic bit-flip schedule over a frame stream.

    `flip_at` maps frame index -> byte offset whose bit 6 is flipped
    (negative offsets index from the end, numpy-style). Each scheduled
    corruption fires once; `maybe_corrupt` returns the (possibly
    corrupted) bytes so collectors can splice it into their ingest path."""

    flip_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def maybe_corrupt(self, idx: int, buf: bytes) -> bytes:
        off = self.flip_at.get(idx)
        if off is None or idx in self.fired or not buf:
            return buf
        self.fired.add(idx)
        mutated = bytearray(buf)
        mutated[off % len(mutated)] ^= 0x40
        return bytes(mutated)


@dataclasses.dataclass
class TruncationInjector:
    """Deterministic truncation schedule over a frame stream.

    `cut_at` maps frame index -> bytes to KEEP (negative = drop that many
    from the tail). Each scheduled cut fires once."""

    cut_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def maybe_truncate(self, idx: int, buf: bytes) -> bytes:
        keep = self.cut_at.get(idx)
        if keep is None or idx in self.fired:
            return buf
        self.fired.add(idx)
        return buf[: keep if keep >= 0 else max(0, len(buf) + keep)]


class RegistryOutageInjector:
    """Simulated dictionary-registry backing-store outage (context manager).

    While active, the target `DictRegistry`'s artifact loader raises a
    single-line DictStoreError on every cache miss. Resident (already
    loaded or pinned-resident) entries keep serving — `DictRegistry.get`
    only hits the loader on a miss — so decode either uses the exact
    version it already holds or refuses with an actionable error; it can
    never decode with the wrong table."""

    def __init__(self, registry: Any) -> None:
        self.registry = registry
        self.loads_refused = 0
        self._orig: Optional[Callable[..., Any]] = None

    def __enter__(self) -> "RegistryOutageInjector":
        from repro_torch.core.dictstore import DictStoreError

        reg = self.registry
        self._orig = reg._load

        def down(topic: str, version: int):
            self.loads_refused += 1
            raise DictStoreError(
                f"dictionary '{topic}:v{version}' unavailable: registry "
                "backing store outage (injected); resident copies keep "
                "serving — retry once the store recovers"
            )

        reg._load = down
        return self

    def __exit__(self, *exc_info) -> None:
        if self._orig is not None:
            self.registry._load = self._orig
            self._orig = None


def run_with_restarts(
    step_fn: Callable[[int, object], object],
    init_state: object,
    n_steps: int,
    manager,  # CheckpointManager
    checkpoint_every: int = 10,
    max_restarts: int = 3,
    shardings=None,
    injector: Optional[FaultInjector] = None,
    straggler: Optional[StragglerDetector] = None,
    heartbeat: Optional[HeartbeatMonitor] = None,
):
    """Supervised training segment: checkpoint/restart on failure.

    step_fn(step, state) -> state.  Returns (final_state, log) where log
    records restarts and straggler events.  State must be a pytree (it is
    checkpointed as-is)."""
    log = {"restarts": 0, "resumed_from": [], "stragglers": 0}
    state = init_state
    step = 0
    restarts = 0
    while step < n_steps:
        try:
            while step < n_steps:
                if injector is not None:
                    injector.maybe_fail(step)
                t0 = time.perf_counter()
                state = step_fn(step, state)
                dt = time.perf_counter() - t0
                if heartbeat is not None:
                    heartbeat.beat()
                if straggler is not None and straggler.record(step, dt):
                    log["stragglers"] += 1
                step += 1
                if step % checkpoint_every == 0:
                    manager.save_async(step, state)
            break
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            manager.wait()
            got_step, got = manager.restore_latest(shardings)
            if got is None:
                state, step = init_state, 0
            else:
                state, step = got, got_step
            log["restarts"] += 1
            log["resumed_from"].append(step)
    manager.wait()
    return state, log
