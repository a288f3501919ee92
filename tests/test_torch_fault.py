"""The port's fault-tolerance pieces (`repro_torch.runtime.fault`) against
the reference's (`repro.runtime.fault`), on the CPU:
  * the circuit breaker, `with_backoff`, the wire injectors and the
    device-loss schedule, each scenario run on both packages on the same
    fake clock, with equal traces (states, rates, snapshots, sleeps);
  * the registry-outage injector over the port's dictstore;
  * the server's breaker drill on a one-device mesh: the wave parks, the
    probe replays it and no acknowledged tuple is lost, with the
    reference's flush records and breaker snapshots; and a device loss on
    a server without a mesh propagates, as in the reference;
  * `run_with_restarts` resuming exactly, with an in-memory checkpoint
    manager (the reference's manager is ROADMAP A10's).
"""
import copy
import time

import numpy as np
import pytest
import torch

from repro import cstream as rcs
from repro.core.strategies import EngineConfig as RefConfig
from repro.runtime import fault as rfault
from repro.runtime.server import ServerCore as RefCore
from repro_torch import cstream as tcs
from repro_torch.core import dictstore
from repro_torch.core.strategies import EngineConfig
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.server import ServerCore

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

BOTH = [tfault, rfault]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _trace(br) -> tuple:
    return (br.state, round(br.failure_rate, 12), br.events, br.trips, br.shed)


def _breaker_scenario(mod, name: str) -> list:
    """One breaker drill on `mod`'s CircuitBreaker: the trace after every
    step (state, rate, events, trips, shed) and every `allow()` answer."""
    clk = _Clock()
    br = mod.CircuitBreaker(clock=clk, cooldown_s=0.25)
    out = []

    def step(what, *args):
        r = getattr(br, what)(*args) if what != "tick" else setattr(clk, "t", clk.t + args[0])
        out.append((what, r, _trace(br)))

    steps = {
        "trips": [("allow",), ("record_failure",), ("record_failure",), ("record_failure",), ("allow",)],
        "half_open_probe": [("record_failure",)] * 3 + [("tick", 0.3), ("allow",), ("allow",),
                                                         ("record_success",), ("allow",)],
        "probe_failure": [("record_failure",)] * 3 + [("tick", 0.3), ("allow",), ("record_failure",),
                                                       ("allow",), ("tick", 0.3), ("allow",)],
        "success_decays": [("record_failure",), ("record_success",), ("record_success",)],
        "mixed": [("record_failure",), ("record_success",), ("record_failure",), ("record_failure",),
                  ("record_failure",), ("allow",), ("tick", 0.1), ("allow",), ("tick", 0.2),
                  ("allow",), ("record_success",), ("allow",)],
    }[name]
    for s in steps:
        step(*s)
    out.append(("snapshot", br.snapshot(), None))
    return out


@pytest.mark.parametrize("name", ["trips", "half_open_probe", "probe_failure", "success_decays", "mixed"])
def test_breaker_matches_reference(name):
    ours, theirs = _breaker_scenario(tfault, name), _breaker_scenario(rfault, name)
    assert ours == theirs
    if name == "trips":
        assert ours[3][2][0] == "open" and ours[4][1] is False and ours[4][2][4] == 1
    if name == "half_open_probe":
        assert [r for w, r, _ in ours if w == "allow"] == [True, False, True]
        assert ours[-2][2][0] == "closed"


@pytest.mark.parametrize("mod", BOTH, ids=["port", "reference"])
def test_with_backoff_retries_then_succeeds(mod):
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert mod.with_backoff(flaky, attempts=3, base_s=0.005, sleep=sleeps.append) == "ok"
    assert sleeps == [0.005, 0.01]


@pytest.mark.parametrize("mod", BOTH, ids=["port", "reference"])
def test_with_backoff_last_failure_propagates_and_unlisted_errors_pass(mod):
    sleeps = []

    def broken():
        raise OSError("still down")

    with pytest.raises(OSError, match="still down"):
        mod.with_backoff(broken, attempts=3, sleep=sleeps.append)
    assert len(sleeps) == 2

    def typo():
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        mod.with_backoff(typo, attempts=3, sleep=lambda s: None)


def _wire(mod, buf: bytes) -> list:
    inj = mod.FrameCorruptor(flip_at={1: 4, 2: -3})
    cut = mod.TruncationInjector(cut_at={0: 6, 1: -4})
    return [inj.maybe_corrupt(i, buf) for i in (0, 1, 1, 2)] + [
        cut.maybe_truncate(i, buf) for i in (0, 1, 0, 2)]


def test_wire_injectors_match_reference():
    buf = bytes(range(16))
    ours = _wire(tfault, buf)
    assert ours == _wire(rfault, buf)
    assert ours[1][4] == buf[4] ^ 0x40 and ours[2] == buf and ours[3][13] == buf[13] ^ 0x40
    assert ours[4:] == [buf[:6], buf[:-4], buf, buf]


def test_device_loss_injector_sequence_matches_reference():
    seen = {}
    for mod in BOTH:
        inj = mod.DeviceLossInjector(fail_at_waves={3: (0, 1), 5: 2})
        log = []
        for wave in (3, 3, 3, 4, 5, 5):
            try:
                inj.maybe_fail(wave)
                log.append(None)
            except mod.DeviceLoss as loss:
                log.append((loss.device_index, loss.wave, str(loss)))
        seen[mod.__name__] = (log, sorted(inj.fired))
    assert seen["repro_torch.runtime.fault"] == seen["repro.runtime.fault"]
    assert seen["repro.runtime.fault"][0][:3] == [(0, 3, "device 0 lost during wave 3"),
                                                   (1, 3, "device 1 lost during wave 3"), None]


@pytest.mark.parametrize("mod", BOTH, ids=["port", "reference"])
def test_fault_injector_fires_once_per_step(mod):
    inj = mod.FaultInjector(fail_at_steps=(2,))
    inj.maybe_fail(1)
    with pytest.raises(RuntimeError, match="injected node failure at step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)


def _publish(reg, seed: int):
    rng = np.random.default_rng(seed)
    sample = ((rng.zipf(1.3, size=4096) - 1) % 300).astype(np.uint32)
    return reg.publish(dictstore.train_dict(sample, idx_bits=10, topic="sensor"))


def test_registry_outage_keeps_resident_serving(tmp_path):
    """The injector over the port's registry: resident versions keep
    serving, `latest` falls back to the newest resident one, and an explicit
    version on disk refuses in one line."""
    reg = dictstore.DictRegistry(root=str(tmp_path), max_resident=1)
    _publish(reg, 0)
    _publish(reg, 1)  # v2 resident, v1 on disk
    with tfault.RegistryOutageInjector(reg) as outage:
        assert reg.get("sensor").version == 2
        assert outage.loads_refused == 0
        with pytest.raises(KeyError) as ei:
            reg.get("sensor", 1)
        assert "sensor:v1" in str(ei.value) and "\n" not in str(ei.value)
        assert outage.loads_refused == 1
    assert reg._load.__func__ is dictstore.DictRegistry._load  # restored
    assert reg.get("sensor", 1).version == 1


# ------------------------------------------------------- server breaker drill --
def _drill(core_cls, config_cls, fault_mod, sched, cooldown, n_blocks, **kw):
    inj = fault_mod.DeviceLossInjector(fail_at_waves={0: sched})
    srv = core_cls(gang=True, mesh=1, egress=True, gang_budget=1, fault_injector=inj,
                   breaker={"cooldown_s": cooldown}, **kw)
    s = srv.admit("t", config_cls(codec="tcomp32", micro_batch_bytes=2048, lanes=4))
    cap = s.capacity
    vals = (np.arange(n_blocks * cap, dtype=np.uint32) * 2654435761) % 100_003
    rep = srv.run({"t": (vals.astype(np.uint32), np.arange(n_blocks * cap) * 1e-5)})
    return s, rep


@pytest.mark.parametrize("sched,cooldown,n_blocks", [((7, 7, 7), 0.0, 3), ((9, 9, 9), 3600.0, 4)],
                         ids=["recovers", "sheds_until_drain"])
def test_server_breaker_parks_and_recovers_zero_loss(sched, cooldown, n_blocks):
    """Repeated wave failures (stale device slots on a one-device mesh) trip
    the signature's breaker; the wave parks, never drops, and replays after
    the probe (or at the final drain when the breaker never recovers):
    every acknowledged tuple lands, with the reference's records, breaker
    snapshot and frame."""
    s, rep = _drill(ServerCore, EngineConfig, tfault, sched, cooldown, n_blocks, device="cpu")
    rs, rrep = _drill(RefCore, RefConfig, rfault, sched, cooldown, n_blocks)
    cap = s.capacity
    assert sum(f.n_tuples for f in s.flushes) == n_blocks * cap
    assert [f.key() for f in s.flushes] == [f.key() for f in rs.flushes]
    assert rep.breakers == rrep.breakers
    snap = next(iter(rep.breakers.values()))
    assert snap["trips"] >= 1
    if cooldown == 0.0:
        assert snap["state"] == "closed"
    else:
        assert snap["shed"] >= 1
    assert s.egress_frame().to_bytes() == rs.egress_frame().to_bytes()
    assert rep.fault_events == rrep.fault_events == []


def test_device_loss_without_a_mesh_propagates():
    """No mesh, no survivors: the loss surfaces to the caller, as in the
    reference, and the session keeps its last committed state."""
    for core_cls, config_cls, mod, kw in ((ServerCore, EngineConfig, tfault, {"device": "cpu"}),
                                          (RefCore, RefConfig, rfault, {})):
        srv = core_cls(gang=True, gang_budget=1, fault_injector=mod.DeviceLossInjector({0: 0}), **kw)
        s = srv.admit("t", config_cls(codec="tcomp32", micro_batch_bytes=2048, lanes=4))
        with pytest.raises(mod.DeviceLoss, match="device 0 lost during wave 0"):
            srv.run({"t": (np.arange(s.capacity, dtype=np.uint32), np.zeros(s.capacity))})
        assert s.flushes == []


def test_server_without_breaker_and_dispatcher_passthrough():
    srv = ServerCore(gang=True, egress=True, device="cpu")
    s = srv.admit("t", EngineConfig(codec="tcomp32", micro_batch_bytes=2048, lanes=4))
    rep = srv.run({"t": (np.arange(s.capacity, dtype=np.uint32), np.arange(s.capacity) * 1e-5)})
    assert rep.breakers == {}
    reps = []
    for mod, kw in ((tcs, {"device": "cpu"}), (rcs, {})):
        spec = mod.JobSpec(codec="tcomp32", egress=True, gang=True, flush_tuples=512)
        with mod.Dispatcher(gang=True, breaker=True, **kw) as d:
            h = d.open(spec, topic="t")
            h.push(np.arange(1024, dtype=np.uint32), timestamps=np.arange(1024) * 1e-5)
            reps.append(d.run())
    assert reps[0].breakers == reps[1].breakers
    assert next(iter(reps[0].breakers.values()))["state"] == "closed"


# --------------------------------------------------------- heartbeat, stragglers --
@pytest.mark.parametrize("mod", BOTH, ids=["port", "reference"])
def test_heartbeat_detects_stall(mod):
    events = []
    hb = mod.HeartbeatMonitor(timeout_s=0.15, on_stall=events.append).start(poll_s=0.03)
    try:
        hb.beat()
        time.sleep(0.08)
        assert not hb.stalled
        time.sleep(0.25)
        assert hb.stalled and events
        hb.beat()
        assert not hb.stalled
    finally:
        hb.stop()
    assert not hb._thread.is_alive()


def test_straggler_detector_matches_reference():
    times = [0.10] * 8 + [0.5, 0.12, 0.11, 0.4, 0.1]
    got = []
    for mod in BOTH:
        det = mod.StragglerDetector(window=16, threshold=2.0)
        got.append(([det.record(i, t) for i, t in enumerate(times)], det.events, det.median()))
    assert got[0] == got[1]
    assert got[0][0][8] and got[0][1][0]["step"] == 8


# ------------------------------------------------------------- run_with_restarts --
class MemoryCheckpoints:
    """An in-memory checkpoint manager: `save_async` keeps a deep copy per
    step, `restore_latest` returns the newest (step, state) or (None, None)."""

    def __init__(self):
        self.saved = {}
        self.waits = 0

    def save_async(self, step, state):
        self.saved[step] = copy.deepcopy(state)

    def wait(self):
        self.waits += 1

    def restore_latest(self, shardings=None):
        if not self.saved:
            return None, None
        step = max(self.saved)
        return step, copy.deepcopy(self.saved[step])


def _count_step(step, state):
    return {"acc": state["acc"] + float(step + 1)}


@pytest.mark.parametrize("injector,restarts,resumed", [
    (lambda: tfault.FaultInjector(fail_at_steps=(7,)), 1, [6]),
    (lambda: tfault.DeviceLossInjector(fail_at_waves={7: (0, 1)}), 2, [6, 6]),
    (lambda: tfault.FaultInjector(fail_at_steps=(1,)), 1, [0]),
], ids=["one_fault", "double_fault_during_replay", "before_first_checkpoint"])
def test_run_with_restarts_resumes_exactly(injector, restarts, resumed):
    """With faults mid-run (or before any checkpoint, which restarts from
    the initial state), the final state equals the no-fault run's."""
    want, _ = tfault.run_with_restarts(_count_step, {"acc": 0.0}, 10, MemoryCheckpoints(),
                                       checkpoint_every=2)
    mgr = MemoryCheckpoints()
    got, log = tfault.run_with_restarts(_count_step, {"acc": 0.0}, 10, mgr, checkpoint_every=2,
                                        injector=injector())
    assert got == want == {"acc": 55.0}
    assert log["restarts"] == restarts and log["resumed_from"] == resumed
    assert sorted(mgr.saved) == [2, 4, 6, 8, 10] and mgr.waits == restarts + 1


def test_run_with_restarts_gives_up_after_max():
    def bad_step(step, state):
        raise RuntimeError("always broken")

    with pytest.raises(RuntimeError, match="always broken"):
        tfault.run_with_restarts(bad_step, {"x": 0.0}, 5, MemoryCheckpoints(), max_restarts=2)


def test_run_with_restarts_composed_with_monitors():
    """Heartbeat beaten every step, the one slow step flagged by the
    straggler detector, a mid-run fault: the final state is still exact."""

    def step_fn(step, state):
        time.sleep(0.05 if step == 8 else 0.01)
        return _count_step(step, state)

    hb = tfault.HeartbeatMonitor(timeout_s=60.0)
    det = tfault.StragglerDetector(window=16, threshold=2.5)
    got, log = tfault.run_with_restarts(
        step_fn, {"acc": 0.0}, 10, MemoryCheckpoints(), checkpoint_every=2,
        injector=tfault.FaultInjector(fail_at_steps=(7,)), straggler=det, heartbeat=hb,
    )
    assert got == {"acc": 55.0}
    assert log["restarts"] == 1 and log["stragglers"] >= 1
    assert any(e["step"] == 8 for e in det.events) and not hb.stalled
