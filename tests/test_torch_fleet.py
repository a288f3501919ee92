"""The port's sharded serving fleet (`repro_torch.runtime.elastic`,
`ServerCore(mesh=...)`, `gang_step(mesh=...)`, `negotiate(devices>=1)`,
`Dispatcher(mesh=...)`) against the reference's, on the CPU. Each test of
`tests/test_fleet.py` has its counterpart here, both packages on the same
inputs.

The reference cannot produce sharded frames in this container (its drill
needs XLA's forced host devices and fails inside jax's gather), but its
drill's claim is that sharded waves, and waves replayed through device
losses, equal the UNSHARDED gang byte for byte. So the port's 4-slot drill
(four CPU slots in-process, `ElasticSession(4, profile="cstream",
devices=[cpu] * 4)`) is held against the reference's unsharded gang.

Intended differences (`PORT_ONLY`): a mesh wider than the visible devices
is refused naming the visible device count, where the reference names an
XLA flag; and a fault event's `device` is the lost slot's
`str(torch.device)` ("cpu" here for every slot), where the reference
prints its jax device.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st  # skips when absent

from repro import cstream as rcs
from repro.core import strategies as rstrat
from repro.runtime import elastic as relastic
from repro.runtime import fault as rfault
from repro.runtime.server import StreamServer as RefServer
from repro_torch import cstream as tcs
from repro_torch.core import strategies as tstrat
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.data import make_dataset
from repro_torch.data.stream import rate_for_dataset, zipf_timestamps
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.server import StreamServer

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
#: stateful codecs (rle runs, tdic32 dictionary) next to stateless: the
#: shard scatter must keep every member straight, like the gang scatter
MIX = [("tcomp32", "micro"), ("rle", "sensor"), ("tdic32", "rovio")]
#: the intended differences from the reference's text and fields
PORT_ONLY = {
    "wider_than_visible": "visible device",
    "fault_event_device": "cpu",
}


@pytest.fixture(autouse=True)
def _no_shim_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _cfg(mod, codec, **kw):
    return mod.EngineConfig(codec=codec, micro_batch_bytes=2048, lanes=4, **kw)


def _four_slots(n: int = 4) -> telastic.ElasticSession:
    return telastic.ElasticSession(n, profile="cstream", devices=[CPU] * n)


# ------------------------------------------------------------ mesh planning --
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_plan_mesh_cstream_any_device_count(n):
    """Any healthy count, primes included, meshes as a pure data axis; the
    lm factoring equals the reference's too."""
    assert telastic.plan_mesh(n, profile="cstream") == ((n,), ("data",))
    for profile in ("cstream", "lm"):
        assert telastic.plan_mesh(n, profile=profile) == relastic.plan_mesh(n, profile=profile)


def test_plan_mesh_validation():
    for mod in (telastic, relastic):
        with pytest.raises(ValueError, match=">= 1"):
            mod.plan_mesh(0, profile="cstream")
        with pytest.raises(ValueError, match="unknown mesh profile"):
            mod.plan_mesh(4, profile="tpu")
    assert telastic.plan_mesh(16) == ((1, 16), ("data", "model"))
    assert telastic.plan_mesh(3) == ((3, 1), ("data", "model"))
    for n in (6, 24, 512, 1024, 1536):
        assert telastic.plan_mesh(n) == relastic.plan_mesh(n)


def test_logical_mapping_data_only_mesh():
    for names in (("data",), ("data", "model"), ("pod", "data", "model")):
        assert telastic.logical_mapping(names) == relastic.logical_mapping(names)
    assert telastic.logical_mapping(("data",)) == {"data": "data"}


def test_elastic_session_cstream_profile():
    es = telastic.ElasticSession(n_devices=1, profile="cstream", device="cpu")
    ref = relastic.ElasticSession(n_devices=1, profile="cstream")
    assert es.mesh.axis_names == tuple(ref.mesh.axis_names) == ("data",)
    assert es.mapping == ref.mapping == {"data": "data"}
    assert es.mesh.devices == (CPU,) and es.mesh.size == 1
    # resize with an explicit (pinned) survivor list round-trips
    es.resize(1, devices=[CPU])
    assert es.n_devices == 1 and list(es.mesh.devices) == [CPU]
    # explicit slots may repeat a device; a width beyond the visible
    # devices needs them
    four = _four_slots()
    assert four.mesh.size == 4 and four.mesh.shape == (4,) and set(four.mesh.devices) == {CPU}
    assert four.resize(3, devices=list(four.mesh.devices)[1:]).mesh.size == 3
    with pytest.raises(ValueError, match=PORT_ONLY["wider_than_visible"]):
        telastic.ElasticSession(n_devices=2, profile="cstream", device="cpu")
    # a job's logical specs resolve onto the mesh as the reference's do,
    # and reshard places each leaf as one shard per slot
    specs = {"w": ("data", None), "b": ()}
    got, want = es.shardings_for(specs), ref.shardings_for(specs)
    assert {k: v.spec for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    w = torch.arange(9.0).reshape(3, 3)  # `four` was resized to 3 slots above
    placed = telastic.reshard({"w": w, "b": torch.ones(2)}, specs, four.mesh, four.mapping)
    assert [tuple(s.shape) for s in placed["w"].shards] == [(1, 3)] * 3
    assert torch.equal(placed["w"].gather(), w) and torch.equal(placed["b"].shards[2], torch.ones(2))


def test_plan_fleet_scales_gang_plan():
    gp = tstrat.plan_gang(tstrat.plan_execution(_cfg(tstrat, "tcomp32")))
    fp = tstrat.plan_fleet(gp, 4)
    ref = rstrat.plan_fleet(rstrat.plan_gang(rstrat.plan_execution(_cfg(rstrat, "tcomp32"))), 4)
    assert isinstance(fp, tstrat.FleetPlan)
    assert (fp.devices, fp.max_wave, fp.budget, fp.quantum_s) == (
        ref.devices, ref.max_wave, ref.budget, ref.quantum_s)
    assert fp.max_wave == 4 * gp.max_gang and fp.budget == 4 * gp.budget
    with pytest.raises(ValueError, match=">= 1 device"):
        tstrat.plan_fleet(gp, 0)


# ------------------------------------------------------------- chaos pieces --
def test_device_loss_injector_fires_once():
    for mod in (tfault, rfault):
        inj = mod.DeviceLossInjector(fail_at_waves={2: 1})
        inj.maybe_fail(0)  # unscheduled waves pass
        with pytest.raises(mod.DeviceLoss) as exc:
            inj.maybe_fail(2)
        assert (exc.value.device_index, exc.value.wave) == (1, 2)
        inj.maybe_fail(2)  # the retried wave must succeed


def _one_capacity_run(**kw):
    server = StreamServer(gang=True, device="cpu", **kw)
    s = server.admit("t", _cfg(tstrat, "tcomp32"))
    cap = s.capacity
    return server, s, {"t": (np.arange(cap, dtype=np.uint32), np.zeros(cap))}


def test_device_loss_without_fleet_raises():
    """A non-fleet gang server has no mesh to shrink: the loss propagates."""
    server, s, feed = _one_capacity_run(fault_injector=tfault.DeviceLossInjector({0: 0}))
    with pytest.raises(tfault.DeviceLoss):
        server.run(feed)
    assert s.flushes == [] and server.fault_events == []


def test_device_loss_with_no_survivors_raises():
    """Killing the last device cannot re-admit the orphans anywhere."""
    server, s, feed = _one_capacity_run(mesh=1, fault_injector=tfault.DeviceLossInjector({0: 0}))
    with pytest.raises(tfault.DeviceLoss):
        server.run(feed)
    assert s.flushes == [] and server.fleet.n_devices == 1


# ------------------------------------------------------- server validation --
def _both_refuse(kw: dict, exc_type=ValueError):
    with pytest.raises(exc_type) as ours:
        StreamServer(device="cpu", **kw)
    with pytest.raises(exc_type) as theirs:
        RefServer(**kw)
    return str(ours.value), str(theirs.value)


def test_server_mesh_requires_gang():
    ours, theirs = _both_refuse(dict(mesh=1))
    assert ours == theirs and "gang=True" in ours


def test_server_mesh_bounds():
    ours, theirs = _both_refuse(dict(gang=True, mesh=0))
    assert ours == theirs and ">= 1" in ours
    # beyond the visible devices: the reference names an XLA flag, the port
    # the visible device count (one CPU here, as jax's one CPU device)
    ours, theirs = _both_refuse(dict(gang=True, mesh=jax.device_count() + 1))
    assert PORT_ONLY["wider_than_visible"] in ours and "XLA_FLAGS" in theirs
    assert StreamServer(gang=True, mesh=_four_slots(), device="cpu").fleet.n_devices == 4


def test_server_rejects_lm_mesh():
    """A model-axis mesh has no session axis to shard waves over."""
    with pytest.raises(ValueError) as ours:
        StreamServer(gang=True, mesh=telastic.ElasticSession(n_devices=1, profile="lm", device="cpu"),
                     device="cpu")
    with pytest.raises(ValueError) as theirs:
        RefServer(gang=True, mesh=relastic.ElasticSession(n_devices=1, profile="lm"))
    assert str(ours.value) == str(theirs.value) and "pure ('data',)" in str(ours.value)


# ------------------------------------------------------- negotiation surface --
def test_jobspec_devices_field():
    for mod in (tcs, rcs):
        with pytest.raises(mod.NegotiationError, match="devices"):
            mod.JobSpec(devices=-1)
        spec = mod.JobSpec(codec="tcomp32", gang=True, devices=1)
        assert mod.JobSpec.from_dict(spec.to_dict()) == spec
        assert spec.to_dict()["devices"] == 1
    assert tcs.JobSpec(devices=3).to_dict() == rcs.JobSpec(devices=3).to_dict()


def test_negotiate_devices_requires_gang():
    with pytest.raises(tcs.NegotiationError, match="gang=False") as ours:
        tcs.negotiate(tcs.JobSpec(devices=2, gang=False), device="cpu")
    with pytest.raises(rcs.NegotiationError) as theirs:
        rcs.negotiate(rcs.JobSpec(devices=2, gang=False))
    assert str(ours.value) == str(theirs.value)


def test_negotiate_devices_bounded_by_visible():
    too_many = jax.device_count() + 1
    with pytest.raises(tcs.NegotiationError, match=PORT_ONLY["wider_than_visible"]) as ours:
        tcs.negotiate(tcs.JobSpec(devices=too_many, gang=True), device="cpu")
    with pytest.raises(rcs.NegotiationError, match="XLA_FLAGS"):
        rcs.negotiate(rcs.JobSpec(devices=too_many, gang=True))
    assert "\n" not in str(ours.value)


def test_negotiate_attaches_fleet_plan():
    plan = tcs.negotiate(tcs.JobSpec(codec="tcomp32", gang=True, devices=1), device="cpu")
    ref = rcs.negotiate(rcs.JobSpec(codec="tcomp32", gang=True, devices=1))
    assert isinstance(plan.fleet, tstrat.FleetPlan)
    assert (plan.fleet.devices, plan.fleet.max_wave, plan.fleet.budget, plan.fleet.quantum_s) == (
        ref.fleet.devices, ref.fleet.max_wave, ref.fleet.budget, ref.fleet.quantum_s)
    assert plan.fleet.devices == 1 and plan.fleet.max_wave == plan.gang.max_gang
    # devices=0: dispatcher-local, no fleet sizing
    assert tcs.negotiate(tcs.JobSpec(codec="tcomp32"), device="cpu").fleet is None


def test_dispatcher_mesh_negotiation_errors():
    with pytest.raises(tcs.NegotiationError, match="gang=True"):
        tcs.Dispatcher(mesh=1, device="cpu")
    with pytest.raises(tcs.NegotiationError, match=PORT_ONLY["wider_than_visible"]):
        tcs.Dispatcher(gang=True, mesh=jax.device_count() + 1, device="cpu")
    d = tcs.Dispatcher(gang=True, mesh=1, device="cpu")
    assert d.devices == 1
    with pytest.raises(tcs.NegotiationError):
        d.open(tcs.JobSpec(codec="tcomp32", gang=True, devices=2))
    # named slots: a spec no wider than the dispatcher opens; past the
    # visible-device check, a wider one meets the dispatcher's own refusal
    wide = tcs.Dispatcher(gang=True, mesh=_four_slots(), device="cpu")
    assert wide.devices == 4
    spec = tcs.JobSpec(codec="tcomp32", gang=True, devices=1)
    assert wide.open(spec, topic="ok").topic == "ok"
    narrow = tcs.Dispatcher(gang=True, mesh=_four_slots(2), device="cpu")
    plan = tcs.negotiate(spec, device="cpu")
    with pytest.raises(tcs.NegotiationError, match="runs a 2-device mesh") as ours:
        narrow._open_negotiated(spec.replace(devices=3), plan, None)
    assert "Dispatcher(gang=True, mesh=3)" in str(ours.value)


def test_open_many_validation_and_naming():
    d = tcs.Dispatcher(gang=True, device="cpu")
    spec = tcs.JobSpec(codec="tcomp32", gang=True)
    with pytest.raises(tcs.NegotiationError, match="exactly one"):
        d.open_many(spec)
    with pytest.raises(tcs.NegotiationError, match="exactly one"):
        d.open_many(spec, count=2, topics=["a", "b"])
    with pytest.raises(tcs.NegotiationError, match=">= 1"):
        d.open_many(spec, count=0)
    hs = d.open_many(spec, topics=["a", "b"])
    assert [h.topic for h in hs] == ["a", "b"]
    more = d.open_many(spec, count=2)  # auto names skip existing sessions
    assert all(h.topic not in ("a", "b") for h in more)
    assert len(d.sessions) == 4
    ref = rcs.Dispatcher(gang=True)
    ref.open_many(rcs.JobSpec(codec="tcomp32", gang=True), topics=["a", "b"])
    assert [h.topic for h in more] == [h.topic for h in ref.open_many(
        rcs.JobSpec(codec="tcomp32", gang=True), count=2)]


def test_open_many_shares_owner_pipeline():
    """8 same-spec sessions on a 4-slot fleet negotiate once and share ONE
    pipeline (codec state stays per-session); the report counts that
    pipeline's dispatches once, and its records equal the reference's
    unsharded dispatcher's."""
    reps, records = [], []
    for mod, kw in ((tcs, dict(mesh=_four_slots(), device="cpu")), (rcs, {})):
        d = mod.Dispatcher(gang=True, max_sessions=16, **kw)
        hs = d.open_many(mod.JobSpec(codec="tcomp32", gang=True, flush_tuples=128), count=8)
        assert len({id(h._session.pipeline) for h in hs}) == 1
        for i, h in enumerate(hs):
            h.push(np.arange(128, dtype=np.uint32), timestamps=np.full(128, 0.001 * i, np.float64))
        d.run()
        rep = d.close()
        assert rep.n_dispatches == hs[0]._session.pipeline.dispatches
        assert rep.total_tuples == 8 * 128
        reps.append(rep)
        records.append({t: [f.key() for f in s.flushes] for t, s in d.sessions.items()})
    assert records[0] == records[1]
    assert reps[0].devices == 4 and reps[1].devices == 1


# ------------------------------------------------------ fleet equivalence --
def _feeds(n_sessions: int, n: int, mix=MIX) -> dict:
    rate = rate_for_dataset(1)
    out = {}
    for i in range(n_sessions):
        codec, ds = mix[i % len(mix)]
        vals = make_dataset(ds, n_tuples=n).stream()[:n]
        out[f"{codec}-{i}"] = (codec, vals, zipf_timestamps(n, rate, zipf_factor=0.7, seed=i))
    return out


def _run(server, mod, feeds):
    for topic, (codec, vals, _) in feeds.items():
        server.admit(topic, _cfg(mod, codec), sample=vals)
    rep = server.run({t: (v, ts) for t, (_, v, ts) in feeds.items()})
    out = {t: (tuple(f.key() for f in s.flushes), s.egress_frame().to_bytes())
           for t, s in server.sessions.items()}
    return out, rep


def _port(feeds, **kw):
    return _run(StreamServer(max_sessions=16, egress=True, gang=True, device="cpu", **kw),
                tstrat, feeds)


def _reference(feeds):
    return _run(RefServer(max_sessions=16, egress=True, gang=True), rstrat, feeds)


def test_fleet_mesh1_bit_identical_to_gang():
    """The 1-device fleet IS the gang dispatcher: records, frames and the
    report equal the port's gang and the reference's, and the report's
    fleet surface is filled in."""
    hb = tfault.HeartbeatMonitor(timeout_s=1e9)  # not started: beat() only
    beat0 = hb._last_beat
    feeds = _feeds(6, 2400)
    gang, gang_rep = _port(feeds)
    fleet, fleet_rep = _port(feeds, mesh=1, heartbeat=hb)
    ref, ref_rep = _reference(feeds)
    assert fleet == gang == ref
    assert gang_rep.total_tuples == fleet_rep.total_tuples == ref_rep.total_tuples
    assert fleet_rep.devices == 1 and fleet_rep.fault_events == []
    assert fleet_rep.device_makespan_s > 0 and fleet_rep.fleet_mbps > 0
    assert set(fleet_rep.dispatch_stats) == set(ref_rep.dispatch_stats) == {
        f"{codec}/4x128" for codec, _ in MIX}
    for label, st in fleet_rep.dispatch_stats.items():
        r = ref_rep.dispatch_stats[label]
        assert (st.n_sessions, st.n_waves, st.n_solo, st.sessions_dispatched, st.max_wave) == (
            r.n_sessions, r.n_waves, r.n_solo, r.sessions_dispatched, r.max_wave)
        assert st.n_sessions == 2 and st.sessions_dispatched > 0
        assert st.padded_slots == 0 and st.occupancy == 1.0  # a mesh of 1 never pads
        assert 0 < st.mean_wave <= st.max_wave <= 2
    assert hb._last_beat > beat0  # every completed wave beat the monitor


def test_fleet_report_breakdown_solo_waves():
    """Waves of one take the inline solo path but still count in the
    signature breakdown, on a 4-slot fleet too (a solo wave never pads)."""
    for mesh in (1, _four_slots()):
        server, _, feed = _one_capacity_run(mesh=mesh)
        server.run(feed)
        rep = server.report()
        (st,) = rep.dispatch_stats.values()
        assert st.label.startswith("tcomp32/")
        assert st.n_solo >= 1 and st.n_waves == 0 and st.padded_slots == 0
        assert st.sessions_dispatched == st.n_solo
        assert rep.device_makespan_s > 0


@pytest.fixture(scope="module")
def drill_reference():
    """The reference drill's inputs (9 sessions of the MIX, 2,000 tuples
    each) and the reference's UNSHARDED gang over them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        feeds = _feeds(9, 2000)
        return feeds, _reference(feeds)[0]


def test_sharded_and_chaos_waves_bit_identical(drill_reference):
    """4 slots in-process: sharded waves AND waves replayed through two
    device losses give the reference's unsharded gang records and frames
    byte for byte (zero acknowledged frames lost). Slot 2 dies during wave
    1 and slot 0 during wave 3: 4 -> 3 -> 2 devices, the 3-wide mesh a
    prime survivor count that pads differently."""
    feeds, base = drill_reference
    shard, rep4 = _port(feeds, mesh=_four_slots())
    assert shard == base, "4-way sharded waves are not byte-identical"
    assert rep4.devices == 4
    assert any(s.padded_slots > 0 for s in rep4.dispatch_stats.values())
    for st in rep4.dispatch_stats.values():
        # 9 sessions over 3 signatures: waves of 3 pad to 4 on the 4-slot mesh
        assert st.n_waves > 0 and st.padded_slots == st.n_waves * (-3 % 4)
        assert st.occupancy == pytest.approx(3 / 4)

    chaos, repc = _port(feeds, mesh=_four_slots(),
                        fault_injector=tfault.DeviceLossInjector({1: 2, 3: 0}))
    assert chaos == base, "device loss leaked into acknowledged frames"
    assert [e["n_devices"] for e in repc.fault_events] == [3, 2]
    assert [e["wave"] for e in repc.fault_events] == [1, 3]
    assert {e["device"] for e in repc.fault_events} == {PORT_ONLY["fault_event_device"]}
    assert repc.devices == 2
    assert 0 < repc.device_makespan_s < repc.compute_s


def test_sharded_wave_launch_shape_and_stale_slot():
    """`gang_step(mesh=...)` on 3 slots: the outputs equal the unsharded
    step's, member for member (tdic32 shared: each member's merge stays
    its own); S that does not divide the mesh is refused with the
    reference's text; a report of a slot past the mesh is stale."""
    spec = tcs.JobSpec(codec="tdic32", state="shared", params={"idx_bits": 8}, lanes=4,
                       micro_batch_bytes=2048)
    pipe = CompressionPipeline(spec, device="cpu")
    per_lane = pipe.block_tuples // 4
    vals = make_dataset("rovio", n_tuples=6 * pipe.block_tuples, seed=5).stream()
    blocks = torch.from_numpy(vals[: 6 * pipe.block_tuples].view(np.int32).reshape(6, 4, per_lane).copy())
    masks = torch.ones(blocks.shape, dtype=torch.bool)
    masks[5, :, per_lane // 2:] = False
    states = pipe.stack_states([pipe.init_state() for _ in range(6)])
    mesh = _four_slots(3).mesh
    plain = pipe.gang_step(states, blocks, masks, meta7=True)
    sharded = pipe.gang_step(states, blocks, masks, meta7=True, mesh=mesh)
    for k in plain[0]:
        assert torch.equal(plain[0][k], sharded[0][k]), k
    for a, b in zip(plain[1:4], sharded[1:4]):
        assert torch.equal(a, b)
    assert sharded[4] > 0 and pipe.dispatches == 2
    with pytest.raises(ValueError, match="does not divide the 4-device mesh"):
        pipe.gang_step(states, blocks, masks, mesh=_four_slots().mesh)
    server = StreamServer(gang=True, mesh=_four_slots(), device="cpu")
    server._on_device_loss(tfault.DeviceLoss(7, 0))
    assert server.fleet.n_devices == 4 and server.fault_events == []


@settings(max_examples=12, deadline=None)
@given(width=st.integers(2, 5), n_sessions=st.integers(1, 9),
       codec=st.sampled_from(["tcomp32", "tdic32"]))
def test_sharded_waves_equal_gang_property(width, n_sessions, codec):
    """Any mesh width 2-5 and 1-9 sessions: the sharded fleet's records and
    frames equal the unsharded gang's, and every wave pads to a multiple of
    the width."""
    feeds = _feeds(n_sessions, 1200, mix=[(codec, "rovio"), (codec, "sensor")])
    gang, _ = _port(feeds)
    shard, rep = _port(feeds, mesh=_four_slots(width))
    assert shard == gang
    assert rep.devices == width
    for st in rep.dispatch_stats.values():
        assert (st.sessions_dispatched - st.n_solo + st.padded_slots) % width == 0
