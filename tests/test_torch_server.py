"""The port's serving runtime (`repro_torch.runtime.server`, `cstream.
Dispatcher`, dispatcher-bound `StreamHandle`s) against the reference's, on
the CPU: session batching, timeout flushes stamped at the deadline,
admission control, state carried across flushes, determinism across repeats
and feed order (gang off and on), mixed codecs under bursty arrivals, an
adaptive session's tier history and sealed frames, a `topic:latest`
session hot-swapped on publish, and fleet servers (a one-device mesh and
four CPU slots) with the reference's mesh refusals. Flush records
(`FlushRecord.key()`), egress frames and the timing-free fields of
`SessionReport`/`ServerReport` equal the reference's; walls are measured,
never compared."""
import warnings

import numpy as np
import pytest
import torch

from repro import cstream as rcs
from repro.core import controller as rctl
from repro.core import dictstore as rds
from repro.core.strategies import EngineConfig as RefConfig
from repro.data.stream import rate_for_dataset, uniform_timestamps, zipf_timestamps
from repro.runtime.server import ServerCore as RefCore
from repro.runtime.server import StreamServer as RefServer
from repro.runtime.server import StreamSession as RefSession
from repro_torch import cstream as tcs
from repro_torch.core import controller as tctl
from repro_torch.core import dictstore as tds
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.strategies import EngineConfig
from repro_torch.data import make_dataset
from repro_torch.runtime.elastic import ElasticSession
from repro_torch.runtime.server import ServerCore, StreamServer, StreamSession

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

#: codec chosen per dataset (paper Fig 5: no codec wins everywhere)
MIX = [("tcomp32", "micro"), ("tdic32", "rovio"), ("tcomp32", "stock"), ("tdic32", "sensor")]
#: SessionReport / ServerReport fields that are not measured walls
SESSION_FIELDS = ("topic", "codec", "n_tuples", "n_flushes", "n_timeout_flushes", "input_bytes",
                  "output_bytes", "ratio", "wire_bytes", "tier_switches", "tier_history", "dict_swaps")
SERVER_FIELDS = ("n_sessions", "total_tuples", "total_input_bytes", "total_output_bytes", "ratio",
                 "n_dispatches", "devices", "fault_events", "breakers")


@pytest.fixture(autouse=True)
def _no_shim_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _both(**kw):
    """(port server, reference server) with the same settings."""
    return StreamServer(device="cpu", **kw), RefServer(**kw)


def _cfg(config_cls, codec):
    return config_cls(codec=codec, micro_batch_bytes=2048, lanes=4)


def _assert_reports_equal(ours, theirs):
    for k in SERVER_FIELDS:
        assert getattr(ours, k) == getattr(theirs, k), k
    assert set(ours.sessions) == set(theirs.sessions)
    for t, r in ours.sessions.items():
        q = theirs.sessions[t]
        for k in SESSION_FIELDS:
            assert getattr(r, k) == getattr(q, k), (t, k)
        assert (r.fidelity is None) == (q.fidelity is None)
        if r.fidelity is not None:
            assert (r.fidelity.bit_exact, r.fidelity.max_abs, r.fidelity.within_bound) == (
                q.fidelity.bit_exact, q.fidelity.max_abs, q.fidelity.within_bound)


def _records(server) -> dict:
    return {t: [f.key() for f in s.flushes] for t, s in server.sessions.items()}


def _mixed_feeds(n: int, k: int = 8):
    rate = rate_for_dataset(1)
    feeds = {}
    for i in range(k):
        codec, dataset = MIX[i % len(MIX)]
        vals = make_dataset(dataset, n_tuples=n).stream()[:n]
        feeds[f"{dataset}-{i}"] = (codec, vals, zipf_timestamps(n, rate, zipf_factor=0.7, seed=i))
    return feeds


@pytest.mark.parametrize("gang", [False, True])
def test_server_sustains_8_sessions_mixed_codecs_bursty(gang):
    """8 concurrent sessions, mixed codecs, zipf arrivals: every tuple
    flushed, per-session metrics for every topic, records and reports equal
    to the reference's."""
    ours, theirs = _both(max_sessions=16, gang=gang)
    feeds = _mixed_feeds(4096)
    for topic, (codec, vals, _) in feeds.items():
        ours.admit(topic, _cfg(EngineConfig, codec), sample=vals)
        theirs.admit(topic, _cfg(RefConfig, codec), sample=vals)
    run = {t: (v, ts) for t, (_, v, ts) in feeds.items()}
    rep, ref = ours.run(run), theirs.run(run)
    _assert_reports_equal(rep, ref)
    assert _records(ours) == _records(theirs)
    assert rep.n_sessions == 8 and rep.total_tuples == 8 * 4096
    assert rep.makespan_s > 0 and rep.energy_j > 0
    for r in rep.sessions.values():
        assert r.n_tuples == 4096 and r.n_flushes > 0 and r.ratio > 1.0
        assert r.throughput_mbps > 0 and r.mean_latency_s > 0 and r.energy_j > 0
    assert sum(r.energy_j for r in rep.sessions.values()) == pytest.approx(rep.energy_j)


def test_timeout_flushes_partial_batches():
    """A trickle stream never fills a batch: every flush is a timeout flush,
    no tuple is lost, records equal the reference's."""
    vals = make_dataset("micro", n_tuples=4096, dynamic_range_bits=12).stream()[:100]
    ours, theirs = _both(flush_timeout_s=0.05)
    ours.admit("trickle", _cfg(EngineConfig, "tcomp32"), sample=vals)
    theirs.admit("trickle", _cfg(RefConfig, "tcomp32"), sample=vals)
    feed = {"trickle": (vals, uniform_timestamps(100, rate_tps=10.0))}
    rep, ref = ours.run(feed), theirs.run(feed)
    _assert_reports_equal(rep, ref)
    r = rep.sessions["trickle"]
    assert r.n_tuples == 100 and r.n_timeout_flushes == r.n_flushes > 1
    assert _records(ours) == _records(theirs)


def test_admission_control_and_unknown_topic_match_reference():
    errors = []
    for server, config_cls in ((StreamServer(max_sessions=2, device="cpu"), EngineConfig),
                               (RefServer(max_sessions=2), RefConfig)):
        server.admit("a", _cfg(config_cls, "tcomp32"))
        server.admit("b", _cfg(config_cls, "tcomp32"))
        for exc, call in ((RuntimeError, lambda: server.admit("c", _cfg(config_cls, "tcomp32"))),
                          (ValueError, lambda: server.admit("a", _cfg(config_cls, "tcomp32"))),
                          (KeyError, lambda: server.run({"unknown": (np.zeros(4, np.uint32), np.zeros(4))})),
                          (ValueError, lambda: server.run({"a": (np.zeros(4, np.uint32), np.zeros(3))}))):
            with pytest.raises(exc) as ei:
                call()
            errors.append(str(ei.value))
    assert errors[:4] == errors[4:]
    assert "server full" in errors[0] and "already admitted" in errors[1]


def test_session_state_persists_across_flushes():
    """Flush N continues the codec state of flush N-1: the session's bits
    equal one pass over the concatenated stream, and the reference's."""
    vals = make_dataset("rovio", n_tuples=4096).stream()[:4096]
    ours = StreamSession("t", _cfg(EngineConfig, "tdic32"), sample=vals, flush_timeout_s=1e9, device="cpu")
    theirs = RefSession("t", _cfg(RefConfig, "tdic32"), sample=vals, flush_timeout_s=1e9)
    cap = ours.capacity
    n_batches = len(vals) // cap
    vals = vals[: n_batches * cap]
    for s in (ours, theirs):
        for i in range(n_batches):
            s.offer_many(vals[i * cap: (i + 1) * cap], np.full(cap, float(i), np.float64))
    assert [f.key() for f in ours.flushes] == [f.key() for f in theirs.flushes]
    pipe = CompressionPipeline(_cfg(EngineConfig, "tdic32"), sample=vals, device="cpu")
    res = pipe.execute(pipe.shape_blocks(vals), fused=True)
    assert sum(f.bits for f in ours.flushes) == pytest.approx(float(res.per_block_bits.sum()))


def test_timeout_flush_stamped_at_deadline_not_poll_time():
    """A session whose timer fired while another topic held the clock
    records waits up to its deadline, not up to the poll."""
    timeout = 0.05
    ours, theirs = _both(flush_timeout_s=timeout)
    feeds = {"quiet": (np.arange(8, dtype=np.uint32), np.linspace(0.0, 0.001, 8)),
             "busy": (np.arange(4096, dtype=np.uint32), np.linspace(10.0, 100.0, 4096))}
    for server, config_cls in ((ours, EngineConfig), (theirs, RefConfig)):
        server.admit("quiet", _cfg(config_cls, "tcomp32"))
        server.admit("busy", _cfg(config_cls, "tcomp32"))
    rep, ref = ours.run(feeds), theirs.run(feeds)
    _assert_reports_equal(rep, ref)
    r = rep.sessions["quiet"]
    assert r.n_tuples == 8 and r.n_timeout_flushes == r.n_flushes == 1
    assert r.mean_latency_s < 2 * timeout
    assert _records(ours) == _records(theirs)


def test_drain_uses_public_flush_deadline():
    timeout = 0.25
    server = StreamServer(flush_timeout_s=timeout, device="cpu")
    server.admit("t", _cfg(EngineConfig, "tcomp32"))
    session = server.session("t")
    rep = server.run({"t": (np.arange(8, dtype=np.uint32), np.linspace(100.0, 100.01, 8))})
    assert rep.sessions["t"].n_timeout_flushes == 1
    rec = session.flushes[0]
    assert rec.max_wait_s == pytest.approx(timeout, abs=1e-9)
    assert rec.mean_wait_s == pytest.approx(timeout - 0.005, abs=1e-6)
    assert session.flush_deadline is None
    session.offer(1, ts=5.0)
    assert session.flush_deadline == pytest.approx(5.0 + timeout)


def _run_once(feeds, order, gang, port=True):
    server = StreamServer(max_sessions=8, egress=True, gang=gang, device="cpu") if port else \
        RefServer(max_sessions=8, egress=True, gang=gang)
    for topic in order:
        codec, vals, _ = feeds[topic]
        server.admit(topic, _cfg(EngineConfig if port else RefConfig, codec), sample=vals)
    rep = server.run({t: (feeds[t][1], feeds[t][2]) for t in order})
    frames = {t: server.sessions[t].egress_frame().to_bytes() for t in feeds}
    return rep, _records(server), frames


@pytest.mark.parametrize("gang", [False, True])
def test_server_run_deterministic_across_repeats_and_feed_order(gang):
    """Same feeds => identical records and wire bytes on a repeat and with
    the admission order reversed, and equal to the reference's."""
    feeds = _mixed_feeds(2500, k=4)
    order_a = sorted(feeds)
    rep1, rec1, frames1 = _run_once(feeds, order_a, gang)
    rep2, rec2, frames2 = _run_once(feeds, order_a, gang)
    rep3, rec3, frames3 = _run_once(feeds, list(reversed(order_a)), gang)
    ref, ref_rec, ref_frames = _run_once(feeds, order_a, gang, port=False)
    assert rec1 == rec2 == rec3 == ref_rec
    assert frames1 == frames2 == frames3 == ref_frames
    assert rep1.total_output_bytes == rep3.total_output_bytes == ref.total_output_bytes
    assert any(f[4] for recs in rec1.values() for f in recs)  # timeout seen
    _assert_reports_equal(rep1, ref)


def _dispatcher_jobs(mod, kw, specs, feeds, controller=None, gang=True):
    d = mod.Dispatcher(gang=gang, **kw)
    handles = {}
    for topic, spec in specs.items():
        handles[topic] = d.open(spec, topic=topic,
                                controller=None if controller is None else controller(topic))
        handles[topic].push(*feeds[topic])
    return d, handles


def test_dispatcher_session_handles_match_reference():
    """Dispatcher-bound handles (open, open_many, iteration, close) on a
    gang dispatcher: frames, JobReports and the ServerReport equal the
    reference's."""
    rate = rate_for_dataset(1)
    n = 3000
    vals = {i: make_dataset(MIX[i % 4][1], n_tuples=n).stream()[:n] for i in range(3)}
    feeds = {f"t{i}": (vals[i], zipf_timestamps(n, rate, zipf_factor=0.7, seed=i)) for i in range(3)}
    out = []
    for mod, kw in ((tcs, dict(device="cpu")), (rcs, {})):
        d = mod.Dispatcher(gang=True, **kw)
        h0 = d.open(mod.JobSpec(codec="tdic32", egress=True), topic="t0")
        h1, h2 = d.open_many(mod.JobSpec(codec="tcomp32", egress=True, flush_tuples=1024),
                             topics=["t1", "t2"])
        auto = d.open_many(mod.JobSpec(codec="tcomp32"), count=2)
        for h, t in ((h0, "t0"), (h1, "t1"), (h2, "t2")):
            h.push(*feeds[t])
        h1.flush()
        reports = [h.close() for h in (h0, h1, h2)]
        rep = d.close()
        out.append((rep, [h.topic for h in d], [h.topic for h in auto],
                    [[f.to_bytes() for f in h.frames()] for h in (h0, h1, h2)],
                    [(r.n_tuples, r.total_bits, r.ratio, r.n_frames, r.wire_bytes) for r in reports]))
        with pytest.raises(mod.NegotiationError) as ei:
            h0.push(vals[0], feeds["t0"][1])
        out[-1] += (str(ei.value),)
    (rep, *rest), (ref, *ref_rest) = out
    _assert_reports_equal(rep, ref)
    assert rest == ref_rest


@pytest.mark.parametrize("gang", [False, True])
def test_adaptive_session_tier_history_and_sealed_frames(gang):
    """An adaptive session under a scripted schedule: the same tier history
    and sealed segment frames as the reference's. Solo flushes visit every
    rung; on the gang server one topic's feed is one replay run, so its
    flushes queue and every switch defers while snapshots are in flight,
    as in the reference."""
    schedule = ["cheap", "bypass", "heavy", "heavy", "cheap", "bypass", "cheap", "heavy"]
    rng = np.random.default_rng(4)
    n = 9000
    vals = np.clip(np.cumsum(rng.integers(-30, 31, n)) + 900, 0, None).astype(np.uint32)
    feeds = {"a": (vals, np.arange(n) * 2e-5)}
    spec_kw = dict(codec="tcomp32", egress=True, adaptive=True, flush_tuples=1024, lanes=2,
                   micro_batch_bytes=2048)
    got = []
    for mod, ctl, kw in ((tcs, tctl, dict(device="cpu")), (rcs, rctl, {})):
        plan = mod.negotiate(mod.JobSpec(**spec_kw), **kw)
        ladder = tuple(t for t, _ in plan.tiers)
        d, hs = _dispatcher_jobs(mod, kw, {"a": mod.JobSpec(**spec_kw)}, feeds,
                                 controller=lambda t: ctl.ScriptedController(ladder, schedule),
                                 gang=gang)
        rep = d.close()
        s = d.sessions["a"]
        got.append((rep.sessions["a"].tier_history, rep.sessions["a"].tier_switches,
                    [f.to_bytes() for f in hs["a"].frames()], [f.key() for f in s.flushes],
                    rep.sessions["a"].fidelity.bit_exact))
    assert got[0] == got[1]
    history, switches, frames, _, exact = got[0]
    assert exact and len(frames) == switches + 1
    assert set(history) == ({"cheap"} if gang else {"bypass", "cheap", "heavy"})


@pytest.fixture
def registries(tmp_path):
    """(reference registry, port registry) over one root, installed as the
    two packages' process defaults for the test."""
    root = str(tmp_path / "dicts")
    regs = (rds.DictRegistry(root=root), tds.DictRegistry(root=root))
    prev = (rds.set_default_registry(regs[0]), tds.set_default_registry(regs[1]))
    yield regs
    rds.set_default_registry(prev[0])
    tds.set_default_registry(prev[1])


def test_topic_latest_session_hot_swapped_on_publish(registries):
    """A `topic:latest` tdic32 session: a publish mid-stream swaps it at the
    next flush boundary; frames carry v1 then v2, equal to the reference's,
    and decode exactly."""
    rreg, treg = registries
    rng = np.random.default_rng(2)
    sample = ((rng.zipf(1.3, size=4096) - 1) % 300).astype(np.uint32) * np.uint32(1007)
    rreg.publish(rds.train_dict(sample, idx_bits=10, topic="sensor"))
    treg.publish(tds.train_dict(sample, idx_bits=10, topic="sensor"))
    n = 6000
    vals = ((rng.zipf(1.3, size=n) - 1) % 400).astype(np.uint32) * np.uint32(1007)
    ts = np.arange(n) * 1e-5
    spec_kw = dict(codec="tdic32", egress=True, dictionary="sensor:latest", flush_tuples=1024)
    got = []
    for mod, reg, dmod, kw in ((tcs, treg, tds, dict(device="cpu")), (rcs, rreg, rds, {})):
        d = mod.Dispatcher(gang=True, **kw)
        h = d.open(mod.JobSpec(**spec_kw), topic="s")
        h.push(vals[:3000], ts[:3000])
        d.run()
        reg.publish(dmod.train_dict(vals[:3000], idx_bits=10, topic="sensor"))
        h.push(vals[3000:], ts[3000:])
        rep = d.close()
        got.append(([f.dict_id for f in h.frames()], [f.to_bytes() for f in h.frames()],
                    rep.sessions["s"].dict_swaps, rep.sessions["s"].fidelity.bit_exact,
                    [f.key() for f in d.sessions["s"].flushes]))
        assert reg._subs["sensor"] == []  # close() dropped the subscription
    assert got[0] == got[1]
    assert got[0][0] == [("sensor", 1), ("sensor", 2)] and got[0][2] == 1 and got[0][3]


def test_mesh_refusals_match_reference():
    """A mesh without gang, or under one device, is refused with the
    reference's text; a mesh wider than the visible devices names their
    count where the reference names an XLA flag (the intended difference)."""
    for kw in (dict(mesh=1), dict(gang=True, mesh=0)):
        with pytest.raises(tcs.NegotiationError) as ours:
            tcs.Dispatcher(device="cpu", **kw)
        with pytest.raises(rcs.NegotiationError) as theirs:
            rcs.Dispatcher(**kw)
        assert str(ours.value) == str(theirs.value)
    for mesh in (2, 4):
        with pytest.raises(ValueError, match=f"mesh={mesh} exceeds the 1 visible device"):
            ServerCore(gang=True, mesh=mesh, device="cpu")
        with pytest.raises(tcs.NegotiationError, match="visible device"):
            tcs.Dispatcher(gang=True, mesh=mesh, device="cpu")
        with pytest.raises(rcs.NegotiationError, match="XLA_FLAGS"):
            rcs.Dispatcher(gang=True, mesh=mesh)


@pytest.mark.parametrize("slots", [1, 4])
def test_fleet_server_matches_reference_gang(slots):
    """A one-device mesh, and four CPU slots (`ElasticSession(4, profile=
    "cstream", devices=[cpu] * 4)`), give the reference's unsharded gang
    records and report (the mesh width apart)."""
    mesh = 1 if slots == 1 else ElasticSession(4, profile="cstream", devices=["cpu"] * 4)
    ours, ref = ServerCore(gang=True, mesh=mesh, device="cpu"), RefCore(gang=True)
    for srv, config_cls in ((ours, EngineConfig), (ref, RefConfig)):
        for t in ("a", "b", "c"):
            srv.admit(t, _cfg(config_cls, "tcomp32"))
    feed = {t: (np.arange(5000, dtype=np.uint32) * (i + 1), np.arange(5000) * 1e-5)
            for i, t in enumerate("abc")}
    rep, ref_rep = ours.run(feed), ref.run(feed)
    assert rep.devices == slots and ref_rep.devices == 1
    rep.devices = 1
    _assert_reports_equal(rep, ref_rep)
    assert _records(ours) == _records(ref)


def test_stream_server_shim_and_devices():
    with pytest.warns(DeprecationWarning, match="StreamServer is deprecated"):
        StreamServer(device="cpu")
    assert tcs.Dispatcher(device="cpu").devices == 1
    assert tcs.Dispatcher(device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        for call in (lambda: ServerCore(), lambda: StreamSession("t", _cfg(EngineConfig, "tcomp32"))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
