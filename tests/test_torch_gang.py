"""The port's gang execution (`CompressionPipeline.execute_gang`/
`gang_step`, `cstream.gang_compress`, `negotiate_gang`, the server's gang
dispatcher) against the reference's, on the CPU. The port folds S members'
states into S*L lanes where the reference vmaps over a session axis; what
must not change is anything observable but the launch count:
  * gang waves: flush records (up to measured cost), egress frames and
    fidelity equal solo sessions' and the reference's, stateful codecs and
    bursty timeout pads included; fewer dispatches, as many as the
    reference's; signatures keyed on codec, params and geometry, equal to
    the reference's; the backpressure budget and `max_gang`;
  * `gang_compress`: per-member frames and `per_block_bits` equal the
    reference's and the port's solo runs, for tcomp32, tdic32 private and
    shared (the merge stays inside each session), adpcm calibrated and rle
    (stateful, flush block), over full blocks and a ragged tail, with the
    compacted and the legacy egress;
  * the geometry and `negotiate_gang` refusals with the reference's text;
  * the arrival traces of `data/stream.py`, equal to the reference's.
"""
import warnings

import numpy as np
import pytest
import torch

from repro import cstream as rcs
from repro.core.pipeline import CompressionPipeline as RefPipe
from repro.core.strategies import EngineConfig as RefConfig
from repro.data import stream as rstream
from repro.runtime.server import StreamServer as RefServer
from repro_torch import cstream as tcs
from repro_torch.core.pipeline import CompressionPipeline, merge_shared_dictionary
from repro_torch.core.strategies import EngineConfig
from repro_torch.data import make_dataset
from repro_torch.data import stream as tstream
from repro_torch.runtime.elastic import ElasticSession
from repro_torch.runtime.server import StreamServer

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

#: stateful codecs (rle: carried runs, stream-scope decode; adpcm: predictor
#: replay) ride next to stateless ones: the scatter must keep each straight
MIX = [("tcomp32", "micro"), ("rle", "sensor"), ("adpcm", "ecg"), ("tdic32", "rovio")]


@pytest.fixture(autouse=True)
def _no_shim_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _cfg(config_cls, codec, **kw):
    return config_cls(**{**dict(codec=codec, micro_batch_bytes=2048, lanes=4), **kw})


def _server(port: bool, **kw):
    return StreamServer(device="cpu", **kw) if port else RefServer(**kw)


def _run_mixed_server(port: bool, gang: bool, n_sessions: int = 8, n: int = 3000):
    rate = rstream.rate_for_dataset(1)
    server = _server(port, max_sessions=16, egress=True, gang=gang)
    config_cls = EngineConfig if port else RefConfig
    feeds = {}
    for i in range(n_sessions):
        codec, ds = MIX[i % len(MIX)]
        vals = make_dataset(ds, n_tuples=n).stream()[:n]
        topic = f"{codec}-{i}"
        server.admit(topic, _cfg(config_cls, codec), sample=vals)
        feeds[topic] = (vals, rstream.zipf_timestamps(n, rate, zipf_factor=0.7, seed=i))
    return server, server.run(feeds)


@pytest.fixture(scope="module")
def mixed():
    """(port solo, port gang, reference gang) servers over the MIX feeds."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return {key: _run_mixed_server(port, gang)
                for key, port, gang in (("solo", True, False), ("gang", True, True), ("ref", False, True))}


def test_gang_bit_identical_to_solo_sessions_and_reference(mixed):
    (solo, solo_rep), (gang, gang_rep), (ref, ref_rep) = mixed["solo"], mixed["gang"], mixed["ref"]
    assert solo_rep.total_tuples == gang_rep.total_tuples == ref_rep.total_tuples
    some_timeout = False
    for topic in solo.sessions:
        a, b, r = solo.sessions[topic], gang.sessions[topic], ref.sessions[topic]
        keys = [f.key() for f in b.flushes]
        assert keys == [f.key() for f in a.flushes] == [f.key() for f in r.flushes], topic
        some_timeout |= any(f.timeout for f in a.flushes)
        wire = b.egress_frame().to_bytes()
        assert wire == a.egress_frame().to_bytes() == r.egress_frame().to_bytes(), topic
        fa, fb = a.egress_fidelity()[0], b.egress_fidelity()[0]
        assert (fa.bit_exact, fa.max_abs) == (fb.bit_exact, fb.max_abs), topic
        assert fb.within_bound, topic
    assert some_timeout
    assert gang_rep.n_dispatches < solo_rep.n_dispatches
    assert gang_rep.n_dispatches == ref_rep.n_dispatches


def test_gang_dispatch_stats_match_reference(mixed):
    (_, gang_rep), (_, ref_rep) = mixed["gang"], mixed["ref"]
    assert {k: (v.n_sessions, v.n_waves, v.n_solo, v.sessions_dispatched, v.max_wave, v.padded_slots)
            for k, v in gang_rep.dispatch_stats.items()} == {
        k: (v.n_sessions, v.n_waves, v.n_solo, v.sessions_dispatched, v.max_wave, v.padded_slots)
        for k, v in ref_rep.dispatch_stats.items()}
    for k, v in gang_rep.dispatch_stats.items():
        assert v.mean_wave == ref_rep.dispatch_stats[k].mean_wave and v.occupancy == 1.0
    assert gang_rep.devices == 1 and gang_rep.fault_events == []


@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
def test_gang_quarter_dispatches_same_codec(port):
    """8 same-codec sessions with aligned arrivals: the gang issues <= 1/4
    the launches of per-session flushing, and as many as the reference."""
    n, rate = 4096, rstream.rate_for_dataset(1)
    config_cls = EngineConfig if port else RefConfig

    def run(gang):
        server = _server(port, max_sessions=16, gang=gang)
        feeds = {}
        for i in range(8):
            vals = make_dataset("micro", n_tuples=n).stream()[:n]
            server.admit(f"s{i}", _cfg(config_cls, "tcomp32"), sample=vals)
            feeds[f"s{i}"] = (vals, rstream.uniform_timestamps(n, rate))
        return server.run(feeds)

    solo, gang = run(False), run(True)
    assert solo.total_tuples == gang.total_tuples == 8 * n
    assert 1 <= gang.n_dispatches <= solo.n_dispatches / 4
    assert (solo.n_dispatches, gang.n_dispatches) == (64, 8)


def test_gang_signatures_key_on_codec_and_geometry():
    """Sessions gang only with matching codec, params, geometry and dtype;
    each signature equals the reference's for the same configuration."""
    cases = {
        "a": ("tcomp32", {}, 0), "b": ("tcomp32", {}, 0), "c": ("tdic32", {}, 0),
        "d": ("pla", dict(codec_kwargs=dict(eps=4.0), calibrate=False), 0),
        "e": ("pla", dict(codec_kwargs=dict(eps=8.0), calibrate=False), 0),
        "f": ("tcomp32", {}, 1024),
    }
    sig = {}
    for name, (codec, kw, flush) in cases.items():
        ours = StreamServer(gang=True, device="cpu").admit(name, _cfg(EngineConfig, codec, **kw), flush_tuples=flush)
        theirs = RefServer(gang=True).admit(name, _cfg(RefConfig, codec, **kw), flush_tuples=flush)
        assert ours.signature == theirs.signature, name
        sig[name] = ours.signature
    assert sig["a"] == sig["b"]
    assert len({sig[k] for k in "acdef"}) == 5


def test_gang_backpressure_budget_forces_dispatch():
    """A signature queue that reaches its admission budget dispatches at
    once, without waiting for the quantum edge."""
    server = StreamServer(gang=True, gang_budget=2, flush_timeout_s=1e9, device="cpu")
    sessions = [server.admit(f"s{i}", _cfg(EngineConfig, "tcomp32")) for i in range(3)]
    cap = sessions[0].capacity
    for i, s in enumerate(sessions[:2]):
        s.offer_many(np.arange(cap, dtype=np.uint32), np.full(cap, 0.001 * i, np.float64))
    assert [len(s.flushes) for s in sessions] == [1, 1, 0]
    assert all(not q for q in server._queues.values())


def test_gang_max_cap_splits_waves():
    """max_gang=2 on 4 concurrent same-signature flushes yields 2 waves."""
    server = StreamServer(gang=True, max_gang=2, gang_budget=10**9, flush_timeout_s=1e9, device="cpu")
    sessions = [server.admit(f"s{i}", _cfg(EngineConfig, "tcomp32")) for i in range(4)]
    cap = sessions[0].capacity
    d0 = sum(s.pipeline.dispatches for s in sessions)
    for s in sessions:
        s.offer_many(np.arange(cap, dtype=np.uint32), np.zeros(cap, np.float64))
    server._dispatch_all()
    assert all(len(s.flushes) == 1 for s in sessions)
    assert sum(s.pipeline.dispatches for s in sessions) - d0 == 2
    (stats,) = server.report().dispatch_stats.values()
    assert (stats.n_waves, stats.max_wave, stats.sessions_dispatched) == (2, 2, 4)


def _gang_streams(name: str, bt: int):
    rng = np.random.default_rng(7)
    if name == "rle":  # constant runs: the payload is mostly the flush mini-block
        return [np.repeat(rng.integers(0, 50, 12).astype(np.uint32), (2 * bt + 5) // 12 + 1)[: 2 * bt + 5]
                for _ in range(3)]
    walk = np.cumsum(rng.integers(-8, 9, (3, 3 * bt + 77)), axis=1) + 4096
    return [np.clip(w, 0, 65535).astype(np.uint32) % 3001 for w in walk]


#: name -> JobSpec fields (4 lanes, 2 KiB micro-batches, chunks of 2 blocks)
GANG_SPECS = {
    "tcomp32": dict(codec="tcomp32"),
    "tdic32": dict(codec="tdic32", params={"idx_bits": 8}),
    "tdic32-shared": dict(codec="tdic32", state="shared", params={"idx_bits": 8}),
    "adpcm": dict(codec="adpcm"),
    "rle": dict(codec="rle"),
}


@pytest.mark.parametrize("name", sorted(GANG_SPECS))
def test_gang_compress_matches_reference_and_solo(name):
    geom = dict(lanes=4, micro_batch_bytes=2048, scan_chunk=2)
    spec_t = tcs.JobSpec(**GANG_SPECS[name], **geom)
    streams = _gang_streams(name, CompressionPipeline(spec_t, device="cpu").block_tuples)
    sample = streams[0] if name == "adpcm" else None
    ours = tcs.gang_compress(spec_t, streams, sample=sample, emit_frames=True, device="cpu")
    theirs = rcs.gang_compress(rcs.JobSpec(**GANG_SPECS[name], **geom), streams, sample=sample,
                               emit_frames=True)
    assert (ours.n_streams, ours.dispatches) == (theirs.n_streams, theirs.dispatches)
    spec = spec_t if sample is None else spec_t.calibrated(sample)
    plan = tcs.negotiate(spec, device="cpu")
    solo = CompressionPipeline(plan.spec, codec=plan.codec, plan=plan.execution, device="cpu")
    legacy = tcs.run_gang_compress(solo, plan.spec, streams, emit_frames=True, compact=False)
    for v, t, r, lg in zip(streams, ours.results, theirs.results, legacy.results):
        wire = t.frame.to_bytes()
        assert wire == r.frame.to_bytes() == lg.frame.to_bytes()
        assert wire == solo.compress_to_frame(v).to_bytes()
        np.testing.assert_array_equal(t.per_block_bits, r.per_block_bits)
        np.testing.assert_array_equal(t.per_block_bits, lg.per_block_bits)
        assert (t.total_bits, t.n_tuples, t.stats.ratio) == (r.total_bits, r.n_tuples, r.stats.ratio)
    assert ours.wall_s > 0 and ours.makespan_s > 0 and ours.energy_j > 0


def test_execute_gang_states_scatter_per_member():
    """A folded state unstacks into each member's solo state (tdic32 shared:
    the merge never mixes two members' tables), and `gang_step` over a
    three-slot mesh gives the unsharded step's outputs."""
    spec = tcs.JobSpec(codec="tdic32", state="shared", params={"idx_bits": 8}, lanes=4, micro_batch_bytes=2048)
    pipe = CompressionPipeline(spec, device="cpu")
    streams = _gang_streams("tdic32", pipe.block_tuples)
    shaped = [pipe.shape_blocks(v) for v in streams]
    results, _ = pipe.execute_gang(shaped)
    for sh, res in zip(shaped, results):
        solo = pipe.execute(sh)
        for k in solo.state:
            assert np.array_equal(solo.state[k].numpy(), res.state[k].numpy()), k
        np.testing.assert_array_equal(solo.per_block_bits, res.per_block_bits)
    folded = pipe.stack_states([r.state for r in results])
    merged = merge_shared_dictionary(folded, lanes=spec.lanes)
    for i, res in enumerate(results):
        assert all(np.array_equal(pipe.unstack_state(merged, i)[k].numpy(), res.state[k].numpy())
                   for k in res.state)
    assert CompressionPipeline.stack_states([None, None]) is None and pipe.unstack_state(None, 1) is None
    blocks = torch.from_numpy(np.stack([sh.blocks[0] for sh in shaped]).view(np.int32))
    masks = torch.ones(blocks.shape, dtype=torch.bool)
    mesh = ElasticSession(3, profile="cstream", devices=["cpu"] * 3).mesh
    plain, sharded = (pipe.gang_step(folded, blocks, masks, mesh=m) for m in (None, mesh))
    assert all(torch.equal(plain[0][k], sharded[0][k]) for k in plain[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[1:4], sharded[1:4]))


def test_execute_gang_rejects_mismatched_geometry():
    msgs = []
    for pipe in (CompressionPipeline(_cfg(EngineConfig, "tcomp32"), device="cpu"),
                 RefPipe(_cfg(RefConfig, "tcomp32"))):
        bt = pipe.block_tuples
        a = pipe.shape_blocks(np.arange(2 * bt, dtype=np.uint32))
        b = pipe.shape_blocks(np.arange(3 * bt + 5, dtype=np.uint32))
        with pytest.raises(ValueError, match="block geometry") as ei:
            pipe.execute_gang([a, b])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert CompressionPipeline(_cfg(EngineConfig, "tcomp32"), device="cpu").execute_gang([]) == ([], 0.0)


@pytest.mark.parametrize("specs", [
    [dict(codec="tcomp32"), dict(codec="tdic32")],
    [dict(codec="pla", params={"eps": 4.0}), dict(codec="pla", params={"eps": 8.0})],
    [dict(codec="tcomp32"), dict(codec="tcomp32", flush_tuples=1024)],
    [dict(codec="leb128"), dict(codec="leb128", lanes=2)],
    [],
], ids=["codec", "params", "capacity", "lanes", "empty"])
def test_negotiate_gang_refusals_match_reference(specs):
    with pytest.raises(tcs.NegotiationError) as ours:
        tcs.negotiate_gang([tcs.JobSpec(**s) for s in specs], device="cpu")
    with pytest.raises(rcs.NegotiationError) as theirs:
        rcs.negotiate_gang([rcs.JobSpec(**s) for s in specs])
    assert str(ours.value) == str(theirs.value)
    assert "\n" not in str(ours.value)


def test_negotiate_gang_and_open_gang_match_reference():
    specs = [dict(codec="tcomp32", egress=True), dict(codec="tcomp32", egress=True, flush_timeout_s=0.5)]
    ours = tcs.negotiate_gang([tcs.JobSpec(**s) for s in specs], device="cpu")
    theirs = rcs.negotiate_gang([rcs.JobSpec(**s) for s in specs])
    assert [p.signature for p in ours] == [p.signature for p in theirs]
    assert all(p.spec.gang for p in ours)
    v = np.arange(3000, dtype=np.uint32) % 97
    ts = np.arange(3000) * 1e-4
    got = []
    for mod, kw in ((tcs, dict(device="cpu")), (rcs, {})):
        d = mod.Dispatcher(gang=True, **kw)
        hs = d.open_gang([mod.JobSpec(**s) for s in specs], topics=["a", "b"])
        for h in hs:
            h.push(v, ts)
        rep = d.close()
        got.append(([h.topic for h in d], [f.to_bytes() for h in hs for f in h.frames()],
                    {t: r.n_flushes for t, r in rep.sessions.items()}))
        for bad in (lambda: d.open_gang(specs=[mod.JobSpec()], topics=["x", "y"]),
                    lambda: d.open_gang([mod.JobSpec()], samples=[None, None]),
                    lambda: mod.Dispatcher(**kw).open_gang([mod.JobSpec()])):
            with pytest.raises(mod.NegotiationError) as ei:
                bad()
            got[-1] += (str(ei.value),)
    assert got[0] == got[1]


@pytest.mark.parametrize("n,rate,zipf,seed", [(1000, 4e6, 0.0, 3), (5000, 4e6, 0.7, 0), (777, 1e3, 1.0, 9)])
def test_arrival_traces_match_reference(n, rate, zipf, seed):
    np.testing.assert_array_equal(tstream.zipf_timestamps(n, rate, zipf, seed=seed),
                                  rstream.zipf_timestamps(n, rate, zipf, seed=seed))
    np.testing.assert_array_equal(tstream.uniform_timestamps(n, rate), rstream.uniform_timestamps(n, rate))
    assert tstream.rate_for_dataset(3) == rstream.rate_for_dataset(3)
    assert tstream.PAPER_ARRIVAL_BYTES_PER_S == rstream.PAPER_ARRIVAL_BYTES_PER_S
