"""The deprecated `CStreamEngine` shim (`repro_torch.core.engine`) and the
planner's measured candidates (`core/planner.py` `evaluate`,
`enumerate_solutions`) against the reference's, on the CPU:
  * compress (per-block bits, total, frame bytes; `max_blocks`, the Fig 10b
    breakdown on an eager configuration), decompress, roundtrip and
    `roundtrip_nrmse`, and the shim's `gang_compress`;
  * `evaluate` / `enumerate_solutions`: the timing-free fields (ratio,
    NRMSE, the configuration) equal the reference's, never the walls;
  * `sharded_compress_fn`: over one mesh slot, words, total bits and state
    equal the reference's over its one-device mesh (private and shared);
    over 2 and 4 CPU slots, private mode equals the reference run on each
    lane group apart, and shared mode the reference's `lww_select` of the
    groups' merged tables, broadcast to every lane.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core import engine as rengine
from repro.core import pipeline as rpipe
from repro.core.algorithms import make_codec as rmake
from repro.core import planner as rplan
from repro.core import strategies as rstrat
from repro_torch.core import engine as tengine
from repro_torch.core import planner as tplan
from repro_torch.core import strategies as tstrat
from repro_torch.core.algorithms import make_codec as tmake
from repro_torch.core.algorithms import state_from_numpy
from repro_torch.data import make_dataset
from repro_torch.runtime.elastic import ElasticSession

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

#: name -> EngineConfig fields (4 lanes, 2 KiB micro-batches)
CONFIGS = {
    "tcomp32": dict(codec="tcomp32"),
    "tdic32-shared": dict(codec="tdic32", state="shared"),
    "rle": dict(codec="rle"),
    "adpcm": dict(codec="adpcm"),
    "pla": dict(codec="pla", codec_kwargs={"window": 8}),
    "eager": dict(codec="delta_leb128", execution="eager", scheduling="uniform"),
}


def _cfg(mod, name: str):
    return mod.EngineConfig(micro_batch_bytes=2048, lanes=4, **CONFIGS[name])


def _engines(name: str, sample):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (tengine.CStreamEngine(_cfg(tstrat, name), sample=sample, device="cpu"),
                rengine.CStreamEngine(_cfg(rstrat, name), sample=sample))


def _stream(n: int, seed: int = 7) -> np.ndarray:
    return make_dataset("ecg" if seed == 3 else "rovio", n_tuples=n, seed=seed).stream()[:n]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_shim_matches_reference(name):
    v = _stream(4000, seed=3 if name in ("adpcm", "pla") else 7)
    te, re_ = _engines(name, v)
    assert te.spec.to_dict() == re_.spec.to_dict()
    for kw in (dict(emit_frame=True), dict(max_blocks=1, arrival_rate_tps=1e5), dict(breakdown=True)):
        t, r = te.compress(v, **kw), re_.compress(v, **kw)
        np.testing.assert_array_equal(t.per_block_bits, r.per_block_bits)
        assert (t.total_bits, t.n_tuples, t.stats.ratio) == (r.total_bits, r.n_tuples, r.stats.ratio)
        assert (t.stats.latency_s is None) == (r.stats.latency_s is None)
        assert t.running_s <= t.stats.wall_s + 1e-9 and t.blocked_s >= 0.0
        if "emit_frame" in kw:
            assert t.frame.to_bytes() == r.frame.to_bytes()
            np.testing.assert_array_equal(te.decompress(t.frame), re_.decompress(r.frame))
    tr, rr = te.roundtrip(v), re_.roundtrip(v)
    np.testing.assert_array_equal(tr.values, rr.values)
    assert tr.wire_bytes == rr.wire_bytes
    assert (tr.fidelity.bit_exact, tr.fidelity.max_abs) == (rr.fidelity.bit_exact, rr.fidelity.max_abs)
    assert te.roundtrip_nrmse(v) == pytest.approx(re_.roundtrip_nrmse(v), abs=1e-12)
    np.testing.assert_array_equal(te._blocks(v), re_._blocks(v))
    assert te._block_tuples() == re_._block_tuples()


@pytest.mark.parametrize("name", ["tcomp32", "rle", "adpcm"])
def test_engine_shim_gang_compress_matches_reference(name):
    """The shim's gang: every member's frame equals the reference's gang
    frame and the shim's own solo frame; fewer dispatches than streams."""
    streams = [_stream(3000 + 500 * (name == "rle"), seed=3 if name == "adpcm" else 7 + k)
               for k in range(3)]
    if name == "rle":
        streams = [np.full(2 * 512 + 5, 10 + k, np.uint32) for k in range(3)]
    te, re_ = _engines(name, streams[0])
    t, r = te.gang_compress(streams, emit_frames=True), re_.gang_compress(streams, emit_frames=True)
    assert t.n_streams == r.n_streams == 3 and t.dispatches == r.dispatches
    for v, tm, rm in zip(streams, t.results, r.results):
        assert tm.frame.to_bytes() == rm.frame.to_bytes()
        assert tm.frame.to_bytes() == te.compress(v, emit_frame=True).frame.to_bytes()
        np.testing.assert_array_equal(tm.per_block_bits, rm.per_block_bits)
    with pytest.raises(ValueError, match="at least one stream"):
        te.gang_compress([])


def test_engine_shim_warns_and_needs_a_device():
    with pytest.warns(DeprecationWarning, match="CStreamEngine is deprecated"):
        tengine.CStreamEngine(_cfg(tstrat, "tcomp32"), device="cpu")
    if not torch.cuda.is_available():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tengine.CStreamEngine(_cfg(tstrat, "tcomp32"))


#: (codec, shared_state) cases of the sharded step; tdic32 at idx_bits 8
SHARDED = [("tcomp32", False), ("tdic32", False), ("tdic32", True)]


def _sharded_blocks(n_blocks: int = 3, lanes: int = 8, b: int = 64) -> np.ndarray:
    vals = _stream(n_blocks * lanes * b, seed=11)
    return np.ascontiguousarray(vals[: n_blocks * lanes * b], np.uint32).reshape(n_blocks, lanes, b)


def _ref_np(state):
    return None if state is None else {k: np.asarray(v) for k, v in state.items()}


def _assert_state(codec, ours, ref_np):
    want = state_from_numpy(codec, ref_np, torch.device("cpu"))
    assert (ours is None) == (want is None)
    for k in want or {}:
        assert torch.equal(ours[k], want[k]), k


def _kw(codec: str) -> dict:
    return {"idx_bits": 8} if codec == "tdic32" else {}


@pytest.mark.parametrize("codec,shared", SHARDED)
def test_sharded_compress_fn_one_slot_matches_reference(codec, shared):
    """One mesh slot against the reference over its one-device mesh, three
    blocks with the state carried: words, total bits and state equal."""
    ours = tengine.sharded_compress_fn(
        codec, ElasticSession(1, profile="cstream", device="cpu").mesh, shared_state=shared, **_kw(codec))
    theirs = rengine.sharded_compress_fn(
        codec, compat.make_mesh((1,), ("data",)), shared_state=shared, **_kw(codec))
    tc = tmake(codec, **_kw(codec))
    ts, rs = tc.init_state(8, torch.device("cpu")), rmake(codec, **_kw(codec)).init_state(8)
    for blk in _sharded_blocks():
        rs, rw, rtb = theirs(rs, jnp.asarray(blk))
        ts, tw, ttb = ours(ts, torch.from_numpy(blk.view(np.int32)))
        np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(rw))
        assert int(ttb) == int(rtb)
        _assert_state(tc, ts, _ref_np(rs))


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("codec,shared", SHARDED)
def test_sharded_compress_fn_over_slots(codec, shared, slots):
    """2 and 4 CPU slots over 8 lanes: each slot's words are the reference's
    over that slot's lane group, the total bits their sum; the state is the
    groups' states in slot order (private) or, shared, the reference's
    `lww_select` over the groups' merged rows with the newest clock, on
    every lane."""
    mesh = ElasticSession(slots, profile="cstream", devices=["cpu"] * slots).mesh
    ours = tengine.sharded_compress_fn(codec, mesh, shared_state=shared, **_kw(codec))
    theirs = rengine.sharded_compress_fn(
        codec, compat.make_mesh((1,), ("data",)), shared_state=shared, **_kw(codec))
    tc, rc = tmake(codec, **_kw(codec)), rmake(codec, **_kw(codec))
    local = 8 // slots
    ts = tc.init_state(8, torch.device("cpu"))
    groups = [rc.init_state(local) for _ in range(slots)]
    for blk in _sharded_blocks():
        outs = [theirs(groups[g], jnp.asarray(blk[g * local:(g + 1) * local])) for g in range(slots)]
        ts, tw, ttb = ours(ts, torch.from_numpy(blk.view(np.int32)))
        np.testing.assert_array_equal(
            tw.numpy().view(np.uint32), np.concatenate([np.asarray(w) for _, w, _ in outs]))
        assert int(ttb) == sum(int(tb) for _, _, tb in outs)
        states = [_ref_np(st) for st, _, _ in outs]
        if shared:
            table, valid, tss = rpipe.lww_select(*(
                jnp.stack([st[k][0] for st in states]) for k in ("table", "valid", "ts")))
            clock = max(int(st["clock"][0]) for st in states)
            merged = {"table": np.asarray(table), "valid": np.asarray(valid), "ts": np.asarray(tss)}
            groups = [{**{k: np.broadcast_to(v, (local, v.shape[-1])) for k, v in merged.items()},
                       "clock": np.full(local, clock, np.int32)} for _ in range(slots)]
        else:
            groups = states
        want = None if groups[0] is None else {
            k: np.concatenate([g[k] for g in groups]) for k in groups[0]}
        _assert_state(tc, ts, want)


def test_sharded_compress_fn_refuses_other_axes():
    """An lm mesh whose model axis is one wide splits lanes like the data
    axis alone; a split over another axis, or lanes that do not divide the
    slots, is refused."""
    blk = torch.from_numpy(_sharded_blocks(1)[0].view(np.int32))
    lm = ElasticSession(1, profile="lm", device="cpu").mesh
    one = ElasticSession(1, profile="cstream", device="cpu").mesh
    (_, w_lm, tb_lm), (_, w_one, tb_one) = (tengine.sharded_compress_fn("tcomp32", m)(None, blk)
                                            for m in (lm, one))
    assert torch.equal(w_lm, w_one) and int(tb_lm) == int(tb_one)
    wide = ElasticSession(2, profile="cstream", devices=["cpu"] * 2).mesh
    with pytest.raises(ValueError, match="must have no other axis"):
        tengine.sharded_compress_fn("tcomp32", wide, axis="model")
    with pytest.raises(ValueError, match="do not split"):
        tengine.sharded_compress_fn("tcomp32", wide)(None, torch.zeros((3, 8), dtype=torch.int32))


def _point(p) -> tuple:
    return (dataclasses.asdict(p.config), p.ratio, round(p.nrmse, 12))


@pytest.mark.parametrize("name", ["tcomp32", "adpcm", "pla"])
def test_planner_evaluate_matches_reference(name):
    v = _stream(20_000, seed=3 if name in ("adpcm", "pla") else 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        t = tplan.evaluate(_cfg(tstrat, name), v, 1e5, max_blocks=4, device="cpu")
        r = rplan.evaluate(_cfg(rstrat, name), v, 1e5, max_blocks=4)
    assert _point(t) == _point(r)
    assert t.throughput_mbps > 0 and t.latency_s > 0 and t.energy_j_per_mb > 0


def test_enumerate_solutions_matches_reference():
    """Three candidates (one the codec refuses, skipped on both sides): the
    same points in the same order, and `choose` picks the same one."""
    v = _stream(20_000, seed=3)
    cands = [{"codec": "pla", "codec_kwargs": {"window": 16}}, {"codec": "tcomp32"},
             {"codec": "pla", "codec_kwargs": {"window": 1}}, {"codec": "uanuq", "codec_kwargs": {"qbits": 12}}]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        t = tplan.enumerate_solutions(v, 1e5, tplan.Constraints(), candidates=cands, device="cpu")
        r = rplan.enumerate_solutions(v, 1e5, rplan.Constraints(), candidates=cands)
    assert [_point(p) for p in t] == [_point(p) for p in r]
    assert len(t) == 3
    assert tplan.DEFAULT_CANDIDATES == rplan.DEFAULT_CANDIDATES
    c = tplan.Constraints(min_ratio=1.5, max_nrmse=0.05)
    rc = rplan.Constraints(min_ratio=1.5, max_nrmse=0.05)
    tb, rb = tplan.choose(t, c, priority=("ratio",)), rplan.choose(r, rc, priority=("ratio",))
    assert (tb is None) == (rb is None) and (tb is None or _point(tb) == _point(rb))
