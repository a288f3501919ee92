"""The port's adaptive tier ladder (`repro_torch.core.controller`,
`core/planner.py`) against the reference's, on the CPU. Decisions are
modeled, never timed, so they must match the reference's exactly:
  * `resolve_ladder` (rungs and refusal texts), `tier_point`, `choose` and
    `choose_tier`, `probe_bits_from_wire`, and a controller's decision log;
  * an `AdaptiveController` handle's `tier_log` over a drifting stream;
  * the tier-switch frames of a `ScriptedController` schedule, byte-identical
    and decoding across both ways.
"""
import dataclasses

import numpy as np
import pytest

from repro import cstream as rcs
from repro.core import controller as rctl
from repro.core import planner as rplan
from repro.core.pipeline import DecompressionPipeline as RefDecompression
from repro_torch import cstream as tcs
from repro_torch.core import controller as tctl
from repro_torch.core import planner as tplan
from repro_torch.core.algorithms import WIRE_CODEC_NAMES
from repro_torch.core.energy import PROFILES
from repro_torch.core.pipeline import DecompressionPipeline

GEOM = dict(lanes=2, micro_batch_bytes=1024)
PROBE = {"cheap": 10.7, "heavy": 6.0}


def _point(p) -> dict:
    return dataclasses.asdict(p)


@pytest.mark.parametrize("kw", [
    {}, dict(cheap="tcomp32"), dict(cheap="rle", heavy="tdic32", heavy_entropy="none"),
    dict(cheap="nope"), dict(cheap="pla"), dict(heavy_entropy="huff"),
], ids=["default", "tcomp32", "rle_tdic32", "unregistered", "lossy", "entropy"])
def test_resolve_ladder_matches_reference(kw):
    try:
        want = rctl.resolve_ladder(**kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as ours:
            tctl.resolve_ladder(**kw)
        assert str(ours.value) == str(exc)
        return
    assert [dataclasses.asdict(t) for t in tctl.resolve_ladder(**kw)] == [
        dataclasses.asdict(t) for t in want]


def test_tier_points_and_choice_match_reference():
    """Every rung priced over payload bits x bandwidth x profile, and the
    pick over each ladder with and without an incumbent."""
    for profile in sorted(PROFILES):
        for bits_per_tuple in (0.5, 6.0, 14.3, 32.0, 40.0):
            for bw in (1.0, 3.0, 3.5, 20.0, 60.0, 65.0, 150.0):
                tp = [tctl.tier_point(t, bits_per_tuple, bw, profile) for t in tctl.DEFAULT_LADDER]
                rp = [rctl.tier_point(t, bits_per_tuple, bw, profile) for t in rctl.DEFAULT_LADDER]
                assert [_point(p) for p in tp] == [_point(p) for p in rp]
                for inc in (None, 0, 2):
                    t_best = tplan.choose_tier(tp, None if inc is None else tp[inc])
                    r_best = rplan.choose_tier(rp, None if inc is None else rp[inc])
                    assert _point(t_best) == _point(r_best)
                c = tplan.Constraints(min_ratio=1.5, profile=profile)
                r_pick = rplan.choose(rp, rplan.Constraints(min_ratio=1.5, profile=profile))
                t_pick = tplan.choose(tp, c)
                assert (t_pick is None) == (r_pick is None)
                assert t_pick is None or _point(t_pick) == _point(r_pick)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tplan.evaluate(tp[0].config, np.zeros(8, np.uint32), 1e5)


def _decision_log(mod, seed: int):
    rng = np.random.default_rng(seed)
    ctl = mod.AdaptiveController(probe_bits=PROBE, link=mod.ModeledLink([2.0, 30.0, 90.0]))
    for _ in range(12):
        tier = ctl.decide(bandwidth_mbps=None if rng.random() < 0.3 else float(rng.uniform(1, 80)))
        n = int(rng.integers(100, 2000))
        ctl.observe(tier.name, n, int(rng.integers(4, 40)) * n,
                    bandwidth_mbps=float(rng.uniform(1, 80)))
    return [dataclasses.astuple(d) for d in ctl.decisions], ctl.switches


@pytest.mark.parametrize("seed", [7, 11])
def test_decision_log_matches_reference(seed):
    assert _decision_log(tctl, seed) == _decision_log(rctl, seed)
    wire = {"bypass": 9000, "cheap": 4000, "heavy": 2500}
    assert tctl.probe_bits_from_wire(wire, 2000) == rctl.probe_bits_from_wire(wire, 2000)


def _drifting_segments():
    """Compressible walks, then full-range noise, then walks again."""
    rng = np.random.default_rng(3)
    walk = lambda n: np.clip(np.cumsum(rng.integers(-20, 21, n)) + 500, 0, None).astype(np.uint32)
    noise = lambda n: rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return [walk(600), walk(600), noise(600), noise(600), noise(600), walk(600), walk(512)]


def _decode_across(t_frames, r_frames, segs):
    """Each side's frames decode under the other's pipeline of the frame's
    own codec (tier switches need no coordination)."""
    for tf, rf, seg in zip(t_frames, r_frames, segs):
        name = WIRE_CODEC_NAMES[tf.codec_id]
        ours = DecompressionPipeline(tcs.JobSpec(codec=name, **GEOM), device="cpu")
        theirs = RefDecompression(rcs.JobSpec(codec=name, **GEOM))
        np.testing.assert_array_equal(ours.ingest(rf.to_bytes()).values, seg)
        np.testing.assert_array_equal(theirs.ingest(tf.to_bytes()).values, seg)


def _run_both(kw, make_controller):
    rspec, tspec = rcs.JobSpec(**kw, **GEOM), tcs.JobSpec(**kw, **GEOM)
    rplan_, tplan_ = rcs.negotiate(rspec), tcs.negotiate(tspec, device="cpu")
    rh = rcs.open(rspec, controller=make_controller(rctl, tuple(t for t, _ in rplan_.tiers)))
    th = tcs.open(tspec, controller=make_controller(tctl, tuple(t for t, _ in tplan_.tiers)),
                  device="cpu")
    segs = _drifting_segments()
    for seg in segs:
        rh.push(seg)
        rh.flush()
        th.push(seg)
        th.flush()
    return rh, th, segs


def test_adaptive_tier_log_matches_reference_over_drift():
    rh, th, segs = _run_both(
        dict(codec="tcomp32", egress=True, adaptive=True),
        lambda mod, ladder: mod.AdaptiveController(ladder=ladder, link=mod.ModeledLink(
            [2.0, 2.0, 20.0, 20.0, 20.0, 70.0, 70.0])),
    )
    assert th.tier_log == rh.tier_log
    assert len(set(th.tier_log)) == 3  # the drift visits every rung
    t_frames, r_frames = th.frames(), rh.frames()
    assert [f.to_bytes() for f in t_frames] == [f.to_bytes() for f in r_frames]
    rep_t, rep_r = th.close(), rh.close()
    assert (rep_t.total_bits, rep_t.wire_bytes, rep_t.n_frames) == (rep_r.total_bits, rep_r.wire_bytes,
                                                                     rep_r.n_frames)


@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_scripted_tier_switch_frames_byte_identical(integrity):
    schedule = ["bypass", "cheap", "heavy", "cheap", "heavy", "bypass", "heavy"]
    rh, th, segs = _run_both(
        dict(codec="leb128", egress=True, adaptive=True, integrity=integrity),
        lambda mod, ladder: mod.ScriptedController(ladder, schedule),
    )
    assert th.tier_log == rh.tier_log == schedule
    want = {"bypass": "raw32", "cheap": "leb128", "heavy": "delta_leb128"}
    t_frames, r_frames = th.frames(), rh.frames()
    assert [WIRE_CODEC_NAMES[f.codec_id] for f in t_frames] == [want[t] for t in schedule]
    assert [f.entropy is not None for f in t_frames] == [t == "heavy" for t in schedule]
    assert [f.to_bytes() for f in t_frames] == [f.to_bytes() for f in r_frames]
    _decode_across(t_frames, r_frames, segs)
