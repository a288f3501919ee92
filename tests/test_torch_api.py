"""The port's job API (`repro_torch.cstream`) against the reference's
(`repro.cstream`), on the CPU:
  * `negotiate` over a grid of specs: equal `Plan` fields (`cap`,
    `execution`, `gang`, `fleet`, `align`, `capacity`, `notes`, `entropy`,
    `integrity`, `dictionary`, each rung of `tiers`, the signature element
    by element), or the same `NegotiationError` text; and `devices >= 1`
    (`DEVICE_SPECS`): the fleet plan, or the reference's text. The intended
    difference is listed in `PORT_ONLY`: `devices` past the visible devices
    names their count (the reference counts jax devices and names an XLA
    flag);
  * `capabilities()` record for record;
  * `JobSpec.from_engine_config` on the paper's three configurations;
  * offline and dispatcher-bound handles: frames byte-identical and
    `JobReport` equal, and what `open` refuses with the reference's text.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import cstream as rcs
from repro.configs import cstream_edge as redge
from repro.core import dictstore as rds
from repro_torch import api
from repro_torch import cstream as tcs
from repro_torch.configs import cstream_edge as tedge
from repro_torch.core import dictstore as tds
from repro_torch.core.pipeline import dispatch_signature

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

GEOM = dict(lanes=2, micro_batch_bytes=1024)

#: spec fields -> negotiation outcome, for both packages
SPECS = {
    "default": {},
    "every_rle": dict(codec="rle", micro_batch_bytes=2048),
    "pla": dict(codec="pla", micro_batch_bytes=2048),
    "uanuq_budget": dict(codec="uanuq", max_abs_error=1e9),
    "tdic32_shared": dict(codec="tdic32", state="shared"),
    "tcomp32_shared_note": dict(codec="tcomp32", state="shared"),
    "rans_crc": dict(codec="delta_leb128", egress=True, entropy="rans", integrity="crc32c"),
    "gang": dict(codec="leb128", gang=True, flush_tuples=3000),
    "eager": dict(codec="adpcm", execution="eager", scheduling="uniform"),
    "unknown_codec": dict(codec="zstd"),
    "unknown_param": dict(codec="tcomp32", params={"no_such_param": 1}),
    "bad_params": dict(codec="pla", params={"window": 2}),
    "unknown_profile": dict(profile="pdp11"),
    "eager_scan_chunk": dict(execution="eager", scan_chunk=8),
    "strict_masking": dict(codec="tdic32", strict_masking=True),
    "entropy_needs_egress": dict(entropy="rans"),
    "integrity_needs_egress": dict(integrity="crc32c"),
    "no_error_bound": dict(codec="adpcm", max_abs_error=1.0),
    "bound_over_budget": dict(codec="pla", max_abs_error=0.0),
    "devices_need_gang": dict(devices=2),
    "dict_not_dictionary_codec": dict(codec="tcomp32", dictionary="sensor"),
    "dict_unknown_topic": dict(codec="tdic32", dictionary="nope"),
    "dict_unknown_version": dict(codec="tdic32", dictionary="sensor:v9"),
    "dict_idx_bits": dict(codec="tdic32", dictionary="sensor", params={"idx_bits": 9}),
    "dict_latest": dict(codec="tdic32", dictionary="sensor:latest", egress=True),
    "dict_pinned": dict(codec="tdic32", dictionary="sensor:v1", state="shared"),
    "adaptive": dict(codec="tcomp32", adaptive=True, egress=True),
    "adaptive_leb128_crc": dict(codec="leb128", adaptive=True, egress=True, integrity="crc32c"),
    "adaptive_needs_egress": dict(adaptive=True),
    "adaptive_owns_entropy": dict(adaptive=True, egress=True, entropy="rans"),
    "adaptive_lossy_cheap": dict(codec="adpcm", adaptive=True, egress=True),
    "adaptive_capacity": dict(codec="pla", adaptive=True, egress=True, micro_batch_bytes=1000),
}
#: device-mesh specs (one device is visible to both packages here)
DEVICE_SPECS = {
    "devices_one": dict(devices=1, gang=True),
    "devices_two": dict(devices=2, gang=True),
    "adaptive_devices": dict(adaptive=True, egress=True, devices=1),
}
#: the intended differences: spec -> what the port's refusal names, and the
#: reference's
PORT_ONLY = {
    "devices_two": ("exceeds the 1 visible device\\(s\\) of type cpu", "XLA_FLAGS"),
}


@pytest.fixture(scope="module")
def registries():
    """One published dictionary "sensor" (idx_bits 8) in both packages'
    default registries, restored after the module."""
    sample = (np.arange(4000, dtype=np.uint32) % 300) * np.uint32(1007)
    regs = (rds.DictRegistry(), tds.DictRegistry())
    regs[0].publish(rds.train_dict(sample, idx_bits=8, topic="sensor"))
    regs[1].publish(tds.train_dict(sample, idx_bits=8, topic="sensor"))
    prev = (rds.set_default_registry(regs[0]), tds.set_default_registry(regs[1]))
    yield regs
    rds.set_default_registry(prev[0])
    tds.set_default_registry(prev[1])


def _fields(obj) -> dict:
    return None if obj is None else dataclasses.asdict(obj)


def _assert_plans_equal(tp, rp):
    for name in ("cap", "execution", "gang", "fleet", "entropy", "integrity", "dictionary"):
        assert _fields(getattr(tp, name)) == _fields(getattr(rp, name)), name
    assert (tp.align, tp.capacity, tp.notes, tp.block_tuples) == (rp.align, rp.capacity, rp.notes,
                                                                   rp.block_tuples)
    assert type(tp.codec).__name__ == type(rp.codec).__name__
    assert tp.spec.to_dict() == rp.spec.to_dict()
    # arrays in the signature are already (dtype, shape, bytes) on both sides
    assert len(tp.signature) == len(rp.signature)
    for a, b in zip(tp.signature, rp.signature):
        assert a == b
    assert (tp.tiers is None) == (rp.tiers is None)
    for (tt, tpp), (rt, rpp) in zip(tp.tiers or (), rp.tiers or ()):
        assert dataclasses.asdict(tt) == dataclasses.asdict(rt)
        _assert_plans_equal(tpp, rpp)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_negotiate_matches_reference(registries, name):
    kw = SPECS[name]
    try:
        rp = rcs.negotiate(rcs.JobSpec(**kw))
    except rcs.NegotiationError as exc:
        with pytest.raises(api.NegotiationError) as ours:
            tcs.negotiate(tcs.JobSpec(**kw), device="cpu")
        assert str(ours.value) == str(exc)
        assert "\n" not in str(exc)
        return
    tp = tcs.negotiate(tcs.JobSpec(**kw), device="cpu")
    _assert_plans_equal(tp, rp)
    assert tp.device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(DEVICE_SPECS))
def test_negotiate_device_meshes(registries, name):
    """`devices >= 1` counts the devices visible on the CPU (one, as jax's
    CPU devices here): within it the plan carries the reference's
    `FleetPlan`, and an adaptive spec is refused with the reference's text;
    past it is the one intended text difference (`PORT_ONLY`)."""
    kw = DEVICE_SPECS[name]
    if name in PORT_ONLY:
        ours_text, theirs_text = PORT_ONLY[name]
        with pytest.raises(api.NegotiationError, match=ours_text) as ours:
            tcs.negotiate(tcs.JobSpec(**kw), device="cpu")
        with pytest.raises(rcs.NegotiationError, match=theirs_text):
            rcs.negotiate(rcs.JobSpec(**kw))
        assert "\n" not in str(ours.value)
        return
    try:
        rp = rcs.negotiate(rcs.JobSpec(**kw))
    except rcs.NegotiationError as exc:
        with pytest.raises(api.NegotiationError) as ours:
            tcs.negotiate(tcs.JobSpec(**kw), device="cpu")
        assert str(ours.value) == str(exc) and "adaptive" in str(exc)
        return
    tp = tcs.negotiate(tcs.JobSpec(**kw), device="cpu")
    _assert_plans_equal(tp, rp)
    assert tp.fleet.devices == kw["devices"] and tp.fleet.max_wave == tp.gang.max_gang


def test_capabilities_match_reference():
    ours, theirs = tcs.capabilities(), rcs.capabilities()
    assert [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in theirs]
    assert tcs.capability("tdic32") is tcs.capability("tdic32")
    with pytest.raises(api.NegotiationError) as ours:
        tcs.capability("zstd")
    with pytest.raises(rcs.NegotiationError) as theirs:
        rcs.capability("zstd")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("config", ["SOLUTION_A", "SOLUTION_B", "PAPER_DEFAULT"])
def test_from_engine_config_matches_reference(config):
    tc, rc = getattr(tedge, config), getattr(redge, config)
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    sample = (np.arange(5000, dtype=np.uint32) * 37) % 9000
    ts = tcs.JobSpec.from_engine_config(tc, sample)
    assert ts.to_dict() == rcs.JobSpec.from_engine_config(rc, sample).to_dict()
    assert dataclasses.asdict(ts.engine_config()) == dataclasses.asdict(
        rcs.JobSpec.from_dict(ts.to_dict()).engine_config())
    assert tcs.JobSpec.from_engine_config(ts.engine_config()) == ts


def _walk(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-50, 51, n)) + 9000, 0, None).astype(np.uint32)


@pytest.mark.parametrize("kw", [
    dict(codec="tcomp32", egress=True, arrival_rate_tps=1e5),
    dict(codec="rle", egress=True, integrity="crc32c"),
    dict(codec="uanuq", egress=True, params={"qbits": 8, "vmax": 1000.0}),
    dict(codec="leb128"),
], ids=["tcomp32", "rle", "uanuq", "no_egress"])
def test_offline_handle_matches_reference(kw):
    segs = [_walk(1, 700), np.full(300, 3_000_000, np.uint32), _walk(2, 513)]
    rh = rcs.open(rcs.JobSpec(**kw, **GEOM))
    with tcs.open(tcs.JobSpec(**kw, **GEOM), device="cpu") as th:
        for seg in segs:
            rh.push(seg)
            th.push(seg)
            assert th.flush().total_bits == rh.flush().total_bits
            assert th.flush() is None
    rep_t, rep_r = th.report(), rh.close()
    assert [f.to_bytes() for f in th.frames()] == [f.to_bytes() for f in rh.frames()]
    for k in ("n_tuples", "total_bits", "ratio", "n_frames", "wire_bytes"):
        assert getattr(rep_t, k) == getattr(rep_r, k), k
    assert _fields(rep_t.fidelity) == _fields(rep_r.fidelity)
    with pytest.raises(api.NegotiationError, match="closed"):
        th.push(segs[0])


def test_open_refusals():
    """What `open` and the handles refuse, with the reference's text; and
    what they accept now that the serving runtime is ported: `open(...,
    dispatcher=...)` binds a session handle whose timestamped feed gives
    the reference's frames and report."""
    spec = tcs.JobSpec(codec="tcomp32")
    rspec = rcs.JobSpec(codec="tcomp32")

    def same_error(ours_fn, theirs_fn):
        with pytest.raises(api.NegotiationError) as ours:
            ours_fn()
        with pytest.raises(rcs.NegotiationError) as theirs:
            theirs_fn()
        assert str(ours.value) == str(theirs.value)

    same_error(lambda: tcs.open(spec.replace(gang=True), device="cpu"),
               lambda: rcs.open(rspec.replace(gang=True)))
    same_error(lambda: tcs.open(spec, controller=object(), device="cpu"),
               lambda: rcs.open(rspec, controller=object()))
    v, ts = _walk(3, 1500), np.arange(1500) * 1e-4
    th = tcs.open(spec.replace(egress=True, flush_tuples=512),
                  dispatcher=tcs.Dispatcher(device="cpu"), topic="t")
    rh = rcs.open(rspec.replace(egress=True, flush_tuples=512), dispatcher=rcs.Dispatcher(), topic="t")
    assert th.topic == rh.topic == "t" and th.device == torch.device("cpu")
    same_error(lambda: th.push(v), lambda: rh.push(v))
    same_error(lambda: th.push(v, ts[:10]), lambda: rh.push(v, ts[:10]))
    th.push(v, ts)
    rh.push(v, ts)
    rep_t, rep_r = th.close(), rh.close()
    assert [f.to_bytes() for f in th.frames()] == [f.to_bytes() for f in rh.frames()]
    for k in ("n_tuples", "total_bits", "ratio", "n_frames", "wire_bytes"):
        assert getattr(rep_t, k) == getattr(rep_r, k), k
    assert [f.key() for f in th._session.flushes] == [f.key() for f in rh._session.flushes]
    h = tcs.open(spec, device="cpu")
    same_error(lambda: h.push(np.zeros(4, np.uint32), np.zeros(4)),
               lambda: rcs.open(rspec).push(np.zeros(4, np.uint32), np.zeros(4)))
    with pytest.raises(api.NegotiationError, match="no trained dictionary"):
        h.swap_dictionary(tds.train_dict(np.arange(10), idx_bits=12))
    assert h.flush() is None and h.close().n_frames == 0
    if not torch.cuda.is_available():
        for call in (lambda: tcs.negotiate(spec), lambda: tcs.open(spec),
                     lambda: tcs.Dispatcher(), lambda: tcs.gang_compress(spec, [v])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.mark.parametrize("codec", ["adpcm", "uaadpcm", "leb128_nuq", "uanuq", "pla"])
def test_calibrated_lossy_signatures_match_reference(codec):
    """Calibrated lossy codecs keep hashable attributes, before and after a
    run, so their dispatch signature (and `Plan.notes`) equal the
    reference's."""
    sample = _walk(codec == "pla", 4096)
    ts = tcs.JobSpec(codec=codec, egress=True, **GEOM).calibrated(sample)
    rs = rcs.JobSpec(codec=codec, egress=True, **GEOM).calibrated(sample)
    tp, rp = tcs.negotiate(ts, device="cpu"), rcs.negotiate(rs)
    _assert_plans_equal(tp, rp)
    with tcs.open(ts, device="cpu") as th:
        th.push(sample)
        th.flush()
    again = dispatch_signature(th.pipeline.codec, 2, tp.capacity // 2)
    assert again == rp.signature == tp.signature
