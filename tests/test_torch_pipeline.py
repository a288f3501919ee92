"""The port's executors and job API against the reference, on the CPU.

For raw32, tcomp32, leb128 and delta_leb128; tdic32 in frozen and exact
mode under private and shared state; rle; the lossy codecs (adpcm,
uaadpcm, leb128_nuq, uanuq, pla); and every ported codec with
`entropy="rans"` — in fused lazy mode (small micro-batches and
scan_chunk=2, so streams cross chunk boundaries) and in eager mode, over the
length grid {0, 1, lanes-1, block-1, block, block+1, 3*block+ragged} and
with integrity off and on:
  * `compress_to_frame(v).to_bytes()` is byte-identical to the reference's;
  * frames decode across both ways (lossless codecs to the input, lossy
    ones to the reference's own decode, within `error_bound()` where the
    codec has one);
  * `run_roundtrip` is lossless, or for lossy codecs holds the bound;
  * `JobSpec.to_dict()` JSON is equal.
Plus the policy modules the executor uses (strategies, energy, calibration,
metrics) and the datasets, against their reference twins.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import cstream
from repro.core import calibration as rcal
from repro.core import energy as renergy
from repro.core import metrics as rmetrics
from repro.core import strategies as rstrat
from repro.core.pipeline import CompressionPipeline as RefCompression
from repro.core.pipeline import DecompressionPipeline as RefDecompression
from repro.data import datasets as rdata
from repro_torch import api
from repro_torch.core import bits as tbits
from repro_torch.core import calibration as tcal
from repro_torch.core import energy as tenergy
from repro_torch.core import metrics as tmetrics
from repro_torch.core import strategies as tstrat
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline
from repro_torch.data import datasets as tdata

CODECS = ("raw32", "tcomp32", "leb128", "delta_leb128")
#: the second slice's paths: tdic32 (mode x state strategy), rle, and the
#: rANS stage over every ported codec
SLICE2 = {
    "tdic32": dict(codec="tdic32"),
    "tdic32-shared": dict(codec="tdic32", state="shared"),
    "tdic32-exact": dict(codec="tdic32", params={"mode": "exact"}),
    "tdic32-exact-shared": dict(codec="tdic32", params={"mode": "exact"}, state="shared"),
    "rle": dict(codec="rle"),
    **{f"{c}+rans": dict(codec=c, entropy="rans") for c in CODECS + ("tdic32", "rle")},
}
#: the third slice's paths: the lossy codecs at their defaults, alone and
#: with the rANS stage
LOSSY_CODECS = ("adpcm", "uaadpcm", "leb128_nuq", "uanuq", "pla")
SLICE3 = {
    **{c: dict(codec=c) for c in LOSSY_CODECS},
    **{f"{c}+rans": dict(codec=c, entropy="rans") for c in LOSSY_CODECS},
}
#: configuration name -> JobSpec fields
CONFIGS = {**{c: dict(codec=c) for c in CODECS}, **SLICE2, **SLICE3}
ALL = tuple(CONFIGS)
LOSSLESS = tuple(c for c in CONFIGS if c not in SLICE3)
LANES = 4
#: fused: 32-tuple blocks (the 7-bit metadata path), two blocks per chunk;
#: eager: one lane-aligned unit per block (raw metadata, per-block steps)
MODES = {
    "fused": dict(micro_batch_bytes=128, scan_chunk=2),
    "eager": dict(execution="eager"),
}
CRC = (None, "crc32c")


def _values(seed: int, n: int) -> np.ndarray:
    """Random walk with full-range spikes (codes above 32 bits included)."""
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.integers(-300, 301, n)) + 50_000, 0, 2**32 - 1)
    spikes = rng.integers(0, 2**32, n, dtype=np.uint64)
    return np.where(rng.random(n) < 0.25, spikes, walk).astype(np.uint32)


def _specs(config: str, mode: str, integrity=None):
    kw = dict(lanes=LANES, integrity=integrity, **CONFIGS[config], **MODES[mode])
    return api.JobSpec(**kw), cstream.JobSpec(**kw)


# reference pipelines and frames are cached: each new shape costs a jit
_REF: dict = {}
_REF_FRAMES: dict = {}
_PORT: dict = {}


def _ref_pipes(codec: str, mode: str):
    key = (codec, mode)
    if key not in _REF:
        _, rs = _specs(codec, mode)
        _REF[key] = (RefCompression(rs), RefDecompression(rs))
    return _REF[key]


def _port_pipes(codec: str, mode: str, integrity):
    key = (codec, mode, integrity)
    if key not in _PORT:
        ts, _ = _specs(codec, mode, integrity)
        _PORT[key] = (
            ts,
            CompressionPipeline(ts, device="cpu"),
            DecompressionPipeline(ts, device="cpu"),
        )
    return _PORT[key]


def _length(mode: str, idx: int) -> int:
    bt = _ref_pipes(CODECS[0], mode)[0].block_tuples
    return [0, 1, LANES - 1, bt - 1, bt, bt + 1, 3 * bt + bt // 2 + 1][idx]


def _ref_frame(codec: str, mode: str, n: int, integrity) -> bytes:
    """The reference pipeline's frame; the integrity trailer is stamped at
    marshal time (`_maybe_entropy`), so one execution serves both modes."""
    key = (codec, mode, n)
    if key not in _REF_FRAMES:
        _REF_FRAMES[key] = _ref_pipes(codec, mode)[0].compress_to_frame(_values(n, n))
    return dataclasses.replace(_REF_FRAMES[key], integrity=integrity).to_bytes()


# ------------------------------------------------------------ frame parity --
@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("length_idx", range(7))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", ALL)
def test_frames_byte_identical_and_cross_decode(codec, mode, length_idx, integrity):
    n = _length(mode, length_idx)
    v = _values(n, n)
    _, pipe, decomp = _port_pipes(codec, mode, integrity)
    ours = pipe.compress_to_frame(v).to_bytes()
    theirs = _ref_frame(codec, mode, n, integrity)
    assert ours == theirs, (codec, mode, n, integrity)
    ref_back = _ref_pipes(codec, mode)[1].ingest(ours).values
    np.testing.assert_array_equal(decomp.ingest(theirs).values, ref_back)
    if codec in SLICE3:  # lossy: each package decodes the frame to the same values
        bound = pipe.codec.error_bound()
        if bound is not None and n:
            assert np.abs(ref_back.astype(np.int64) - v.astype(np.int64)).max() <= bound
    else:
        np.testing.assert_array_equal(ref_back, v)


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", LOSSLESS)
def test_run_roundtrip_is_lossless(codec, mode, integrity):
    spec, pipe, decomp = _port_pipes(codec, mode, integrity)
    v = _values(77, _length(mode, 6))
    rt = api.run_roundtrip(pipe, decomp, spec, v, arrival_rate_tps=1e6)
    assert rt.fidelity.bit_exact and rt.fidelity.n_tuples == v.size
    np.testing.assert_array_equal(rt.values, v)
    assert rt.wire_bytes == len(rt.compress.frame.to_bytes())
    assert (rt.compress.frame.entropy is not None) == (spec.entropy == "rans")
    assert rt.compress.stats.latency_s is not None and rt.compress.stats.energy_j > 0


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", tuple(SLICE3))
def test_run_roundtrip_of_lossy_codecs_holds_error_bound(codec, mode, integrity):
    """A lossy roundtrip returns the reference's decode of the same frame;
    the bounded codecs (leb128_nuq, uanuq, pla) stay within
    `error_bound()`, ADPCM/UAADPCM (no bound) report their error."""
    spec, pipe, decomp = _port_pipes(codec, mode, integrity)
    v = _values(77, _length(mode, 6))
    rt = api.run_roundtrip(pipe, decomp, spec, v, arrival_rate_tps=1e6)
    assert rt.fidelity.n_tuples == v.size and rt.fidelity.bound == pipe.codec.error_bound()
    assert rt.fidelity.within_bound
    ref_back = _ref_pipes(codec, mode)[1].ingest(rt.compress.frame.to_bytes()).values
    np.testing.assert_array_equal(rt.values, ref_back)
    assert (rt.compress.frame.entropy is not None) == (spec.entropy == "rans")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", ALL)
def test_legacy_collection_matches_compacted_egress(codec, mode):
    """compact=False (full worst-case buffers, `build_frame`) and the device
    compaction path give the same bytes; so do the per-block bit counts of
    a run that collects no payload, against the reference."""
    _, pipe, _ = _port_pipes(codec, mode, None)
    v = _values(5, _length(mode, 6))
    assert pipe.compress_to_frame(v, compact=False).to_bytes() == pipe.compress_to_frame(v).to_bytes()
    rpipe = _ref_pipes(codec, mode)[0]
    ours = pipe.execute(pipe.shape_blocks(v)).per_block_bits
    theirs = rpipe.execute(rpipe.shape_blocks(v)).per_block_bits
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", ALL)
def test_jobspec_json_equal(codec, mode, integrity):
    ts, rs = _specs(codec, mode, integrity)
    assert json.dumps(ts.to_dict(), sort_keys=True) == json.dumps(rs.to_dict(), sort_keys=True)
    assert api.JobSpec.from_dict(rs.to_dict()) == ts
    assert api.JobSpec.from_dict(json.loads(json.dumps(rs.to_dict()))) == ts


def test_default_jobspec_and_plan_match_reference():
    ts, rs = api.JobSpec(), cstream.JobSpec()
    assert ts.to_dict() == rs.to_dict()
    tp = CompressionPipeline(ts, device="cpu")
    rp = RefCompression(rs)
    assert dataclasses.asdict(tp.plan) == dataclasses.asdict(rp.plan)
    assert (tp.block_tuples, tp.plan.scan_chunk) == (2048, 128)


@pytest.mark.parametrize("bad", [
    dict(lanes=0), dict(scan_chunk=-1), dict(entropy="zstd"), dict(integrity="md5"),
    dict(dictionary="bad ref!"), dict(params={"a": [1, 2]}),
])
def test_jobspec_validation_matches_reference(bad):
    with pytest.raises(api.NegotiationError) as ours:
        api.JobSpec(**bad)
    with pytest.raises(ValueError) as theirs:
        cstream.JobSpec(**bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("field,value,item", [
    ("entropy", "rans", "A7"), ("adaptive", True, "A8"), ("dictionary", "topic:v1", "A8"),
    ("gang", True, "A6"), ("devices", 2, "A9"),
])
def test_unported_spec_features_are_refused(field, value, item):
    """Features the port does not have yet are refused, naming their ROADMAP
    item. A case turns into an acceptance check once its item is ported:
    `entropy="rans"` (A7) frames carry the blob and decode; `adaptive` and
    `dictionary` (A8) are not read by the pipelines, as in the reference,
    whose job API builds the tier plans and the seeded codec, so a pipeline
    built straight from such a spec gives the reference's frame."""
    spec = api.JobSpec(**{field: value})
    if item in ("A7", "A8"):
        v = _values(2, 300)
        frame = CompressionPipeline(spec, device="cpu").compress_to_frame(v)
        back = DecompressionPipeline(spec, device="cpu").ingest(frame.to_bytes())
        np.testing.assert_array_equal(back.values, v)
        if field == "entropy":
            assert frame.entropy is not None
        else:
            ref = RefCompression(cstream.JobSpec(**{field: value})).compress_to_frame(v)
            assert frame.to_bytes() == ref.to_bytes()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        CompressionPipeline(spec, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        DecompressionPipeline(spec, device="cpu")


def test_decoder_quarantine_latch():
    spec, pipe, decomp = _port_pipes("tcomp32", "fused", "crc32c")
    decomp = DecompressionPipeline(spec, device="cpu")
    good = pipe.compress_to_frame(_values(3, 100)).to_bytes()
    bad = bytearray(good)
    bad[-24] ^= 0x10
    with pytest.raises(tbits.FrameIntegrityError):
        decomp.ingest(bytes(bad))
    with pytest.raises(tbits.FrameDecodeError, match="quarantined"):
        decomp.ingest(good)
    decomp.reset_quarantine()
    np.testing.assert_array_equal(decomp.ingest(good).values, _values(3, 100))
    other = DecompressionPipeline(api.JobSpec(codec="leb128"), device="cpu")
    with pytest.raises(tbits.FrameDecodeError, match="codec id"):
        other.ingest(good)
    assert other.quarantined is not None


# ------------------------------------------------------- policy / data parity --
@pytest.mark.parametrize("kw", [
    dict(), dict(execution="eager"), dict(micro_batch_bytes=0), dict(micro_batch_bytes=400, lanes=3),
    dict(scan_chunk=7, micro_batch_bytes=65536),
])
def test_plan_execution_matches_reference(kw):
    ours = tstrat.plan_execution(tstrat.EngineConfig(**kw), codec_align=1)
    theirs = rstrat.plan_execution(rstrat.EngineConfig(**kw), codec_align=1)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tstrat.resolve_capacity(2048, 4, 1, 5000) == rstrat.resolve_capacity(2048, 4, 1, 5000)


@pytest.mark.parametrize("policy", ["uniform", "asymmetric"])
def test_scheduling_and_energy_match_reference(policy):
    costs = tstrat.block_costs(0.5, [100.0, 30.0, 0.0, 70.0, 64.0])
    assert costs == rstrat.block_costs(0.5, [100.0, 30.0, 0.0, 70.0, 64.0])
    for name, prof in tenergy.PROFILES.items():
        ours = tstrat.schedule_blocks(costs, prof.speeds, tstrat.SchedulingStrategy(policy))
        theirs = rstrat.schedule_blocks(
            costs, renergy.PROFILES[name].speeds, rstrat.SchedulingStrategy(policy)
        )
        assert ours == theirs
        for spin in (False, True):
            assert tenergy.edge_energy_j(prof, ours[1], ours[2], spin_wait=spin) == \
                renergy.edge_energy_j(renergy.PROFILES[name], theirs[1], theirs[2], spin_wait=spin)
        assert tstrat.cache_aware_batch_bytes(prof) == rstrat.cache_aware_batch_bytes(
            renergy.PROFILES[name]
        )


@pytest.mark.parametrize("codec", ["tdic32", "uanuq", "adpcm", "pla", "tcomp32"])
def test_calibration_matches_reference(codec):
    sample = _values(4, 4096)
    assert tcal.calibrated_kwargs(codec, sample) == rcal.calibrated_kwargs(codec, sample)


def test_metrics_match_reference():
    x = _values(1, 500)
    y = x.copy()
    y[::7] += 3
    assert dataclasses.asdict(tmetrics.fidelity(x, y, bound=2.0)) == dataclasses.asdict(
        rmetrics.fidelity(x, y, bound=2.0)
    )
    assert tmetrics.nrmse(x, y) == rmetrics.nrmse(x, y)
    assert tmetrics.compression_ratio(800, 100) == rmetrics.compression_ratio(800, 100)
    assert api.queueing_delay_s(0.3, 0.5) == cstream.queueing_delay_s(0.3, 0.5)


@pytest.mark.parametrize("name", ["ecg", "rovio", "sensor", "stock", "stock_key", "micro"])
def test_datasets_match_reference(name):
    ours = tdata.make_dataset(name, n_tuples=777, seed=7)
    theirs = rdata.make_dataset(name, n_tuples=777, seed=7)
    np.testing.assert_array_equal(ours.tuples, theirs.tuples)
    assert (ours.source, ours.structure, ours.words_per_tuple) == (
        theirs.source, theirs.structure, theirs.words_per_tuple
    )


def test_no_device_entropy_frame_parse_raises_without_gpu():
    """An entropy frame parsed with no device follows the entry points'
    rule: CUDA, or a RuntimeError naming device='cpu' (not a FrameError)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-device default is CUDA here")
    spec, pipe, _ = _port_pipes("tcomp32+rans", "fused", None)
    buf = pipe.compress_to_frame(_values(4, 200)).to_bytes()
    with pytest.raises(RuntimeError, match="device='cpu'") as err:
        tbits.parse_frame(buf)
    assert not isinstance(err.value, tbits.FrameError)


def test_shared_state_merges_per_block_in_both_directions():
    """Under the shared strategy every lane converges to one table after
    each block: the final encoder and decoder states equal the reference's
    and all lanes hold the same table."""
    spec, pipe, _ = _port_pipes("tdic32-shared", "fused", None)
    rpipe = _ref_pipes("tdic32-shared", "fused")[0]
    v = _values(6, _length("fused", 6))
    ours = pipe.execute(pipe.shape_blocks(v)).state
    theirs = rpipe.execute(rpipe.shape_blocks(v)).state
    for k in ours:
        np.testing.assert_array_equal(
            ours[k].numpy().view(np.asarray(theirs[k]).dtype), np.asarray(theirs[k])
        )
    assert all(np.array_equal(row, ours["table"][0].numpy()) for row in ours["table"].numpy())
