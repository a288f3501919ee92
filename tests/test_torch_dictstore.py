"""The port's trained-dictionary subsystem (`repro_torch.core.dictstore`,
FEATURE_DICT frames, seeded tdic32) against the reference's, on the CPU:
  * `train_dict` artifacts equal, with equal `content_hash`, and
    `seed_state` equal to the reference's;
  * one registry root read by both packages, published from either side;
  * FEATURE_DICT frames byte-identical and decoding across both ways, with
    and without `entropy="rans"` and `integrity="crc32c"`;
  * a hot swap mid-stream; the three decode errors' texts;
  * seeded tdic32 under private and shared state (ties between seeded
    lanes, all stamped 0, resolve as the reference's `lww_select`).
Both packages' default registries point at one temporary root during a
test and are restored after it.
"""
import numpy as np
import pytest
import torch

from repro import cstream as rcs
from repro.core import dictstore as rds
from repro.core.pipeline import DecompressionPipeline as RefDecompression
from repro_torch import cstream as tcs
from repro_torch.core import bits as tbits
from repro_torch.core import dictstore as tds
from repro_torch.core.algorithms import make_codec
from repro_torch.core.pipeline import DecompressionPipeline
from repro_torch.kernels import ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

IDX_BITS = 8
#: small geometry: 2 lanes x 128 tuples a block
GEOM = dict(lanes=2, micro_batch_bytes=1024)


def _zipf(seed: int, card: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.zipf(1.3, size=n) - 1) % card).astype(np.uint32) * np.uint32(1007)


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


def _publish_both(registries, seed: int, topic: str = "sensor", idx_bits: int = IDX_BITS):
    """Publish one artifact from the reference side, then re-open the port's
    registry over the shared root so it sees the new version."""
    rreg, treg = registries
    art = rreg.publish(rds.train_dict(_zipf(seed, 300, 4096), idx_bits=idx_bits, topic=topic))
    fresh = tds.DictRegistry(root=rreg.root)
    tds.set_default_registry(fresh)
    return art, fresh


@pytest.mark.parametrize("idx_bits", [4, 10, 12])
def test_train_dict_matches_reference(idx_bits):
    sample = _zipf(idx_bits, 500, 6000)
    a = rds.train_dict(sample, idx_bits=idx_bits, topic="t", version=3)
    b = tds.train_dict(sample, idx_bits=idx_bits, topic="t", version=3)
    assert (b.ref, b.content_hash, b.n_entries, b.summary()) == (a.ref, a.content_hash, a.n_entries,
                                                                 a.summary())
    for k in ("table", "valid", "ts"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    ours = b.seed_state(3, "cpu")
    for k, v in a.seed_state(3).items():
        got = ours[k].numpy()
        np.testing.assert_array_equal(got.view(np.uint32) if k == "table" else got, np.asarray(v))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_registry_root_is_shared_across_packages(tmp_path, writer):
    """An artifact either package publishes loads in the other with an equal
    content hash; pins and versions carry over through the index."""
    root = str(tmp_path / writer)
    w_mod, r_mod = (rds, tds) if writer == "reference" else (tds, rds)
    reg = w_mod.DictRegistry(root=root)
    arts = [reg.publish(w_mod.train_dict(_zipf(s, 200, 3000), idx_bits=IDX_BITS, topic="sensor"))
            for s in range(3)]
    reg.pin("sensor", 2)
    other = r_mod.DictRegistry(root=root, max_resident=1)
    assert other.versions("sensor") == [1, 2, 3]
    assert other.get("sensor").version == 2
    for a in arts:
        assert other.get("sensor", a.version).content_hash == a.content_hash
    assert other.resident_count == 1
    assert [r["hash"] for r in other.summary()] == [r["hash"] for r in reg.summary()]


def test_registry_errors_match_reference():
    rreg, treg = rds.DictRegistry(), tds.DictRegistry()
    for reg, mod in ((rreg, rds), (treg, tds)):
        reg.publish(mod.train_dict(_zipf(0, 100, 500), idx_bits=IDX_BITS, topic="sensor"))
    for call in (lambda r: r.get("nope"), lambda r: r.get("sensor", 9), lambda r: r.pin("sensor", 4)):
        with pytest.raises(KeyError) as ours:
            call(treg)
        with pytest.raises(KeyError) as theirs:
            call(rreg)
        assert ours.value.args[0] == theirs.value.args[0]


def _handles(kw: dict):
    return rcs.open(rcs.JobSpec(**kw)), tcs.open(tcs.JobSpec(**kw), device="cpu")


@pytest.mark.parametrize("entropy", [None, "rans"])
@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_dict_frames_byte_identical_and_decode_across(registries, entropy, integrity):
    art, _ = _publish_both(registries, 0)
    kw = dict(codec="tdic32", egress=True, dictionary="sensor:latest", entropy=entropy,
              integrity=integrity, **GEOM)
    rh, th = _handles(kw)
    vals = _zipf(1, 300, 1500)  # 5 full blocks and a tail
    rh.push(vals)
    rh.flush()
    th.push(vals)
    th.flush()
    (rf,), (tf,) = rh.frames(), th.frames()
    assert tf.dict_id == rf.dict_id == ("sensor", 1)
    buf = tf.to_bytes()
    assert buf == rf.to_bytes() and tf.wire_bytes == len(buf)
    assert th.plan.dictionary.content_hash == art.content_hash
    # a collector with a cold codec resolves the frame's dictionary itself
    cold = dict(codec="tdic32", params={"idx_bits": IDX_BITS}, **GEOM)
    np.testing.assert_array_equal(
        DecompressionPipeline(tcs.JobSpec(**cold), device="cpu").ingest(rf.to_bytes()).values, vals)
    np.testing.assert_array_equal(RefDecompression(rcs.JobSpec(**cold)).ingest(buf).values, vals)
    rep_r, rep_t = rh.report(), th.report()
    assert (rep_t.wire_bytes, rep_t.ratio, rep_t.total_bits) == (rep_r.wire_bytes, rep_r.ratio,
                                                                  rep_r.total_bits)


def test_hot_swap_mid_stream_matches_reference(registries):
    _publish_both(registries, 0)
    kw = dict(codec="tdic32", egress=True, dictionary="sensor", **GEOM)
    rh, th = _handles(kw)
    art2, treg = _publish_both(registries, 5)
    segs = [_zipf(s, 300, 700) for s in (2, 3, 4)]
    for i, seg in enumerate(segs):
        if i == 1:
            rh.swap_dictionary(art2)
            th.swap_dictionary(treg.get("sensor", 2))
        rh.push(seg)
        rh.flush()
        th.push(seg)
        th.flush()
    assert [f.dict_id for f in th.frames()] == [("sensor", 1), ("sensor", 2), ("sensor", 2)]
    assert [f.to_bytes() for f in th.frames()] == [f.to_bytes() for f in rh.frames()]
    rep = th.close()
    assert rep.n_frames == 3 and rep.fidelity.within_bound and rep.fidelity.max_abs == 0
    for rt, seg in zip(rep.roundtrips, segs):
        np.testing.assert_array_equal(rt.values, seg)


@pytest.mark.parametrize("case", ["unresolvable", "not_a_dictionary_codec", "idx_bits"])
def test_decode_errors_match_reference(registries, case):
    _publish_both(registries, 0)
    kw = dict(codec="tdic32", egress=True, dictionary="sensor:v1", **GEOM)
    _, th = _handles(kw)
    th.push(_zipf(1, 300, 600))
    th.flush()
    frame = th.frames()[0]
    if case == "unresolvable":
        frame.dict_id = ("elsewhere", 7)
        spec = dict(codec="tdic32", params={"idx_bits": IDX_BITS}, **GEOM)
    elif case == "not_a_dictionary_codec":
        frame.codec_id = 7  # a tcomp32 frame that names a dictionary
        spec = dict(codec="tcomp32", **GEOM)
    else:
        spec = dict(codec="tdic32", params={"idx_bits": IDX_BITS + 1}, **GEOM)
    buf = frame.to_bytes()
    with pytest.raises(tbits.FrameDecodeError) as ours:
        DecompressionPipeline(tcs.JobSpec(**spec), device="cpu").ingest(buf)
    with pytest.raises(Exception) as theirs:
        RefDecompression(rcs.JobSpec(**spec)).ingest(buf)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("state,mode", [("private", "frozen"), ("shared", "frozen"), ("private", "exact")])
def test_seeded_tdic32_matches_reference(registries, state, mode):
    """Seeded lanes all stamp their slots 0: under the shared strategy the
    per-block merge meets those ties first, and must settle them as the
    reference does."""
    _publish_both(registries, 0)
    kw = dict(codec="tdic32", egress=True, dictionary="sensor:v1", state=state,
              params={"mode": mode}, **GEOM)
    rh, th = _handles(kw)
    vals = _zipf(9, 300, 1100 if mode == "frozen" else 300)
    rh.push(vals)
    rh.flush()
    th.push(vals)
    th.flush()
    assert th.frames()[0].to_bytes() == rh.frames()[0].to_bytes()
    np.testing.assert_array_equal(th.report().roundtrips[0].values, vals)


def test_seeded_chunk_walk_keeps_unwritten_seeds():
    """The codec form's plain versions from a seeded state (valid slots
    stamped 0, empty ones -1): a seed slot no tuple writes keeps its value
    and stamp 0, the first write to a seeded slot wins with stamp
    clock + position, and the walk equals the per-block route."""
    art = tds.train_dict(_zipf(0, 300, 4096), idx_bits=IDX_BITS)
    codec = make_codec("tdic32", idx_bits=IDX_BITS).seed_dictionary(art)
    state = codec.init_state(2, torch.device("cpu"))
    blocks = tbits.u32_tensor(_zipf(3, 40, 3 * 2 * 64).reshape(3, 2, 64), "cpu")
    codes, bitlen, *after = ref.dict_chunk_encode_ref(blocks, *codec.kernel_state(state), IDX_BITS)
    each_state, each = codec.encode_each_block(state, blocks)
    assert torch.equal(codes, each.codes) and torch.equal(bitlen, each.bitlen)
    for got, want in zip(after, codec.kernel_state(each_state)):
        assert torch.equal(got.to(torch.int32), want.to(torch.int32))
    written = torch.zeros(2, 1 << IDX_BITS, dtype=torch.bool)
    written.scatter_(1, codec._hash(blocks.permute(1, 0, 2).reshape(2, -1)), True)
    seeded = torch.from_numpy(art.valid).expand(2, -1)
    kept = seeded & ~written
    assert torch.equal(after[0][kept], state["table"][kept]) and bool((after[2][kept] == 0).all())
    assert bool((after[2][written] >= 0).all()) and bool(written.any() & seeded.any())
    x, *_ = ref.dict_chunk_decode_ref(codes, *codec.kernel_state(state), IDX_BITS)
    assert torch.equal(x, blocks)
