"""The port's block-scope codecs of the first slice (raw32, tcomp32, leb128,
delta_leb128) against the reference's: the same symbol slots, decoded values
and replayed state, block after block; codec state handed over between the
two packages. The registry covers every codec; tdic32 and rle have their own
file (tests/test_torch_dictionary.py), the lossy codecs theirs
(tests/test_torch_lossy.py)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import algorithms as ralg
from repro.core.pipeline import CompressionPipeline as RefCompression
from repro.core.strategies import EngineConfig as RefEngineConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import bits as tbits
from repro_torch.core.algorithms import leb128 as tleb
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.strategies import EngineConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CODECS = ("raw32", "tcomp32", "leb128", "delta_leb128")
#: every codec the port registers: the reference's whole registry
PORTED = CODECS + ("tdic32", "rle", "leb128_nuq", "uanuq", "adpcm", "uaadpcm", "pla")
LANES = 4


def _values(seed: int, n: int) -> np.ndarray:
    """Random walk with full-range spikes (codes above 32 bits included)."""
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.integers(-300, 301, n)) + 50_000, 0, 2**32 - 1)
    spikes = rng.integers(0, 2**32, n, dtype=np.uint64)
    v = np.where(rng.random(n) < 0.25, spikes, walk).astype(np.uint32)
    v[:4] = [0, 1, 2**31, 2**32 - 1]
    return v


def _t(a):
    return tbits.u32_tensor(np.asarray(a, np.uint32), "cpu")


def _ref_state_np(state):
    return None if state is None else {k: np.asarray(v) for k, v in state.items()}


def _assert_same_state(ours, theirs):
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("per_lane", [1, 7, 8, 33, 512])
def test_encode_decode_and_state_match_reference_block_by_block(codec, per_lane):
    tc, rc = talg.make_codec(codec), ralg.make_codec(codec)
    vals = _values(per_lane, 3 * LANES * per_lane).reshape(3, LANES, per_lane)
    ts_e, ts_d = tc.init_state(LANES, torch.device("cpu")), tc.init_state(LANES, torch.device("cpu"))
    rs_e, rs_d = rc.init_state(LANES), rc.init_state(LANES)
    for blk in vals:  # state carried across three blocks
        ts_e, enc_t = tc.encode(ts_e, _t(blk))
        rs_e, enc_r = rc.encode(rs_e, jnp.asarray(blk))
        np.testing.assert_array_equal(tbits.u32_numpy(enc_t.codes), np.asarray(enc_r.codes))
        np.testing.assert_array_equal(enc_t.bitlen.numpy(), np.asarray(enc_r.bitlen))
        _assert_same_state(talg.state_to_numpy(tc, ts_e), _ref_state_np(rs_e))
        ts_d, x_t = tc.decode(ts_d, enc_t)
        rs_d, x_r = rc.decode(rs_d, enc_r)
        np.testing.assert_array_equal(tbits.u32_numpy(x_t), np.asarray(x_r))
        np.testing.assert_array_equal(tbits.u32_numpy(x_t), blk)


@pytest.mark.parametrize("codec", CODECS)
def test_encode_blocks_equals_sequential_encodes(codec):
    """One chunk call `(C, L, B)` gives the symbols and state of C calls."""
    tc = talg.make_codec(codec)
    cpu = torch.device("cpu")
    blocks = _t(_values(3, 5 * LANES * 16).reshape(5, LANES, 16))
    st_chunk, enc = tc.encode_blocks(tc.init_state(LANES, cpu), blocks)
    st = tc.init_state(LANES, cpu)
    for i in range(5):
        st, e = tc.encode(st, blocks[i])
        assert torch.equal(enc.codes[i], e.codes) and torch.equal(enc.bitlen[i], e.bitlen)
    if st is not None:
        assert torch.equal(st_chunk["prev"], st["prev"])
    _, back = tc.decode_blocks(tc.init_state(LANES, cpu), enc)
    assert torch.equal(back, blocks)


@pytest.mark.parametrize("v", [0, 1, 2, 127, 128, 2**14, 2**21, 2**28, 2**31, 2**32 - 1])
def test_leb128_words_edge_values(v):
    x = np.full(3, v, np.uint32)
    c0, c1, bl = tleb.leb128_encode_words(_t(x))
    from repro.core.algorithms import leb128 as rleb

    r0, r1, rb = rleb.leb128_encode_words(jnp.asarray(x))
    np.testing.assert_array_equal(tbits.u32_numpy(c0), np.asarray(r0))
    np.testing.assert_array_equal(tbits.u32_numpy(c1), np.asarray(r1))
    np.testing.assert_array_equal(bl.numpy(), np.asarray(rb))
    back = tleb.leb128_decode_words(torch.stack([c0, c1], dim=-1), bl)
    np.testing.assert_array_equal(tbits.u32_numpy(back), x)


def test_state_from_numpy_roundtrip():
    tc = talg.make_codec("delta_leb128")
    ref_state = {"prev": np.array([0, 1, 2**31, 2**32 - 1], np.uint32)}
    st = talg.state_from_numpy(tc, ref_state, torch.device("cpu"))
    assert st["prev"].dtype == torch.int32
    back = talg.state_to_numpy(tc, st)
    assert back["prev"].dtype == np.uint32
    np.testing.assert_array_equal(back["prev"], ref_state["prev"])
    assert talg.state_from_numpy(talg.make_codec("tcomp32"), None, "cpu") is None


_REF_PIPES: dict = {}


def _ref_pipe(codec: str) -> RefCompression:
    if codec not in _REF_PIPES:
        _REF_PIPES[codec] = RefCompression(RefEngineConfig(
            codec=codec, lanes=LANES, micro_batch_bytes=256, scan_chunk=2, calibrate=False,
        ))
    return _REF_PIPES[codec]


@pytest.mark.parametrize("codec", CODECS + ("tdic32",))
def test_stream_handoff_reference_to_port(codec):
    """The reference compresses the first half of a stream; its codec state
    carries over and the port finishes: the second frame is identical to the
    reference's own second frame."""
    rp = _ref_pipe(codec)
    tp = CompressionPipeline(EngineConfig(
        codec=codec, lanes=LANES, micro_batch_bytes=256, scan_chunk=2, calibrate=False,
    ), device="cpu")
    v = _values(9, 5 * rp.block_tuples + 9)
    half = 3 * rp.block_tuples
    shaped = rp.shape_blocks(v[:half])
    first = rp.execute(shaped, collect_payload=True)
    ref_second = rp.compress_to_frame(v[half:], state=first.state).to_bytes()
    carried = talg.state_from_numpy(tp.codec, _ref_state_np(first.state), tp.device)
    port_second = tp.compress_to_frame(v[half:], state=carried).to_bytes()
    assert port_second == ref_second


def test_registry_matches_reference():
    assert talg.WIRE_CODEC_IDS == ralg.WIRE_CODEC_IDS
    assert talg.WIRE_CODEC_NAMES == ralg.WIRE_CODEC_NAMES
    assert talg.PAPER_TABLE1 == ralg.PAPER_TABLE1
    assert set(talg.codec_names()) == set(PORTED)
    for name in PORTED:
        assert talg.accepted_params(name) == ralg.accepted_params(name)
        tm, rm = talg.make_codec(name).meta, ralg.make_codec(name).meta
        assert (tm.name, tm.lossy, tm.stateful, tm.state_kind, tm.aligned, tm.scope,
                tm.maskable) == (rm.name, rm.lossy, rm.stateful, rm.state_kind,
                                 rm.aligned, rm.scope, rm.maskable)


@pytest.mark.parametrize("name", ["tdic32", "rle", "leb128_nuq", "uanuq", "adpcm", "uaadpcm", "pla"])
def test_unported_codecs_name_their_roadmap_item(name):
    """The seven codecs the first slice left unported (each then raised a
    KeyError naming its ROADMAP item) are all ported now: tdic32 and rle
    (A2), the lossy five (A5). Each builds with the reference's accepted
    parameters, meta and error bound."""
    assert name in talg.codec_names()
    assert talg.accepted_params(name) == ralg.accepted_params(name)
    tc, rc = talg.make_codec(name), ralg.make_codec(name)
    assert dataclasses.astuple(tc.meta) == dataclasses.astuple(rc.meta)
    assert tc.error_bound() == rc.error_bound()


def test_unknown_codec_and_params_raise_like_reference():
    with pytest.raises(KeyError, match="unknown codec"):
        talg.make_codec("nope")
    with pytest.raises(ValueError) as ours:
        talg.make_codec("tcomp32", qbits=3)
    with pytest.raises(ValueError) as theirs:
        ralg.make_codec("tcomp32", qbits=3)
    assert str(ours.value) == str(theirs.value)
