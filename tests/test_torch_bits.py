"""Parity of the port's wire core (`repro_torch.core.bits`) with the
reference (`repro.core.bits`): device ops bit-exact on the CPU, frames
byte-identical in both directions, the same error classes."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis_compat import given, settings, st  # skips when absent

from repro.core import bits as rbits
from repro_torch.core import bits as tbits

BITLENS = np.array([0, 1, 31, 32, 33, 64], np.int32)
LENGTHS = [0, 1, 31, 32, 33, 2048]


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _symbols(seed: int, n: int):
    """Codes and bitlens drawn from BITLENS (0/1/31/32/33/64)."""
    rng = np.random.default_rng(seed)
    return _u32(rng, (n, 2)), rng.choice(BITLENS, size=n).astype(np.int32)


def _t(a):
    """numpy uint32/int32 -> port tensor (uint32 as int32 bits)."""
    a = np.asarray(a)
    return tbits.u32_tensor(a, "cpu") if a.dtype == np.uint32 else torch.from_numpy(a.copy())


def _np(t):
    return tbits.u32_numpy(t)


# ----------------------------------------------------------------- device ops --
def test_bit_length_matches_reference():
    rng = np.random.default_rng(1)
    v = np.concatenate([
        np.array([0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        _u32(rng, (1000,)),
        (np.uint32(1) << rng.integers(0, 32, 100).astype(np.uint32)),
    ])
    np.testing.assert_array_equal(
        tbits.bit_length(_t(v)).numpy(), np.asarray(rbits.bit_length(jnp.asarray(v)))
    )


def test_mask_bits_and_safe_shifts_match_reference():
    n = np.arange(0, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        tbits.mask_bits(torch.from_numpy(n)).numpy().astype(np.uint32),
        np.asarray(rbits.mask_bits(jnp.asarray(n))),
    )
    rng = np.random.default_rng(2)
    x = _u32(rng, (33,))
    s = np.arange(33, dtype=np.int32)
    for ours, theirs in ((tbits._safe_lshift, rbits._safe_lshift),
                         (tbits._safe_rshift, rbits._safe_rshift)):
        got = ours(tbits._u(_t(x)), torch.from_numpy(s)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(theirs(jnp.asarray(x), jnp.asarray(s))))


def test_code64_shift_matches_reference():
    rng = np.random.default_rng(3)
    c = _u32(rng, (32, 2))
    s = np.arange(32, dtype=np.int32)
    ours = tbits.code64_shift(tbits._u(_t(c[:, 0])), tbits._u(_t(c[:, 1])), torch.from_numpy(s))
    theirs = rbits.code64_shift(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(s))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))


@pytest.mark.parametrize("n", LENGTHS)
def test_pack_bits_matches_reference(n):
    codes, blen = _symbols(10 + n, n)
    out_words = 2 * n + 2
    w_t, tot_t, off_t = tbits.pack_bits(_t(codes), _t(blen), out_words)
    w_r, tot_r, off_r = rbits.pack_bits(jnp.asarray(codes), jnp.asarray(blen), out_words)
    np.testing.assert_array_equal(_np(w_t), np.asarray(w_r))
    assert int(tot_t) == int(tot_r)
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_r))


@pytest.mark.parametrize("n", [31, 33, 2048])
def test_pack_bits_drops_past_out_words_like_reference(n):
    """Contributions beyond a too-small buffer are dropped, not wrapped."""
    codes, blen = _symbols(20 + n, n)
    out_words = max(1, n // 3)
    w_t, _, _ = tbits.pack_bits(_t(codes), _t(blen), out_words)
    w_r, _, _ = rbits.pack_bits(jnp.asarray(codes), jnp.asarray(blen), out_words)
    np.testing.assert_array_equal(_np(w_t), np.asarray(w_r))


@pytest.mark.parametrize("n", LENGTHS)
def test_unpack_symbols_matches_reference(n):
    codes, blen = _symbols(30 + n, n)
    words, _, _ = rbits.pack_bits(jnp.asarray(codes), jnp.asarray(blen), 2 * n + 2)
    words = np.asarray(words)
    got_t, off_t = tbits.unpack_symbols(_t(words), _t(blen))
    got_r, off_r = rbits.unpack_symbols(jnp.asarray(words), jnp.asarray(blen))
    np.testing.assert_array_equal(_np(got_t), np.asarray(got_r))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_r))


def test_extract_bits_reads_past_end_like_reference():
    rng = np.random.default_rng(4)
    words = _u32(rng, (5,))
    offsets = np.array([0, 100, 127, 128, 150, 159, 200], np.int32)
    nbits = np.array([64, 64, 33, 32, 64, 1, 64], np.int32)
    got = tbits.extract_bits(_t(words), _t(offsets), _t(nbits))
    want = rbits.extract_bits(jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(nbits))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("nblocks,ow", [(1, 34), (4, 130), (16, 258), (6, 42)])
def test_compact_payload_matches_reference(nblocks, ow):
    rng = np.random.default_rng(nblocks * ow)
    words = _u32(rng, (nblocks, ow))
    nbits = rng.integers(0, 32 * (ow - 2) + 1, size=nblocks).astype(np.int32)
    nbits[0] = 0  # a zero-width block stays transparent
    nw_t, off_t = tbits.block_word_counts(_t(nbits))
    nw_r, off_r = rbits.block_word_counts(jnp.asarray(nbits))
    np.testing.assert_array_equal(nw_t.numpy(), np.asarray(nw_r))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_r))
    pay_t, tot_t = tbits.compact_payload(_t(words), _t(nbits))
    pay_r, tot_r = rbits.compact_payload(jnp.asarray(words), jnp.asarray(nbits))
    np.testing.assert_array_equal(_np(pay_t), np.asarray(pay_r))
    assert int(tot_t) == int(tot_r)


@pytest.mark.parametrize("n", LENGTHS)
def test_pack_meta7_matches_reference_and_host(n):
    _, blen = _symbols(40 + n, n)
    got = _np(tbits.pack_meta7(_t(blen)))
    np.testing.assert_array_equal(got, np.asarray(rbits.pack_meta7(jnp.asarray(blen))))
    np.testing.assert_array_equal(got, rbits._pack_bitlens(blen))


def test_zigzag_matches_reference():
    d = np.array([0, 1, -1, 2, -2, 2**31 - 1, -(2**31), 12345, -98765], np.int32)
    z_t = tbits.zigzag_encode(torch.from_numpy(d))
    z_r = np.asarray(rbits.zigzag_encode(jnp.asarray(d)))
    np.testing.assert_array_equal(_np(z_t), z_r)
    np.testing.assert_array_equal(tbits.zigzag_decode(z_t).numpy(), d)
    np.testing.assert_array_equal(np.asarray(rbits.zigzag_decode(jnp.asarray(z_r))), d)


@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_property_pack_unpack_inverse(seed):
    """pack -> unpack is the identity on masked codes (0- and 64-bit slots)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    codes, blen = _symbols(seed, n)
    words, _, _ = tbits.pack_bits(_t(codes), _t(blen), 2 * n + 2)
    got, _ = tbits.unpack_symbols(words, _t(blen))
    b = torch.from_numpy(blen).to(torch.int64)
    want = torch.stack([
        tbits._u(_t(codes[:, 0])) & tbits.mask_bits(b.clamp(max=32)),
        tbits._u(_t(codes[:, 1])) & tbits.mask_bits((b - 32).clamp(min=0)),
    ], dim=1)
    np.testing.assert_array_equal(tbits._u(got).numpy(), want.numpy())


# ---------------------------------------------------------------------- crc --
@pytest.mark.parametrize("n", [0, 1, 9, 2048, 2049, 100_003])
def test_crc32c_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tbits.crc32c(data) == rbits.crc32c(data)
    assert tbits.crc32c(b"123456789") == 0xE3069283


# ------------------------------------------------------------------- frames --
def _blocks(seed: int, nblocks: int, lanes: int, per_lane: int, valid=None):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(nblocks):
        blen = rng.integers(0, 65, size=lanes * per_lane).astype(np.int32)
        words = _u32(rng, (2 * lanes * per_lane + 2,))
        v = lanes * per_lane if valid is None else valid[b]
        out.append((words, int(blen.sum()), blen, v))
    return out


def _frame_pair(integrity):
    blocks = _blocks(5, 4, 4, 16, valid=[64, 64, 64, 37])
    kw = dict(codec_id=7, lanes=4, per_lane=16, n_full=3, tail_per_lane=16,
              flush_slots=0, n_valid=3 * 64 + 37, blocks=blocks)
    ft, fr = tbits.build_frame(**kw), rbits.build_frame(**kw)
    ft.integrity = fr.integrity = integrity
    return ft, fr


@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_frame_bytes_identical_to_reference(integrity):
    ft, fr = _frame_pair(integrity)
    buf = fr.to_bytes()
    assert ft.to_bytes() == buf
    assert ft.wire_bytes == len(buf) == fr.wire_bytes


@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_frames_parse_across_both_ways(integrity):
    ft, fr = _frame_pair(integrity)
    ref_bytes, port_bytes = fr.to_bytes(), ft.to_bytes()
    back_t = tbits.Frame.from_bytes(ref_bytes)
    back_r = rbits.Frame.from_bytes(port_bytes)
    assert back_t.to_bytes() == ref_bytes
    assert back_r.to_bytes() == port_bytes
    np.testing.assert_array_equal(back_t.bitlen, back_r.bitlen)
    np.testing.assert_array_equal(back_t.payload, back_r.payload)
    assert back_t.integrity == integrity


@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_from_compacted_matches_build_frame(integrity):
    blocks = _blocks(6, 3, 4, 8)
    kw = dict(codec_id=5, lanes=4, per_lane=8, n_full=3, tail_per_lane=0,
              flush_slots=0, n_valid=96)
    oracle = rbits.build_frame(blocks=blocks, **kw)
    oracle.integrity = integrity
    got = tbits.Frame.from_compacted(
        **kw, block_bits=oracle.block_bits, block_valid=oracle.block_valid,
        payload=oracle.payload, packed_meta=rbits._pack_bitlens(oracle.bitlen),
        integrity=integrity,
    )
    assert got.to_bytes() == oracle.to_bytes()
    np.testing.assert_array_equal(got.bitlen, oracle.bitlen)


#: tests/test_bits_wire.py's golden header (the version-1 layout)
_GOLDEN_HEADER = bytes.fromhex(
    "46575343" "01000000" "07000000" "04000000"
    "10000000" "02000000" "00000000" "00000000"
    "80000000" "02000000" "1c000000"
)


def test_golden_header_bytes():
    rng = np.random.default_rng(1234)
    blocks = []
    for _ in range(2):
        blen = rng.integers(0, 33, size=64).astype(np.int32)
        words = rng.integers(0, 2**32, size=(2 * 64 + 2,), dtype=np.uint64)
        blocks.append((words.astype(np.uint32), int(blen.sum()), blen, 64))
    frame = tbits.build_frame(
        codec_id=7, lanes=4, per_lane=16, n_full=2, tail_per_lane=0,
        flush_slots=0, n_valid=128, blocks=blocks,
    )
    buf = frame.to_bytes()
    assert buf[: len(_GOLDEN_HEADER)] == _GOLDEN_HEADER
    assert tbits.Frame.from_bytes(buf).to_bytes() == buf


def test_frame_stream_resync_matches_reference():
    ft, _ = _frame_pair(None)
    fc, _ = _frame_pair("crc32c")
    good, crc = ft.to_bytes(), fc.to_bytes()
    corrupt = bytearray(crc)
    corrupt[-30] ^= 0x40  # payload bit flip: caught by the CRC trailer
    buf = b"junk!!" + good + bytes(corrupt) + b"\x00" * 7 + crc + good[: len(good) // 2]
    ts, rs = tbits.FrameStream(buf), rbits.FrameStream(buf)
    got_t = [f.to_bytes() for f in ts.frames()]
    got_r = [f.to_bytes() for f in rs.frames()]
    assert got_t == got_r == [good, crc]
    assert ts.resyncs == rs.resyncs
    assert [(o, type(e).__name__) for o, e in ts.errors] == [
        (o, type(e).__name__) for o, e in rs.errors
    ]


def test_frame_error_classes():
    ft, _ = _frame_pair("crc32c")
    buf = ft.to_bytes()
    with pytest.raises(tbits.FrameTruncatedError):
        tbits.parse_frame(buf[:20])
    with pytest.raises(tbits.FrameTruncatedError):
        tbits.parse_frame(_frame_pair(None)[0].to_bytes()[:-8])
    with pytest.raises(tbits.FrameHeaderError, match="magic"):
        tbits.parse_frame(b"\x00" * 64)
    bad = bytearray(buf)
    bad[100] ^= 1
    with pytest.raises(tbits.FrameIntegrityError):
        tbits.parse_frame(bytes(bad))
    unknown = bytearray(buf)
    unknown[4:8] = (tbits.FRAME_VERSION | (1 << 25)).to_bytes(4, "little")
    with pytest.raises(tbits.FrameFeatureError, match="unknown feature"):
        tbits.parse_frame(bytes(unknown))
    assert issubclass(tbits.FrameFeatureError, tbits.FrameHeaderError)
    assert issubclass(tbits.FrameError, ValueError)


def test_unported_features_raise_feature_error_naming_roadmap():
    """Wire features parse here once their ROADMAP item is ported. The
    entropy stage (A7): a reference entropy frame parses here, on the named
    device, and reserializes byte-identically; with no device and no GPU it
    raises. Dictionary ids (A8): a reference frame with a `dict_id` parses
    without a device and reserializes byte-identically, id included."""
    _, fr = _frame_pair(None)
    fr.apply_entropy()
    buf = fr.to_bytes()
    back = tbits.parse_frame(buf, device="cpu")
    assert back.to_bytes() == buf
    np.testing.assert_array_equal(back.payload, fr.payload)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbits.parse_frame(buf)
    _, fr = _frame_pair(None)
    fr.dict_id = ("sensors", 3)
    buf = fr.to_bytes()
    back = tbits.parse_frame(buf)
    assert back.dict_id == ("sensors", 3)
    assert back.to_bytes() == buf and back.wire_bytes == len(buf)
    np.testing.assert_array_equal(back.payload, fr.payload)


@pytest.mark.parametrize("corruption", ["length_word", "topic_length", "truncated", "utf8"])
def test_corrupt_dict_id_sections_raise_as_the_reference(corruption):
    """A damaged dict-id section raises the reference's FrameError class
    and text, never a raw numpy or unicode error."""
    _, fr = _frame_pair(None)
    fr.dict_id = ("sensors", 3)
    buf = bytearray(fr.to_bytes())
    off = 4 * (12 + 2 * fr.n_blocks)  # the section's first word
    if corruption == "length_word":
        buf[off : off + 4] = (2).to_bytes(4, "little")
    elif corruption == "topic_length":
        buf[off + 8 : off + 12] = (40).to_bytes(4, "little")
    elif corruption == "truncated":
        buf = buf[: off + 8]
    else:
        buf[off + 12] = 0xFF
    with pytest.raises(tbits.FrameError) as ours:
        tbits.parse_frame(bytes(buf))
    with pytest.raises(rbits.FrameError) as theirs:
        rbits.parse_frame(bytes(buf))
    assert (type(ours.value).__name__, str(ours.value)) == (type(theirs.value).__name__,
                                                            str(theirs.value))


@pytest.mark.parametrize("integrity", [None, "crc32c"])
def test_entropy_frames_byte_identical_and_parse_across(integrity):
    """`apply_entropy` gives the reference's bytes and wire size; each side
    parses the other's entropy frame back to the raw sections."""
    ft, fr = _frame_pair(integrity)
    ft.apply_entropy("cpu")
    fr.apply_entropy()
    buf = fr.to_bytes()
    assert ft.to_bytes() == buf and ft.wire_bytes == len(buf) == fr.wire_bytes
    np.testing.assert_array_equal(ft.entropy, fr.entropy)
    back_t = tbits.Frame.from_bytes(buf, device="cpu")
    back_r = rbits.Frame.from_bytes(ft.to_bytes())
    assert back_t.to_bytes() == buf == back_r.to_bytes()
    np.testing.assert_array_equal(back_t.bitlen, back_r.bitlen)
    np.testing.assert_array_equal(back_t.payload, back_r.payload)


def test_entropy_frame_corruption_raises_like_reference():
    """A flipped blob word surfaces as the reference's error class: the CRC
    trailer catches it when present, otherwise the blob decode does."""
    for integrity in (None, "crc32c"):
        ft, fr = _frame_pair(integrity)
        fr.apply_entropy()
        bad = bytearray(fr.to_bytes())
        bad[4 * (12 + 2 * 4) + 8] ^= 0x55  # a word of the blob's first section
        with pytest.raises(tbits.FrameError) as ours:
            tbits.parse_frame(bytes(bad), device="cpu")
        with pytest.raises(rbits.FrameError) as theirs:
            rbits.parse_frame(bytes(bad))
        assert type(ours.value).__name__ == type(theirs.value).__name__
        assert str(ours.value) == str(theirs.value)
