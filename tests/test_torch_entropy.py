"""The port's rANS entropy stage (`repro_torch.core.entropy`) against the
reference's (`repro.core.entropy`), on the CPU: the frequency tables, the
one-chunk scans (against the reference's scans and its Pallas kernels in
interpret mode), section and blob words, and the error messages for
truncated or corrupt sections. Inputs are made with numpy from a seed."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import entropy as rent
from repro.kernels import ops as rops
from repro_torch.core import bits as tbits
from repro_torch.core import entropy as tent
from repro_torch.kernels import ops

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")


def _hist(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "empty":
        return np.zeros(256, np.int64)
    if kind == "single":
        h = np.zeros(256, np.int64)
        h[17] = 512
        return h
    if kind == "tied":  # several equal maxima: the remainder goes to the first
        h = np.zeros(256, np.int64)
        h[[3, 40, 200]] = 1000
        h[[5, 6]] = 7
        return h
    if kind == "huge":  # totals past 2^17 take the downscale path
        return rng.integers(0, 1 << 22, 256)
    if kind == "sparse":
        h = np.zeros(256, np.int64)
        h[rng.choice(256, 9, replace=False)] = rng.integers(1, 50, 9)
        return h
    return np.bincount((rng.zipf(1.4, 5000) - 1).clip(0, 255), minlength=256)


@pytest.mark.parametrize("kind", ["empty", "single", "tied", "huge", "sparse", "zipf"])
def test_quantize_freqs_and_slot_table_match_reference(kind):
    h = _hist(kind)
    ours = tent.quantize_freqs(torch.from_numpy(h))
    theirs = np.asarray(rent.quantize_freqs(jnp.asarray(h, jnp.int32)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert int(ours.sum()) == tent.PROB_SCALE
    np.testing.assert_array_equal(
        tent.slot_table(ours).numpy(), np.asarray(rent.slot_table(jnp.asarray(theirs)))
    )


def test_constants_match_reference():
    for name in ("PROB_BITS", "PROB_SCALE", "RANS_L", "N_LANES", "CHUNK_BYTES", "ROWS",
                 "ENTROPY_KIND_RANS"):
        assert getattr(tent, name) == getattr(rent, name), name


def _chunks(seed: int, c: int, t_rows: int, fill: int):
    """C chunks' (T, 8) zipf byte grids, the first `fill` bytes real, and
    the table the stage would build over them."""
    rng = np.random.default_rng(seed)
    syms = (rng.zipf(1.6, size=(c, t_rows, 8)) - 1).clip(0, 255).astype(np.int32)
    mask = (np.arange(c * t_rows * 8) < fill).reshape(c, t_rows, 8)
    hist = np.bincount(syms.reshape(-1)[:fill], minlength=256)
    freqs = np.asarray(rent.quantize_freqs(jnp.asarray(hist, jnp.int32))).astype(np.int32)
    return syms, mask, freqs


def _stream(flags: np.ndarray, vals: np.ndarray):
    """Scatter every (chunk, lane)'s emissions at its exclusive-cumsum
    offset plus rank, as `_encode_device` does: (stream, offsets)."""
    c = flags.shape[0]
    counts = flags.sum(axis=1).reshape(-1)
    off = (np.cumsum(counts) - counts).reshape(c, 1, 8)
    rank = np.cumsum(flags, axis=1) - flags
    stream = np.zeros(int(counts.sum()), np.uint32)
    stream[(off + rank)[flags > 0]] = vals[flags > 0]
    return stream, off.reshape(c, 8).astype(np.int32)


@pytest.mark.parametrize("c,t_rows,fill", [(1, 1, 1), (1, 16, 100), (2, 64, 2 * 64 * 8 - 5), (3, 512, 3 * 4096 - 77)])
def test_encode_rows_matches_reference_scan_and_pallas(c, t_rows, fill):
    syms, mask, freqs = _chunks(c + t_rows, c, t_rows, fill)
    st, fl, va = ops.rans_encode(torch.from_numpy(syms), torch.from_numpy(mask),
                                 torch.from_numpy(freqs))
    for k in range(c):
        rs, rf, rv = rent.encode_rows(jnp.asarray(syms[k].astype(np.uint32)),
                                      jnp.asarray(mask[k]), jnp.asarray(freqs))
        np.testing.assert_array_equal(tbits.u32_numpy(st[k]), np.asarray(rs))
        np.testing.assert_array_equal(fl[k].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(tbits.u32_numpy(va[k]), np.asarray(rv))
        if t_rows <= 64:  # the interpreted Pallas kernel walks rows one by one
            ks, kf, kv = rops.rans_encode(jnp.asarray(syms[k]), jnp.asarray(mask[k]),
                                          jnp.asarray(freqs))
            np.testing.assert_array_equal(tbits.u32_numpy(st[k]), np.asarray(ks))
            np.testing.assert_array_equal(fl[k].numpy(), np.asarray(kf))
            np.testing.assert_array_equal(tbits.u32_numpy(va[k]), np.asarray(kv))


@pytest.mark.parametrize("c,t_rows,fill", [(1, 8, 60), (2, 64, 2 * 64 * 8 - 5), (3, 512, 3 * 4096 - 77)])
def test_decode_rows_matches_reference_and_inverts_encode(c, t_rows, fill):
    syms, mask, freqs = _chunks(c * 7 + t_rows, c, t_rows, fill)
    st, fl, va = ops.rans_encode(torch.from_numpy(syms), torch.from_numpy(mask),
                                 torch.from_numpy(freqs))
    stream, off = _stream(fl.numpy(), tbits.u32_numpy(va))
    got = ops.rans_decode(tbits.u32_tensor(stream, CPU), torch.from_numpy(freqs), st,
                          torch.from_numpy(off), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy()[mask], syms[mask])
    assert not got.numpy()[~mask].any()
    padded = np.zeros(max(stream.size, 1), np.uint32)
    padded[: stream.size] = stream
    for k in range(c):
        want = rent.decode_rows(
            jnp.asarray(padded), jnp.asarray(freqs), jnp.asarray(tbits.u32_numpy(st[k])),
            jnp.asarray(off[k]), jnp.asarray(mask[k]), rent.slot_table(jnp.asarray(freqs)),
        )
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
        if t_rows <= 64:
            kern = rops.rans_decode(jnp.asarray(padded), jnp.asarray(freqs),
                                    jnp.asarray(tbits.u32_numpy(st[k])), jnp.asarray(off[k]),
                                    jnp.asarray(mask[k]))
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(kern))


@pytest.mark.parametrize("c,t_rows,fill", [(1, 8, 60), (3, 512, 3 * 4096 - 77)])
def test_assemble_stream_matches_numpy_scatter(c, t_rows, fill):
    syms, mask, freqs = _chunks(c + 5 * t_rows, c, t_rows, fill)
    _, fl, va = ops.rans_encode(torch.from_numpy(syms), torch.from_numpy(mask),
                                torch.from_numpy(freqs))
    stream, counts = tent.assemble_stream(fl, va)
    want_stream, want_off = _stream(fl.numpy(), tbits.u32_numpy(va))
    np.testing.assert_array_equal(tbits.u32_numpy(stream), want_stream)
    np.testing.assert_array_equal(counts.numpy(), fl.numpy().sum(axis=1))
    np.testing.assert_array_equal(tent.lane_offsets(counts).numpy(), want_off)


def test_section_grid_masks_the_tail_and_quantizes_all_bytes():
    data = (np.random.default_rng(4).zipf(1.3, 2 * 4096 + 5) - 1).clip(0, 255).astype(np.uint8)
    syms, mask, freqs = tent.section_grid(data, CPU)
    assert syms.shape == mask.shape == (3, tent.ROWS, tent.N_LANES)
    np.testing.assert_array_equal(syms.numpy().reshape(-1)[: data.size], data)
    assert int(mask.sum()) == data.size and not syms.numpy().reshape(-1)[data.size:].any()
    want = rent.quantize_freqs(jnp.asarray(np.bincount(data, minlength=256), jnp.int32))
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(want))
    assert tent.decode_cap(3) == 4 * tent.CHUNK_BYTES


def test_decode_rows_reads_clip_to_cap_like_reference():
    """Garbage states and offsets past the stream: reads see zeros up to
    `cap` and the last entry beyond it, as over the reference's padded
    stream."""
    rng = np.random.default_rng(9)
    _, mask, freqs = _chunks(1, 2, 32, 2 * 32 * 8)
    states = rng.integers(1 << 16, 1 << 32, size=(2, 8), dtype=np.uint64).astype(np.uint32)
    stream = rng.integers(0, 1 << 16, size=40).astype(np.uint32)
    cap = 64
    off = np.array([[0, 5, 39, 40, 63, 64, 70, -3]] * 2, np.int32)
    got = ops.rans_decode(tbits.u32_tensor(stream, CPU), torch.from_numpy(freqs),
                          tbits.u32_tensor(states, CPU), torch.from_numpy(off),
                          torch.from_numpy(mask), cap)
    padded = np.zeros(cap, np.uint32)
    padded[: stream.size] = stream
    lut = rent.slot_table(jnp.asarray(freqs))
    for k in range(2):
        want = rent.decode_rows(jnp.asarray(padded), jnp.asarray(freqs), jnp.asarray(states[k]),
                                jnp.asarray(off[k]), jnp.asarray(mask[k]), lut)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


def test_constant_chunk_emits_nothing():
    syms = torch.zeros((2, 64, 8), dtype=torch.int32)
    freqs = tent.quantize_freqs(torch.bincount(syms.reshape(-1).long(), minlength=256))
    _, flags, _ = ops.rans_encode(syms, torch.ones_like(syms, dtype=torch.bool), freqs.int())
    assert int(flags.sum()) == 0


def _section_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "empty":
        return np.zeros(0, np.uint32)
    if kind == "one_word":
        return np.array([0x01020304], np.uint32)
    if kind == "random":  # incompressible: the raw fallback
        return rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    if kind == "constant":
        return np.full(2500, 7, np.uint32)
    if kind == "multi_chunk":  # 5 chunks, the last one partial
        return (rng.zipf(1.5, 4 * 1024 + 333).clip(0, 2**20)).astype(np.uint32)
    return (rng.zipf(1.3, 700).clip(0, 2**31)).astype(np.uint32)  # skewed


SECTIONS = ["empty", "one_word", "random", "constant", "multi_chunk", "skewed"]


@pytest.mark.parametrize("kind", SECTIONS)
def test_encode_section_words_identical_and_cross_decode(kind):
    raw = _section_input(kind)
    ours = tent.encode_section(raw, CPU)
    theirs = rent.encode_section(raw)
    np.testing.assert_array_equal(ours, theirs)
    if kind == "random":
        assert ours[0] == 0  # raw fallback
    back, used = tent.decode_section(theirs, raw.size, CPU)
    np.testing.assert_array_equal(back, raw)
    assert used == theirs.size


@pytest.mark.parametrize("meta_kind,payload_kind", [("skewed", "multi_chunk"), ("empty", "empty"),
                                                    ("one_word", "random"), ("constant", "skewed")])
def test_encode_blob_words_identical_and_cross_decode(meta_kind, payload_kind):
    meta, payload = _section_input(meta_kind), _section_input(payload_kind)
    ours = tent.encode_blob(meta, payload, CPU)
    np.testing.assert_array_equal(ours, rent.encode_blob(meta, payload))
    m, p = tent.decode_blob(ours, meta.size, payload.size, CPU)
    np.testing.assert_array_equal(m, meta)
    np.testing.assert_array_equal(p, payload)


def _mutations(sec: np.ndarray):
    yield "truncated_flag", sec[:0]
    yield "truncated_counts", sec[:2]
    yield "truncated_stream", sec[:-3]
    bad = sec.copy()
    bad[0] = 9
    yield "unknown_kind", bad
    bad = sec.copy()
    bad[2] += 1
    yield "chunk_count", bad
    bad = sec.copy()
    bad[3] ^= 0x10
    yield "freq_sum", bad
    bad = sec.copy()
    bad[1] += 2
    yield "lane_counts", bad
    raw = np.concatenate([[0], sec[1:4]]).astype(np.uint32)
    yield "truncated_raw", raw


def test_bad_sections_raise_reference_messages():
    raw = _section_input("multi_chunk")
    sec = rent.encode_section(raw)
    for name, bad in _mutations(sec):
        with pytest.raises(ValueError) as ours:
            tent.decode_section(bad, raw.size, CPU)
        with pytest.raises(ValueError) as theirs:
            rent.decode_section(bad, raw.size)
        assert str(ours.value) == str(theirs.value), name


def test_bad_blobs_raise_reference_messages():
    meta, payload = _section_input("skewed"), _section_input("constant")
    blob = rent.encode_blob(meta, payload)
    cases = [blob[:1], np.concatenate([[2], blob[1:]]), np.concatenate([blob, [0]])]
    for bad in cases:
        bad = np.asarray(bad, np.uint32)
        with pytest.raises(ValueError) as ours:
            tent.decode_blob(bad, meta.size, payload.size, CPU)
        with pytest.raises(ValueError) as theirs:
            rent.decode_blob(bad, meta.size, payload.size)
        assert str(ours.value) == str(theirs.value)
