"""The port's kernel wrappers (`repro_torch.kernels.ops`) against the
reference: on the CPU the wrappers run their plain versions, held bit-exact
against the `repro.kernels.ref` oracles and the Pallas kernels
(`repro.kernels.ops`, interpret mode) at the shapes of tests/test_kernels.py.
Tests marked `cuda` run the CUDA kernels against the plain versions and skip
without a GPU; they need neither jax nor the reference, which are imported
per test (`reference` fixture), so `pytest -m cuda` runs where jax is absent."""
import numpy as np
import pytest
import torch

from repro_torch.core import bits as tbits
from repro_torch.core import dictstore
from repro_torch.core.algorithms import make_codec
from repro_torch.kernels import ops, ref

RNG_SEED = 11


@pytest.fixture
def reference():
    """(jax.numpy, repro.core.bits, repro.kernels.ops, repro.kernels.ref)."""
    import jax.numpy as jnp
    from repro.core import bits as rbits
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref

    return jnp, rbits, rops, rref


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _masked_symbols(seed: int, n: int):
    """Codes masked to their bitlens (0..64, with 0 and 64 present)."""
    rng = np.random.default_rng(seed)
    codes = _u32(rng, (n, 2))
    blen = rng.integers(0, 65, size=n).astype(np.int32)
    blen[:2] = [0, 64]
    lo = np.where(blen >= 32, 0xFFFFFFFF, (1 << np.minimum(blen, 31)) - 1)
    hi_n = np.clip(blen - 32, 0, 32)
    hi = np.where(hi_n >= 32, 0xFFFFFFFF, (1 << np.minimum(hi_n, 31)) - 1)
    codes[:, 0] &= lo.astype(np.uint32)
    codes[:, 1] &= hi.astype(np.uint32)
    return codes, blen


def _t(a):
    a = np.asarray(a)
    return tbits.u32_tensor(a, "cpu") if a.dtype == np.uint32 else torch.from_numpy(a.copy())


@pytest.fixture
def cuda():
    """The CUDA device, or a skip when there is none (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# ------------------------------------------------------------------ bitpack --
@pytest.mark.parametrize("n,block", [(256, 64), (512, 128), (1024, 256), (2048, 512)])
def test_pack_blocks_matches_oracle_and_pallas(reference, n, block):
    jnp, rbits, rops, rref = reference
    rng = np.random.default_rng(RNG_SEED + n)
    codes = _u32(rng, (n, 2))
    blen = rng.integers(0, 65, size=n).astype(np.int32)
    w_t, b_t = ops.pack_blocks(_t(codes), _t(blen), block=block)
    w_r, b_r = rref.pack_blocks_ref(jnp.asarray(codes), jnp.asarray(blen), block=block)
    np.testing.assert_array_equal(tbits.u32_numpy(w_t), np.asarray(w_r))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))
    if n <= 512:  # the interpreted Pallas kernel is slow; the oracle covers the rest
        w_k, b_k = rops.pack_blocks(jnp.asarray(codes), jnp.asarray(blen), block=block)
        np.testing.assert_array_equal(tbits.u32_numpy(w_t), np.asarray(w_k))
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_k))


@pytest.mark.parametrize("lanes,per_lane", [(4, 8), (4, 444), (2, 33)])
def test_pack_blocks_at_wire_width_matches_pack_bits(reference, lanes, per_lane):
    """At OW = 2S+2 the packer meets the frame's contract, `bits.pack_bits`
    on each micro-batch block."""
    jnp, rbits, rops, rref = reference
    s = lanes * per_lane
    codes, blen = _masked_symbols(s, 3 * s)
    w_t, b_t = ops.pack_blocks(_t(codes), _t(blen), block=s, out_words=2 * s + 2)
    for b in range(3):
        w_r, tot_r, _ = rbits.pack_bits(
            jnp.asarray(codes[b * s : (b + 1) * s]), jnp.asarray(blen[b * s : (b + 1) * s]),
            2 * s + 2,
        )
        np.testing.assert_array_equal(tbits.u32_numpy(w_t[b]), np.asarray(w_r))
        assert int(b_t[b]) == int(tot_r)


# ---------------------------------------------------------------- bitunpack --
@pytest.mark.parametrize("n,block", [(256, 64), (512, 128), (1024, 256)])
def test_unpack_blocks_matches_oracle_and_pallas(reference, n, block):
    jnp, rbits, rops, rref = reference
    codes, blen = _masked_symbols(RNG_SEED + n, n)
    words, _ = rops.pack_blocks(jnp.asarray(codes), jnp.asarray(blen), block=block)
    words = np.asarray(words)
    got = ops.unpack_blocks(_t(words), _t(blen), block=block)
    np.testing.assert_array_equal(tbits.u32_numpy(got), codes)
    want_r = rref.unpack_blocks_ref(jnp.asarray(words), jnp.asarray(blen), block)
    np.testing.assert_array_equal(tbits.u32_numpy(got), np.asarray(want_r))
    if n <= 512:
        want_k = rops.unpack_blocks(jnp.asarray(words), jnp.asarray(blen), block=block)
        np.testing.assert_array_equal(tbits.u32_numpy(got), np.asarray(want_k))


def test_unpack_blocks_random_words_match_oracle(reference):
    """Garbage words and bitlens (reads past each row's end included)."""
    jnp, rbits, rops, rref = reference
    rng = np.random.default_rng(5)
    words = _u32(rng, (4, 2 * 64 + 1))
    blen = rng.integers(0, 65, size=4 * 64).astype(np.int32)
    got = ops.unpack_blocks(_t(words), _t(blen))
    want = rref.unpack_blocks_ref(jnp.asarray(words), jnp.asarray(blen), 64)
    np.testing.assert_array_equal(tbits.u32_numpy(got), np.asarray(want))


# ------------------------------------------------------------ frame_compact --
@pytest.mark.parametrize("nblocks,ow", [(1, 34), (4, 130), (16, 258), (32, 66)])
def test_compact_blocks_matches_oracle_and_pallas(reference, nblocks, ow):
    jnp, rbits, rops, rref = reference
    rng = np.random.default_rng(RNG_SEED + nblocks)
    words = _u32(rng, (nblocks, ow))
    nbits = rng.integers(0, 32 * (ow - 2) + 1, size=nblocks).astype(np.int32)
    pay_t, tot_t = ops.compact_blocks(_t(words), _t(nbits))
    pay_r, tot_r = rref.compact_blocks_ref(jnp.asarray(words), jnp.asarray(nbits))
    pay_k, tot_k = rops.frame_compact(jnp.asarray(words), jnp.asarray(nbits))
    np.testing.assert_array_equal(tbits.u32_numpy(pay_t), np.asarray(pay_r))
    np.testing.assert_array_equal(tbits.u32_numpy(pay_t), np.asarray(pay_k))
    assert int(tot_t) == int(tot_r) == int(tot_k)


def test_compact_blocks_payload_is_sliced_prefixes():
    rng = np.random.default_rng(6)
    nblocks, ow = 6, 42
    words = _u32(rng, (nblocks, ow))
    nbits = np.array([0, 1, 31, 32, 33, 32 * (ow - 2)], np.int32)
    pay, tot = ops.compact_blocks(_t(words), _t(nbits))
    expect = np.concatenate([w[: (int(b) + 31) // 32] for w, b in zip(words, nbits)])
    pay = tbits.u32_numpy(pay)
    assert int(tot) == expect.size
    np.testing.assert_array_equal(pay[: int(tot)], expect)
    assert not pay[int(tot):].any()


@pytest.mark.parametrize("nblocks,symbols", [(1, 32), (4, 256), (8, 96), (3, 148)])
def test_pack_meta7_blocks_matches_oracle_pallas_and_host(reference, nblocks, symbols):
    jnp, rbits, rops, rref = reference
    rng = np.random.default_rng(RNG_SEED + symbols)
    bl = rng.integers(0, 65, size=(nblocks, symbols)).astype(np.int32)
    got = tbits.u32_numpy(ops.pack_meta7_blocks(_t(bl)))
    np.testing.assert_array_equal(got, np.asarray(rref.pack_meta7_ref(jnp.asarray(bl))))
    np.testing.assert_array_equal(got, np.asarray(rops.pack_meta7(jnp.asarray(bl))))
    for row, row_bl in zip(got, bl):
        np.testing.assert_array_equal(row, rbits._pack_bitlens(row_bl))


def test_pack_meta7_rows_concatenate_when_aligned(reference):
    jnp, rbits, rops, rref = reference
    bl = np.random.default_rng(7).integers(0, 65, size=(5, 64)).astype(np.int32)
    rows = tbits.u32_numpy(ops.pack_meta7_blocks(_t(bl)))
    np.testing.assert_array_equal(rows.reshape(-1), rbits._pack_bitlens(bl.ravel()))


# ---------------------------------------------------------------- delta_nuq --
@pytest.mark.parametrize("s,t,sublanes,t_tile", [(8, 128, 8, 128), (16, 256, 8, 128), (32, 512, 16, 256)])
@pytest.mark.parametrize("qbits", [4, 8])
def test_adpcm_encode_matches_pallas(reference, s, t, sublanes, t_tile, qbits):
    """B6's contract on the CPU (its plain version) against the Pallas
    kernel in interpret mode, at tests/test_kernels.py's shapes: equal."""
    jnp, rbits, rops, rref = reference
    x = np.random.default_rng(s + qbits).normal(0, 0.3, size=(s, t)).astype(np.float32)
    k = np.asarray(rops.adpcm_encode(jnp.asarray(x), qbits=qbits, dmax=1.0, sublanes=sublanes,
                                     t_tile=t_tile))
    ours = ops.adpcm_encode(torch.from_numpy(x), qbits=qbits, dmax=1.0, sublanes=sublanes,
                            t_tile=t_tile)
    np.testing.assert_array_equal(tbits.u32_numpy(ours), k)
    r = np.asarray(rref.delta_nuq_encode_ref(jnp.asarray(x), qbits=qbits, dmax=1.0, mu=255.0,
                                             t_tile=t_tile))
    np.testing.assert_array_equal(k, r)


@pytest.mark.parametrize("qbits", [6, 8])
def test_adpcm_decode_matches_pallas(reference, qbits):
    """B7's contract on the CPU against the Pallas kernel in interpret mode
    on the Pallas encoder's codes, tolerance 0 (the reference's own test
    holds its oracle only to 1e-6)."""
    jnp, rbits, rops, rref = reference
    x = np.cumsum(np.random.default_rng(qbits).normal(0, 0.01, size=(8, 256)), axis=1)
    x = x.astype(np.float32)
    codes = np.asarray(rops.adpcm_encode(jnp.asarray(x), qbits=qbits, dmax=0.1, t_tile=128))
    ours_codes = ops.adpcm_encode(torch.from_numpy(x), qbits=qbits, dmax=0.1, t_tile=128)
    np.testing.assert_array_equal(tbits.u32_numpy(ours_codes), codes)
    xhat = np.asarray(rops.adpcm_decode(jnp.asarray(codes), qbits=qbits, dmax=0.1, t_tile=128))
    ours = ops.adpcm_decode(_t(codes), qbits=qbits, dmax=0.1, t_tile=128).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), xhat.view(np.uint32))
    assert np.abs(ours - x).max() < 0.05


def test_adpcm_wrappers_check_their_inputs():
    x = torch.zeros((8, 128), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        ops.adpcm_encode(x.double())
    with pytest.raises(ValueError, match="tile"):
        ops.adpcm_encode(x[:, :100].contiguous())
    with pytest.raises(ValueError, match="qbits"):
        ops.adpcm_decode(x.to(torch.int32), qbits=1)
    blocks = torch.zeros((2, 4, 8), dtype=torch.int32)
    xhat, init = torch.zeros(4), torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="lanes"):
        ops.adpcm_lane_encode(blocks, xhat[:3].contiguous(), init, 8, 2.0**24, 2.0**21, 255.0, 8)
    with pytest.raises(TypeError, match="bool"):
        ops.adpcm_lane_decode(torch.zeros((2, 4, 8, 2), dtype=torch.int32), xhat, init.int(),
                              8, 2.0**24, 2.0**21, 255.0)


# ------------------------------------------------------------------ wrappers --
def test_wrappers_check_inputs_and_do_not_count_cpu_calls():
    ops.reset_launches()
    codes = torch.zeros((64, 2), dtype=torch.int32)
    blen = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.pack_blocks(codes.to(torch.int64), blen, block=32)
    with pytest.raises(ValueError, match="multiple"):
        ops.pack_blocks(codes, blen, block=48)
    with pytest.raises(ValueError, match="contiguous"):
        ops.unpack_blocks(torch.zeros((4, 8), dtype=torch.int32).t(), blen)
    with pytest.raises(ValueError, match="nbits"):
        ops.compact_blocks(torch.zeros((4, 8), dtype=torch.int32), blen[:3])
    with pytest.raises(ValueError, match="dims"):
        ops.pack_meta7_blocks(blen)
    ops.pack_blocks(codes, blen, block=32)
    ops.pack_blocks_meta7(codes, blen, block=32)
    ops.dict_probe(codes[:2].contiguous(), torch.zeros((2, 16), dtype=torch.int32),
                   torch.zeros((2, 16), dtype=torch.uint8), idx_bits=4)
    dstate = (torch.zeros((2, 16), dtype=torch.int32), torch.zeros((2, 16), dtype=torch.uint8),
              torch.full((2, 16), -1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    dcodes = ops.dict_chunk_encode(codes.view(4, 2, 16), *dstate, idx_bits=4)[0]
    ops.dict_chunk_decode(dcodes, *dstate, idx_bits=4)
    grid = torch.zeros((1, 4, 8), dtype=torch.int32)
    freqs = torch.zeros(256, dtype=torch.int32)
    freqs[0] = 4096
    states, flags, _ = ops.rans_encode(grid, grid.bool(), freqs)
    ops.rans_decode(torch.zeros(0, dtype=torch.int32), freqs, states, states * 0, grid.bool(), 1)
    sec_states, sec_counts, sec_words, sec_total = ops.rans_section_encode(
        torch.zeros(5000, dtype=torch.uint8), freqs)
    ops.rans_section_decode(sec_words[: (int(sec_total) + 1) // 2], int(sec_total), freqs,
                            sec_states, sec_counts, 5000)
    ops.adpcm_decode(ops.adpcm_encode(torch.zeros((8, 128))))
    lane = torch.zeros((1, 4, 8), dtype=torch.int32)
    xhat, init = torch.zeros(4), torch.zeros(4, dtype=torch.bool)
    codes, _, _, _ = ops.adpcm_lane_encode(lane, xhat, init, 8, 2.0**24, 2.0**21, 255.0, 8)
    ops.adpcm_lane_decode(codes, xhat, init, 8, 2.0**24, 2.0**21, 255.0)
    ops.flash_attention_fwd(torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16)),
                            torch.zeros((1, 8, 2, 16)))
    ops.flash_attention_fwd_tc(*(torch.zeros(s, dtype=torch.bfloat16)
                                 for s in ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))))
    assert ops.launch_counts() == {
        "pack_blocks": 0, "pack_blocks_meta7": 0, "unpack_blocks": 0, "compact_blocks": 0,
        "pack_meta7_blocks": 0, "dict_probe": 0, "dict_chunk_encode": 0, "dict_chunk_decode": 0,
        "rans_encode": 0, "rans_section_encode": 0, "rans_decode": 0, "rans_section_decode": 0,
        "adpcm_encode": 0,
        "adpcm_decode": 0, "adpcm_lane_encode": 0, "adpcm_lane_encode_serial": 0,
        "adpcm_lane_decode": 0, "adpcm_lane_decode_serial": 0,
        "flash_attention_fwd": 0, "flash_attention_fwd_tc": 0,
    }


# ---------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("nblocks,symbols,out_words", [(128, 2048, 4098), (1, 1776, 3554), (16, 256, None)])
def test_cuda_kernels_match_plain_versions(cuda, nblocks, symbols, out_words):
    codes, blen = _masked_symbols(symbols, nblocks * symbols)
    c, b = _t(codes).to(cuda), _t(blen).to(cuda)
    ops.reset_launches()
    words, nbits = ops.pack_blocks(c, b, block=symbols, out_words=out_words)
    w_ref, n_ref = ref.pack_blocks_ref(c, b, symbols, out_words)
    assert torch.equal(words, w_ref) and torch.equal(nbits, n_ref)
    back = ops.unpack_blocks(words, b)
    assert torch.equal(back, ref.unpack_blocks_ref(words, b)) and torch.equal(back, c)
    pay, tot = ops.compact_blocks(words, nbits)
    p_ref, t_ref = ref.compact_blocks_ref(words, nbits)
    assert torch.equal(pay, p_ref) and int(tot) == int(t_ref)
    meta = ops.pack_meta7_blocks(b.view(nblocks, symbols))
    assert torch.equal(meta, ref.pack_meta7_ref(b.view(nblocks, symbols)))
    counts = ops.launch_counts()
    assert all(counts[k] == 1 for k in ("pack_blocks", "unpack_blocks", "compact_blocks",
                                        "pack_meta7_blocks"))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,idx_bits", [(1, 12), (4, 12), (4, 10)])
def test_cuda_dict_probe_matches_plain_version(cuda, lanes, idx_bits):
    rng = np.random.default_rng(lanes + idx_bits)
    ts = 1 << idx_bits
    x = torch.from_numpy(rng.integers(0, 3 * ts, (lanes, 512)).astype(np.int32)).to(cuda)
    table = torch.from_numpy(rng.integers(0, 3 * ts, (lanes, ts)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy((rng.random((lanes, ts)) < 0.7).astype(np.uint8)).to(cuda)
    ops.reset_launches()
    got = ops.dict_probe(x, table, valid, idx_bits)
    want = ref.probe_ref(x, table, valid, idx_bits)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts()["dict_probe"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,idx_bits,b,c", [(1, 12, 512, 7), (4, 12, 512, 128), (4, 10, 333, 7),
                                                (4, 4, 512, 16)])
def test_cuda_dict_chunk_kernels_match_plain_versions(cuda, lanes, idx_bits, b, c):
    """B5's codec form against its plain versions in two calls, the state
    carried from a warm start: symbols, values and every state tensor; one
    launch per call and direction."""
    rng = np.random.default_rng(lanes * idx_bits + b)
    ts = 1 << idx_bits
    vals = (rng.integers(0, 2 * ts, (2, c, lanes, b)) * 2654435).astype(np.uint32)
    vals[rng.random(vals.shape) < 0.1] = 2**31 + 5
    state = [_t(rng.integers(0, 2 * ts, (lanes, ts)).astype(np.uint32) * np.uint32(2654435)),
             torch.from_numpy((rng.random((lanes, ts)) < 0.7).astype(np.uint8)),
             torch.from_numpy(rng.integers(-1, 10**6, (lanes, ts)).astype(np.int32)),
             torch.from_numpy(np.full(lanes, 2**31 - 1000, np.int32))]
    enc = {"card": [t.to(cuda) for t in state], "plain": [t.to(cuda) for t in state]}
    dec = {k: list(v) for k, v in enc.items()}
    ops.reset_launches()
    for part in vals:
        blocks = _t(part).to(cuda)
        codes, bitlen, *enc["card"] = ops.dict_chunk_encode(blocks, *enc["card"], idx_bits)
        p_codes, p_bitlen, *enc["plain"] = ref.dict_chunk_encode_ref(blocks, *enc["plain"], idx_bits)
        assert torch.equal(codes, p_codes) and torch.equal(bitlen, p_bitlen)
        assert all(torch.equal(g, w) for g, w in zip(enc["card"], enc["plain"]))
        x, *dec["card"] = ops.dict_chunk_decode(codes, *dec["card"], idx_bits)
        p_x, *dec["plain"] = ref.dict_chunk_decode_ref(codes, *dec["plain"], idx_bits)
        assert torch.equal(x, p_x) and torch.equal(x, blocks)
        assert all(torch.equal(g, w) for g, w in zip(dec["card"], dec["plain"]))
    counts = ops.launch_counts()
    assert (counts["dict_chunk_encode"], counts["dict_chunk_decode"], counts["dict_probe"]) == (2, 2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits,b,c", [(12, 512, 128), (8, 333, 7)])
def test_cuda_seeded_dict_chunk_kernels_match_plain_versions(cuda, idx_bits, b, c):
    """B5's codec form from a seeded state, as `TrainedDict.seed_state`
    gives it, against its plain versions over a full chunk: symbols,
    values and every state tensor; one launch per direction."""
    rng = np.random.default_rng(idx_bits + b)

    def zipf(n):
        return ((rng.zipf(1.3, size=n) - 1) % 2000).astype(np.uint32) * np.uint32(1007)

    art = dictstore.train_dict(zipf(20000), idx_bits=idx_bits)
    codec = make_codec("tdic32", idx_bits=idx_bits).seed_dictionary(art)
    state = codec.kernel_state(art.seed_state(4, cuda))
    blocks = tbits.u32_tensor(zipf(c * 4 * b).reshape(c, 4, b), cuda)
    ops.reset_launches()
    codes, bitlen, *enc = ops.dict_chunk_encode(blocks, *state, idx_bits)
    p_codes, p_bitlen, *p_enc = ref.dict_chunk_encode_ref(blocks, *state, idx_bits)
    assert torch.equal(codes, p_codes) and torch.equal(bitlen, p_bitlen)
    assert all(torch.equal(g, w) for g, w in zip(enc, p_enc))
    x, *dec = ops.dict_chunk_decode(codes, *state, idx_bits)
    p_x, *p_dec = ref.dict_chunk_decode_ref(codes, *state, idx_bits)
    assert torch.equal(x, p_x) and torch.equal(x, blocks)
    assert all(torch.equal(g, w) for g, w in zip(dec, p_dec))
    counts = ops.launch_counts()
    assert (counts["dict_chunk_encode"], counts["dict_chunk_decode"]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,fill", [(1, 100), (3, 3 * 4096 - 77), (2, 2 * 4096)])
def test_cuda_rans_kernels_match_plain_versions(cuda, chunks, fill):
    from repro_torch.core import entropy

    rng = np.random.default_rng(chunks)
    data = (rng.zipf(1.6, chunks * 4096) - 1).clip(0, 255).astype(np.int32)
    syms = torch.from_numpy(data).to(cuda).view(chunks, 512, 8)
    mask = (torch.arange(chunks * 4096, device=cuda) < fill).view(chunks, 512, 8)
    freqs = entropy.quantize_freqs(
        torch.bincount(syms.reshape(-1)[:fill].long(), minlength=256)
    ).int()
    ops.reset_launches()
    enc = ops.rans_encode(syms, mask, freqs)
    assert all(torch.equal(a, b) for a, b in zip(enc, ref.rans_encode_ref(syms, mask, freqs)))
    states, flags, vals = enc
    counts = flags.sum(1).reshape(-1).long()
    off = (torch.cumsum(counts, 0) - counts).view(chunks, 8)
    rank = torch.cumsum(flags, 1).long() - flags
    pos = torch.where(flags > 0, off.view(chunks, 1, 8) + rank, chunks * 4096)
    stream = torch.zeros(chunks * 4096 + 1, dtype=torch.int32, device=cuda)
    stream = stream.scatter_(0, pos.reshape(-1), vals.reshape(-1))[: int(counts.sum())]
    off = off.int()
    got = ops.rans_decode(stream, freqs, states, off, mask, chunks * 4096)
    assert torch.equal(got, ref.rans_decode_ref(stream, chunks * 4096, freqs, states, off, mask))
    assert torch.equal(got, torch.where(mask, syms, 0))
    assert ops.launch_counts()["rans_encode"] == 1 and ops.launch_counts()["rans_decode"] == 1


def _ecg_blocks(chunks: int, lanes: int = 4, b: int = 512):
    from repro_torch.data import make_dataset

    v = make_dataset("ecg", n_tuples=chunks * lanes * b, seed=7).stream()
    return v[: chunks * lanes * b].reshape(chunks, lanes, b)


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("s,t,t_tile", [(8, 128, 128), (32, 512, 256), (1024, 4096, 128)])
def test_cuda_adpcm_contract_matches_plain_versions(cuda, qbits, s, t, t_tile):
    x = np.cumsum(np.random.default_rng(qbits).normal(0, 0.05, size=(s, t)), axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    ops.reset_launches()
    codes = ops.adpcm_encode(x, qbits=qbits, dmax=0.2, t_tile=t_tile)
    assert torch.equal(codes, ref.delta_nuq_encode_ref(x, qbits, 0.2, 255.0, t_tile))
    back = ops.adpcm_decode(codes, qbits=qbits, dmax=0.2, t_tile=t_tile)
    want = ref.delta_nuq_decode_ref(codes, qbits, 0.2, 255.0, t_tile)
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))
    counts = ops.launch_counts()
    assert counts["adpcm_encode"] == 1 and counts["adpcm_decode"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [4, 8, 12])
def test_cuda_adpcm_lane_kernels_match_plain_versions(cuda, qbits):
    """The codec form over two calls of 2 blocks each (state carried), ECG
    calibrated on the stream's first 8,192 tuples."""
    from repro_torch.core.calibration import calibrated_kwargs

    blocks = _ecg_blocks(4, b=64)
    kw = calibrated_kwargs("adpcm", blocks.reshape(-1)[:8192])
    args = (qbits, kw["vmax"], kw["dmax"], 255.0)
    dev_blocks = _t(blocks).to(cuda)
    xhat, init = torch.zeros(4, device=cuda), torch.zeros(4, dtype=torch.bool, device=cuda)
    st_k, st_p, st_dk, st_dp = (xhat, init), (xhat, init), (xhat, init), (xhat, init)
    ops.reset_launches()
    for half in (dev_blocks[:2], dev_blocks[2:]):
        half = half.contiguous()
        codes, blen, *st_k = ops.adpcm_lane_encode(half, *st_k, *args, qbits)
        p_codes, p_blen, *st_p = ref.adpcm_lane_encode_ref(half, *st_p, *args, qbits)
        assert torch.equal(codes, p_codes) and torch.equal(blen, p_blen)
        assert all(torch.equal(a, b) for a, b in zip(st_k, st_p))
        x, *st_dk = ops.adpcm_lane_decode(codes, *st_dk, *args)
        p_x, *st_dp = ref.adpcm_lane_decode_ref(codes, *st_dp, *args)
        assert torch.equal(x, p_x) and all(torch.equal(a, b) for a, b in zip(st_dk, st_dp))
    counts = ops.launch_counts()
    # this calibration's table may not be integral: the decode runs where the rule says
    decode = ops.delta_nuq.lane_decode_kernel(qbits, kw["vmax"], kw["dmax"], 255.0)
    assert counts["adpcm_lane_encode"] == 2 and counts[decode] == 2


def _lane_stream(name: str, n: int) -> tuple:
    """(uint32[n], vmax, dmax): ECG after its calibration window, uniform
    noise (also at a dmax that is not an integer, where the kernel walks in
    float32 with the binary search), a square wave past both bounds, and a
    ramp no guess converges on."""
    t = np.arange(n)
    if name == "ecg":
        from repro_torch.data import make_dataset

        return make_dataset("ecg", n_tuples=8192 + n, seed=7).stream()[8192: 8192 + n], 1841.0, 358.0
    if name == "noise":
        return np.random.default_rng(5).integers(0, 1842, n).astype(np.uint32), 1841.0, 358.0
    if name == "noise_frac_dmax":
        return np.random.default_rng(5).integers(0, 1842, n).astype(np.uint32), 1841.0, 355.812
    if name == "square":
        return np.where((t // 37) % 2 == 0, 0, 4000).astype(np.uint32), 1841.0, 358.0
    return (5 + 3 * t).astype(np.uint32), float(2**24), 1.0  # the ramp


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1024, 333])
@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("name", ["ecg", "noise", "noise_frac_dmax", "square", "ramp"])
def test_cuda_speculative_encode_matches_serial_kernel_and_plain_version(cuda, name, qbits, b):
    """The speculative encode against the serial kernel over 24 blocks of
    4 x b (3 tiles of 8,192 tuples per lane at b = 1024; b = 333 takes the
    4-byte loads and stores), state carried into a second call, and
    against the plain version on the first 2 blocks."""
    values, vmax, dmax = _lane_stream(name, 24 * 4 * b)
    blocks = _t(values.reshape(24, 4, b)).to(cuda)
    args = (qbits, vmax, dmax, 255.0, 8 * ((qbits + 7) // 8))
    st_k = st_s = (torch.zeros(4, device=cuda), torch.zeros(4, dtype=torch.bool, device=cuda))
    ops.reset_launches()
    for part in (blocks[:2], blocks[2:]):
        part = part.contiguous()
        got = ops.adpcm_lane_encode(part, *st_k, *args)
        want = ops.adpcm_lane_encode_serial(part, *st_s, *args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
        assert torch.equal(got[3], want[3])
        if part.shape[0] == 2:
            plain = ref.adpcm_lane_encode_ref(part, *st_s, *args)
            assert all(torch.equal(a, b) for a, b in zip(got[:2], plain[:2]))
        st_k, st_s = got[2:], want[2:]
    counts = ops.launch_counts()
    assert counts["adpcm_lane_encode"] == 2 and counts["adpcm_lane_encode_serial"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("vmax,dmax", [(1841.0, 358.0), (float(2**24), 2.0**21), (float(2**24), 2.0**26)])
def test_cuda_scan_decode_matches_serial_kernel_and_plain_version(cuda, qbits, vmax, dmax):
    """Random codes (clips at both bounds), fresh and then carried: the scan
    decode against the serial kernel and the plain version."""
    rng = np.random.default_rng(qbits)
    w = rng.integers(0, 1 << qbits, (6, 4, 512)).astype(np.uint32)
    w[0, :, 0] = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    codes = np.zeros((6, 4, 512, 2), np.uint32)
    codes[..., 0] = w
    codes = _t(codes).to(cuda)
    args = (qbits, vmax, dmax, 255.0)
    st_k = st_s = st_p = (torch.zeros(4, device=cuda), torch.zeros(4, dtype=torch.bool, device=cuda))
    ops.reset_launches()
    for part in (codes[:3].contiguous(), codes[3:].contiguous()):
        got = ops.adpcm_lane_decode(part, *st_k, *args)
        want = ops.adpcm_lane_decode_serial(part, *st_s, *args)
        plain = ref.adpcm_lane_decode_ref(part, *st_p, *args)
        for other in (want, plain):
            assert torch.equal(got[0], other[0]) and torch.equal(got[2], other[2])
            assert torch.equal(got[1].view(torch.int32), other[1].view(torch.int32))
        st_k, st_s, st_p = got[1:], want[1:], plain[1:]
    counts = ops.launch_counts()
    assert counts["adpcm_lane_decode"] == 2 and counts["adpcm_lane_decode_serial"] == 2


@pytest.mark.cuda
def test_cuda_decode_outside_the_rule_walks_serially(cuda):
    """A non-integral table (calibrated dmax 355.812) goes to the serial
    kernel; inside the rule, carried states that are not integers in
    [0, vmax] (and -0.0) are walked serially by the scan kernel itself."""
    rng = np.random.default_rng(9)
    codes = np.zeros((4, 4, 256, 2), np.uint32)
    codes[..., 0] = rng.integers(0, 256, (4, 4, 256))
    codes = _t(codes).to(cuda)
    ops.reset_launches()
    init = torch.ones(4, dtype=torch.bool, device=cuda)
    xhat = torch.tensor([3.0, 17.5, 2000.0, -0.0], device=cuda)
    for dmax, kernel in ((355.812, "adpcm_lane_decode_serial"), (358.0, "adpcm_lane_decode")):
        got = ops.adpcm_lane_decode(codes, xhat, init, 8, 1841.0, dmax, 255.0)
        plain = ref.adpcm_lane_decode_ref(codes, xhat, init, 8, 1841.0, dmax, 255.0)
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32))
        assert ops.launch_counts()[kernel] == 1
