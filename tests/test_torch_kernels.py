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
    ops.dict_probe(codes[:2].contiguous(), torch.zeros((2, 16), dtype=torch.int32),
                   torch.zeros((2, 16), dtype=torch.uint8), idx_bits=4)
    grid = torch.zeros((1, 4, 8), dtype=torch.int32)
    freqs = torch.zeros(256, dtype=torch.int32)
    freqs[0] = 4096
    states, flags, _ = ops.rans_encode(grid, grid.bool(), freqs)
    ops.rans_decode(torch.zeros(0, dtype=torch.int32), freqs, states, states * 0, grid.bool(), 1)
    assert ops.launch_counts() == {
        "pack_blocks": 0, "unpack_blocks": 0, "compact_blocks": 0, "pack_meta7_blocks": 0,
        "dict_probe": 0, "rans_encode": 0, "rans_decode": 0,
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
