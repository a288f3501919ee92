"""The port's stateful codecs of the second slice against the reference's,
on the CPU: Tdic32 (the B5 probe's plain version, both modes, state
evolution, the shared-state merge) and RLE (encode, flush, stream-scope
decode). Inputs are made with numpy from a seed and given to both."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import algorithms as ralg
from repro.core import pipeline as rpipe
from repro.kernels import dict_hash as rhash
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import algorithms as talg
from repro_torch.core import bits as tbits
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import dict_hash as thash
from repro_torch.kernels import ops

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
LANES = 4


def _t(a):
    a = np.asarray(a)
    return tbits.u32_tensor(a, CPU) if a.dtype == np.uint32 else torch.from_numpy(a.copy())


def _ref_state_np(state):
    return None if state is None else {k: np.asarray(v) for k, v in state.items()}


def _assert_same_state(codec, ours, theirs):
    ours = talg.state_to_numpy(codec, ours)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _dict_values(seed: int, shape, card: int = 300) -> np.ndarray:
    """Values from a small alphabet (hits, collisions and evictions) with a
    few full-range literals."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, card, size=shape).astype(np.uint32) * np.uint32(2654435)
    wide = rng.random(shape) < 0.1
    v[wide] = rng.integers(0, 2**32, size=int(wide.sum()), dtype=np.uint64).astype(np.uint32)
    return v


# -------------------------------------------------------------------- probe --
@pytest.mark.parametrize("n,block,idx_bits", [(512, 128, 12), (1024, 512, 12), (512, 256, 10)])
def test_probe_matches_reference_oracle_and_pallas(n, block, idx_bits):
    rng = np.random.default_rng(n + idx_bits)
    ts = 1 << idx_bits
    x = rng.integers(0, 5000, size=n).astype(np.uint32)
    table = rng.integers(0, 5000, size=ts).astype(np.uint32)
    valid = (rng.random(ts) < 0.7).astype(np.uint8)
    got = ops.dict_probe(_t(x)[None], _t(table)[None], _t(valid)[None], idx_bits)
    want = rref.probe_ref(jnp.asarray(x), jnp.asarray(table), jnp.asarray(valid), idx_bits)
    kern = rops.dict_probe(jnp.asarray(x), jnp.asarray(table), jnp.asarray(valid),
                           idx_bits=idx_bits, block=block)
    for g, w, k in zip(got, want, kern):
        np.testing.assert_array_equal(tbits.u32_numpy(g[0]), np.asarray(w).astype(np.uint32))
        np.testing.assert_array_equal(tbits.u32_numpy(g[0]), np.asarray(k).astype(np.uint32))


@pytest.mark.parametrize("idx_bits", [12, 10])
def test_probe_per_lane_tables_equal_lane_by_lane_oracle(idx_bits):
    """The widened contract: lane l probes table l; one call for L lanes
    equals L calls of the reference oracle."""
    rng = np.random.default_rng(idx_bits)
    ts = 1 << idx_bits
    x = _dict_values(1, (LANES, 512), card=ts)
    table = _dict_values(2, (LANES, ts), card=ts)
    for lane in range(LANES):  # plant every other value at its slot: hits
        table[lane, rhash.hash_host(x[lane, ::2], idx_bits)] = x[lane, ::2]
    valid = (rng.random((LANES, ts)) < 0.8).astype(np.uint8)
    got = ops.dict_probe(_t(x), _t(table), _t(valid), idx_bits)
    for lane in range(LANES):
        want = rref.probe_ref(jnp.asarray(x[lane]), jnp.asarray(table[lane]),
                              jnp.asarray(valid[lane]), idx_bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(tbits.u32_numpy(g[lane]), np.asarray(w).astype(np.uint32))


def test_hash_matches_reference_host_twin():
    v = _dict_values(3, (2000,))
    v[:4] = [0, 1, 2**31, 2**32 - 1]
    for idx_bits in (1, 8, 12, 16, 31):
        np.testing.assert_array_equal(thash.hash_host(v, idx_bits), rhash.hash_host(v, idx_bits))
        np.testing.assert_array_equal(thash.hash_tensor(_t(v), idx_bits).numpy(),
                                      rhash.hash_host(v, idx_bits))


def test_probe_wrapper_checks_inputs():
    x = torch.zeros((2, 8), dtype=torch.int32)
    table = torch.zeros((2, 4096), dtype=torch.int32)
    valid = torch.zeros((2, 4096), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        ops.dict_probe(x, table, valid.bool(), 12)
    with pytest.raises(ValueError, match="idx_bits"):
        ops.dict_probe(x, table, valid, 32)
    with pytest.raises(ValueError, match="must be"):
        ops.dict_probe(x, table, valid, 10)


# ------------------------------------------------------------------- tdic32 --
@pytest.mark.parametrize("mode", ["frozen", "exact"])
@pytest.mark.parametrize("idx_bits,per_lane", [(12, 64), (8, 33), (6, 16)])
def test_tdic32_matches_reference_block_by_block(mode, idx_bits, per_lane):
    tc = talg.make_codec("tdic32", idx_bits=idx_bits, mode=mode)
    rc = ralg.make_codec("tdic32", idx_bits=idx_bits, mode=mode)
    vals = _dict_values(per_lane, (4, LANES, per_lane), card=1 << (idx_bits - 1))
    ts_e, ts_d = tc.init_state(LANES, CPU), tc.init_state(LANES, CPU)
    rs_e, rs_d = rc.init_state(LANES), rc.init_state(LANES)
    for blk in vals:  # state carried across four blocks
        ts_e, enc_t = tc.encode(ts_e, _t(blk))
        rs_e, enc_r = rc.encode(rs_e, jnp.asarray(blk))
        np.testing.assert_array_equal(tbits.u32_numpy(enc_t.codes), np.asarray(enc_r.codes))
        np.testing.assert_array_equal(enc_t.bitlen.numpy(), np.asarray(enc_r.bitlen))
        _assert_same_state(tc, ts_e, _ref_state_np(rs_e))
        ts_d, x_t = tc.decode(ts_d, enc_t)
        rs_d, x_r = rc.decode(rs_d, enc_r)
        np.testing.assert_array_equal(tbits.u32_numpy(x_t), np.asarray(x_r))
        np.testing.assert_array_equal(tbits.u32_numpy(x_t), blk)
        _assert_same_state(tc, ts_d, _ref_state_np(rs_d))
    assert int(enc_t.bitlen.lt(33).sum()) > 0  # some hits


@pytest.mark.parametrize("mode", ["frozen", "exact"])
@pytest.mark.parametrize("shared", [False, True])
def test_tdic32_encode_blocks_equals_sequential_block_encodes(mode, shared):
    """A chunk of C blocks gives the symbols and state of C block calls,
    each followed by the shared merge when one is given: the table freezes
    per block, never per chunk."""
    tc = talg.make_codec("tdic32", idx_bits=8, mode=mode)
    merge = tpipe.merge_shared_dictionary if shared else None
    blocks = _t(_dict_values(7, (5, LANES, 32), card=100))
    st_chunk, enc = tc.encode_blocks(tc.init_state(LANES, CPU), blocks, merge)
    st = tc.init_state(LANES, CPU)
    for i in range(5):
        st, e = tc.encode(st, blocks[i])
        st = st if merge is None else merge(st)
        assert torch.equal(enc.codes[i], e.codes) and torch.equal(enc.bitlen[i], e.bitlen)
    for k in st:
        assert torch.equal(st_chunk[k], st[k]), k
    st_back, back = tc.decode_blocks(tc.init_state(LANES, CPU), enc, merge)
    assert torch.equal(back, blocks)
    for k in st:
        assert torch.equal(st_back[k], st[k]), k
    if mode == "frozen":  # the one-call encoding of the chunk would differ
        _, flat = tc.encode(tc.init_state(LANES, CPU), blocks.permute(1, 0, 2).reshape(LANES, -1))
        assert not torch.equal(flat.bitlen.reshape(LANES, 5, 32).permute(1, 0, 2), enc.bitlen)


def test_tdic32_state_numpy_roundtrip_and_handoff():
    tc = talg.make_codec("tdic32", idx_bits=6)
    rc = ralg.make_codec("tdic32", idx_bits=6)
    blk = _dict_values(11, (LANES, 40), card=30)
    rs, _ = rc.encode(rc.init_state(LANES), jnp.asarray(blk))
    st = talg.state_from_numpy(tc, _ref_state_np(rs), CPU)
    assert st["table"].dtype == torch.int32 and st["valid"].dtype == torch.bool
    _assert_same_state(tc, st, _ref_state_np(rs))
    nxt = _dict_values(12, (LANES, 40), card=30)
    _, ours = tc.encode(st, _t(nxt))
    _, theirs = rc.encode(rs, jnp.asarray(nxt))
    np.testing.assert_array_equal(tbits.u32_numpy(ours.codes), np.asarray(theirs.codes))


# ------------------------------------------------------------ shared merge --
def _merge_state(seed: int, tie: bool):
    rng = np.random.default_rng(seed)
    ts_size = 64
    state = {
        "table": rng.integers(0, 2**32, (LANES, ts_size), dtype=np.uint64).astype(np.uint32),
        "valid": rng.random((LANES, ts_size)) < 0.6,
        "ts": rng.integers(-1, 40, (LANES, ts_size)).astype(np.int32),
        "clock": rng.integers(0, 50, LANES).astype(np.int32),
    }
    if tie:  # every lane wrote every slot at the same clock tick
        state["ts"][:] = 17
        state["valid"][:] = True
        state["valid"][0, :8] = False  # lane 0 loses its slots 0..7
    return state


@pytest.mark.parametrize("tie", [False, True])
def test_merge_shared_dictionary_matches_reference(tie):
    tc = talg.make_codec("tdic32", idx_bits=6)
    state = _merge_state(int(tie), tie)
    ours = tpipe.merge_shared_dictionary(talg.state_from_numpy(tc, state, CPU))
    theirs = rpipe.merge_shared_dictionary({k: jnp.asarray(v) for k, v in state.items()})
    _assert_same_state(tc, ours, _ref_state_np(theirs))
    if tie:  # ties go to the lowest lane that holds the slot
        table = talg.state_to_numpy(tc, ours)["table"]
        np.testing.assert_array_equal(table[0, 8:], state["table"][0, 8:])
        np.testing.assert_array_equal(table[0, :8], state["table"][1, :8])


def test_lww_select_matches_reference():
    state = _merge_state(5, False)
    tables = tbits.u32_tensor(state["table"], CPU)
    ours = tpipe.lww_select(tables, torch.from_numpy(state["valid"]), torch.from_numpy(state["ts"]))
    theirs = rpipe.lww_select(jnp.asarray(state["table"]), jnp.asarray(state["valid"]),
                              jnp.asarray(state["ts"]))
    np.testing.assert_array_equal(tbits.u32_numpy(ours[0]), np.asarray(theirs[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))


# ---------------------------------------------------------------------- rle --
def _rle_blocks(seed: int, n_blocks: int, per_lane: int) -> np.ndarray:
    """Runs of random lengths (some past CAP when blocks are long), one run
    spanning block boundaries in every lane."""
    rng = np.random.default_rng(seed)
    total = n_blocks * per_lane
    out = np.empty((LANES, total), np.uint32)
    for lane in range(LANES):
        vals, pos = [], 0
        while pos < total:
            n = int(rng.choice([1, 2, 5, per_lane + 3, 70000]))
            vals.append(np.full(n, rng.integers(0, 6), np.uint32))
            pos += n
        out[lane] = np.concatenate(vals)[:total]
    return out.reshape(LANES, n_blocks, per_lane).transpose(1, 0, 2).copy()


@pytest.mark.parametrize("n_blocks,per_lane", [(4, 16), (3, 40000), (1, 1)])
def test_rle_encode_flush_decode_match_reference(n_blocks, per_lane):
    tc, rc = talg.make_codec("rle"), ralg.make_codec("rle")
    blocks = _rle_blocks(per_lane, n_blocks, per_lane)
    ts, rs = tc.init_state(LANES, CPU), rc.init_state(LANES)
    codes, blens = [], []
    for blk in blocks:
        ts, enc_t = tc.encode(ts, _t(blk))
        rs, enc_r = rc.encode(rs, jnp.asarray(blk))
        np.testing.assert_array_equal(tbits.u32_numpy(enc_t.codes), np.asarray(enc_r.codes))
        np.testing.assert_array_equal(enc_t.bitlen.numpy(), np.asarray(enc_r.bitlen))
        _assert_same_state(tc, ts, _ref_state_np(rs))
        codes.append(enc_t.codes)
        blens.append(enc_t.bitlen)
    fl_t, fl_r = tc.flush(ts), rc.flush(rs)
    np.testing.assert_array_equal(tbits.u32_numpy(fl_t.codes), np.asarray(fl_r.codes))
    np.testing.assert_array_equal(fl_t.bitlen.numpy(), np.asarray(fl_r.bitlen))
    stream = talg.Encoded(torch.cat(codes + [fl_t.codes], dim=1),
                          torch.cat(blens + [fl_t.bitlen], dim=1))
    _, x_t = tc.decode(None, stream)
    _, x_r = rc.decode(None, talg.Encoded(jnp.asarray(tbits.u32_numpy(stream.codes)),
                                          jnp.asarray(stream.bitlen.numpy())))
    np.testing.assert_array_equal(tbits.u32_numpy(x_t), np.asarray(x_r))
    flat = blocks.transpose(1, 0, 2).reshape(LANES, -1)
    np.testing.assert_array_equal(tbits.u32_numpy(x_t)[:, : flat.shape[1]], flat)
    if per_lane > 65535:
        assert (tbits.u32_numpy(stream.codes[..., 1])[stream.bitlen.numpy() > 0] == 65535).any()


def test_rle_encode_blocks_equals_sequential_encodes():
    tc = talg.make_codec("rle")
    blocks = _t(_rle_blocks(2, 5, 16))
    st_chunk, enc = tc.encode_blocks(tc.init_state(LANES, CPU), blocks)
    st = tc.init_state(LANES, CPU)
    for i in range(5):
        st, e = tc.encode(st, blocks[i])
        assert torch.equal(enc.codes[i], e.codes) and torch.equal(enc.bitlen[i], e.bitlen)
    for k in st:
        assert torch.equal(st_chunk[k], st[k])
