"""B5's codec form (`ops.dict_chunk_encode` / `dict_chunk_decode`,
`csrc/dict_chunk.cu`) on the CPU: a numpy emulation of the kernels'
algorithm (one walk per lane, the winner of each slot keyed j*B + t and
claimed by atomicMax in a random thread order per block, never reset
between blocks) and the plain versions (`ref.dict_chunk_encode_ref`,
`ref.dict_chunk_decode_ref`, which the wrappers run on CPU tensors) against
the reference's frozen Tdic32 run block by block, symbols and every state
tensor bit for bit; and the rule that routes the codec's chunks. Inputs are
made with numpy from a seed and given to both."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import algorithms as ralg
from repro_torch.core import algorithms as talg
from repro_torch.core import bits as tbits
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import dict_hash, ops

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
KNUTH = np.uint32(2654435761)
#: (idx_bits, lanes, tuples per lane B, blocks per call C); each case runs
#: two calls, the state carried from the first to the second
CASES = [
    (4, 4, 512, 7),  # 16 slots: heavy collisions
    (4, 1, 333, 128),
    (10, 4, 333, 7),
    (10, 1, 512, 1),
    (12, 4, 512, 128),  # the main path's chunk
    (12, 1, 333, 7),
    (12, 4, 333, 1),
]


def _values(seed: int, shape, idx_bits: int) -> np.ndarray:
    """Values from an alphabet about twice the table's size (hits,
    collisions and evictions), with a tenth full-range literals (and the
    top bit set, so a miss needs c1)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2 << idx_bits, size=shape).astype(np.uint32) * np.uint32(2654435)
    wide = rng.random(shape) < 0.1
    v[wide] = rng.integers(0, 2**32, size=int(wide.sum()), dtype=np.uint64).astype(np.uint32)
    return v


def _state(seed: int, lanes: int, idx_bits: int, warm: bool) -> dict:
    """The reference's numpy state: cold, or warm (a filled table, some
    slots invalid, timestamps, and a clock near the top of int32 so the
    timestamps and the clock wrap during the walk)."""
    ts = 1 << idx_bits
    if not warm:
        return {"table": np.zeros((lanes, ts), np.uint32), "valid": np.zeros((lanes, ts), bool),
                "ts": np.full((lanes, ts), -1, np.int32), "clock": np.zeros(lanes, np.int32)}
    rng = np.random.default_rng(seed)
    return {"table": _values(seed + 1, (lanes, ts), idx_bits), "valid": rng.random((lanes, ts)) < 0.7,
            "ts": rng.integers(-1, 2**31 - 5000, (lanes, ts)).astype(np.int32),
            "clock": (2**31 - 1 - rng.integers(0, 3000, lanes)).astype(np.int32)}


def _hash(x: np.ndarray, idx_bits: int) -> np.ndarray:
    return ((x.astype(np.uint32) * KNUTH) >> np.uint32(32 - idx_bits)).astype(np.int64)


def emulate_chunk(data: np.ndarray, state: dict, idx_bits: int, decode: bool, rng):
    """The kernels' algorithm in numpy: per lane (one CTA), the table, valid
    mask and timestamps held across the chunk and a winner array set to -1
    once; per block j, every tuple t reads the table as the blocks before
    it left (a probe, or a decode's gather), claims hash(x)'s slot with
    max(winner, j*B + t) in a random order of the threads, and the tuple
    whose key is the slot's winner writes it. `data` is blocks uint32[C, L,
    B] (encode) or codes uint32[C, L, B, 2] (decode). Returns (codes
    uint32[C, L, B, 2] and bitlen int32[C, L, B], or values uint32[C, L, B];
    the state after the chunk)."""
    c, lanes, b = data.shape[:3]
    mask = np.uint32((1 << idx_bits) - 1)
    st = {k: v.copy() for k, v in state.items()}
    values = np.zeros((c, lanes, b), np.uint32)
    codes = np.zeros((c, lanes, b, 2), np.uint32)
    bitlen = np.zeros((c, lanes, b), np.int32)
    for lane in range(lanes):
        table, valid, ts = st["table"][lane], st["valid"][lane], st["ts"][lane]
        clock = np.int64(st["clock"][lane])
        winner = np.full(1 << idx_bits, -1, np.int64)
        for j in range(c):
            if decode:
                c0, c1 = data[j, lane, :, 0], data[j, lane, :, 1]
                literal = (c0 >> np.uint32(1)) | (c1 << np.uint32(31))
                x = np.where(c0 & np.uint32(1) == 1, table[(c0 >> np.uint32(1)) & mask], literal)
                values[j, lane] = x
            else:
                x = data[j, lane]
                h = _hash(x, idx_bits)
                hit = valid[h] & (table[h] == x)
                codes[j, lane, :, 0] = np.where(hit, np.uint32(1) | (h.astype(np.uint32) << np.uint32(1)),
                                                x << np.uint32(1))
                codes[j, lane, :, 1] = np.where(hit, np.uint32(0), x >> np.uint32(31))
                bitlen[j, lane] = np.where(hit, 1 + idx_bits, 33)
            h = _hash(x, idx_bits)
            key = j * b + np.arange(b, dtype=np.int64)
            order = rng.permutation(b)  # the threads' atomicMax, one at a time
            np.maximum.at(winner, h[order], key[order])
            own = winner[h] == key
            table[h[own]] = x[own]
            valid[h[own]] = True
            ts[h[own]] = ((clock + key[own]) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        st["clock"][lane] = np.int64((clock + c * b) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return ((values,) if decode else (codes, bitlen)), st


def _reference_walk(data: np.ndarray, state: dict, idx_bits: int, decode: bool):
    """The reference's frozen Tdic32, one `encode` (or `decode`) per block:
    (outputs as `emulate_chunk` gives them, the numpy state after)."""
    rc = ralg.make_codec("tdic32", idx_bits=idx_bits, mode="frozen")
    rs = {k: jnp.asarray(v) for k, v in state.items()}
    outs = []
    for j in range(data.shape[0]):
        if decode:
            enc = ralg.Encoded(jnp.asarray(data[j]), jnp.full(data.shape[1:3], 33, jnp.int32))
            rs, x = rc.decode(rs, enc)
            outs.append((np.asarray(x),))
        else:
            rs, enc = rc.encode(rs, jnp.asarray(data[j]))
            outs.append((np.asarray(enc.codes), np.asarray(enc.bitlen)))
    stacked = tuple(np.stack(parts) for parts in zip(*outs))
    return stacked, {k: np.asarray(v) for k, v in rs.items()}


def _plain(data: np.ndarray, state: dict, idx_bits: int, decode: bool):
    """`ops.dict_chunk_encode` / `dict_chunk_decode` on CPU tensors (their
    plain versions), in the same numpy form."""
    args = (tbits.u32_tensor(state["table"], CPU), torch.from_numpy(state["valid"].astype(np.uint8)),
            torch.from_numpy(state["ts"].copy()), torch.from_numpy(state["clock"].copy()))
    if decode:
        values, *st = ops.dict_chunk_decode(tbits.u32_tensor(data, CPU), *args, idx_bits)
        outs = (tbits.u32_numpy(values),)
    else:
        codes, bitlen, *st = ops.dict_chunk_encode(tbits.u32_tensor(data, CPU), *args, idx_bits)
        outs = (tbits.u32_numpy(codes), bitlen.numpy())
    table, valid, ts, clock = st
    assert valid.dtype == torch.uint8 and int(valid.max()) <= 1
    return outs, {"table": tbits.u32_numpy(table), "valid": valid.numpy().astype(bool),
                  "ts": ts.numpy(), "clock": clock.numpy()}


def _assert_same(got, want, what: str):
    (g_out, g_st), (w_out, w_st) = got, want
    assert len(g_out) == len(w_out)
    for g, w in zip(g_out, w_out):
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=what)
    assert g_st.keys() == w_st.keys()
    for k in w_st:
        np.testing.assert_array_equal(g_st[k], w_st[k], err_msg=f"{what}: state {k}")


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("idx_bits,lanes,b,c", CASES)
def test_chunk_walk_equals_reference_block_by_block(idx_bits, lanes, b, c, warm):
    """Two calls of C blocks each, the state carried: the emulation and the
    plain versions give the reference's per-block symbols, values and
    state, bit for bit, in both directions; the decode returns the input."""
    rng = np.random.default_rng(1000 * idx_bits + b + c)
    blocks = _values(idx_bits + c, (2, c, lanes, b), idx_bits)
    start = _state(7 * lanes + idx_bits, lanes, idx_bits, warm)
    enc_st = {"emulation": start, "plain": start, "reference": start}
    dec_st = dict(enc_st)
    hits = 0
    for part in blocks:
        want = _reference_walk(part, enc_st["reference"], idx_bits, decode=False)
        got_e = emulate_chunk(part, enc_st["emulation"], idx_bits, False, rng)
        got_p = _plain(part, enc_st["plain"], idx_bits, decode=False)
        _assert_same(got_e, want, "encode emulation")
        _assert_same(got_p, want, "encode plain version")
        enc_st = {"emulation": got_e[1], "plain": got_p[1], "reference": want[1]}
        codes = want[0][0]
        hits += int((want[0][1] < 33).sum())
        back = _reference_walk(codes, dec_st["reference"], idx_bits, decode=True)
        back_e = emulate_chunk(codes, dec_st["emulation"], idx_bits, True, rng)
        back_p = _plain(codes, dec_st["plain"], idx_bits, decode=True)
        _assert_same(back_e, back, "decode emulation")
        _assert_same(back_p, back, "decode plain version")
        np.testing.assert_array_equal(back[0][0], part)
        # the decoder's table replays the encoder's
        _assert_same(((), back[1]), ((), want[1]), "decode state against encode state")
        dec_st = {"emulation": back_e[1], "plain": back_p[1], "reference": back[1]}
    assert hits > 0


def test_winner_key_needs_no_reset_between_blocks():
    """A slot claimed in block 0 and not touched in block 1 keeps its old
    key, which block 1's keys all exceed: the emulation's state equals one
    made with the winner array cleared before every block."""
    idx_bits, lanes, b = 4, 2, 40
    blocks = _values(3, (6, lanes, b), idx_bits)
    start = _state(3, lanes, idx_bits, warm=True)
    rng = np.random.default_rng(0)
    (_, st) = emulate_chunk(blocks, start, idx_bits, False, rng)
    st_each = start
    for blk in blocks:
        _, st_each = emulate_chunk(blk[None], st_each, idx_bits, False, rng)
    for k in st:
        np.testing.assert_array_equal(st[k], st_each[k], err_msg=k)


# --------------------------------------------------------------------- rule --
@pytest.mark.parametrize("idx_bits,b,mode,shared,inside", [
    (12, 512, "frozen", False, True),  # the main path
    (10, 512, "frozen", False, True),
    (4, 333, "frozen", False, True),
    (14, 512, "frozen", False, True),  # 208 KiB of table beside a 18 KiB ring
    (12, 4977, "frozen", False, True),
    (12, 4978, "frozen", False, False),  # the ring no longer fits beside the table
    (15, 1, "frozen", False, False),  # 416 KiB of table
    (12, 512, "frozen", True, False),  # shared state: a merge after every block
    (12, 512, "exact", False, False),  # exact mode: the table changes per tuple
    (12, 512, "exact", True, False),
])
def test_chunk_kernel_rule(idx_bits, b, mode, shared, inside):
    merge = tpipe.merge_shared_dictionary if shared else None
    assert dict_hash.chunk_kernel_for(idx_bits, b, mode, merge) is inside
    if mode == "frozen" and not shared:
        assert (dict_hash.chunk_smem_bytes(idx_bits, b, decode=True) <= dict_hash.MAX_SMEM_BYTES) is inside


@pytest.mark.parametrize("mode,shared,idx_bits,chunk_route", [
    ("frozen", False, 12, True),
    ("frozen", False, 6, True),
    ("frozen", True, 12, False),
    ("exact", False, 12, False),
    ("frozen", False, 15, False),
])
def test_codec_takes_the_chunk_route_only_inside_the_rule(monkeypatch, mode, shared, idx_bits,
                                                          chunk_route):
    """`encode_blocks`/`decode_blocks` call the chunk wrappers exactly
    inside the rule, else `dict_probe` block by block (frozen) or the
    per-tuple walk (exact), and both routes agree."""
    calls = {"dict_chunk_encode": 0, "dict_chunk_decode": 0, "dict_probe": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    tc = talg.make_codec("tdic32", idx_bits=idx_bits, mode=mode)
    merge = tpipe.merge_shared_dictionary if shared else None
    blocks = tbits.u32_tensor(_values(5, (3, 4, 24), 5), CPU)
    st, enc = tc.encode_blocks(tc.init_state(4, CPU), blocks, merge)
    st_back, back = tc.decode_blocks(tc.init_state(4, CPU), enc, merge)
    assert torch.equal(back, blocks)
    st_each, enc_each = tc.encode_each_block(tc.init_state(4, CPU), blocks, merge)
    assert torch.equal(enc.codes, enc_each.codes) and torch.equal(enc.bitlen, enc_each.bitlen)
    for k in st:
        assert torch.equal(st[k], st_each[k]) and torch.equal(st_back[k], st_each[k]), k
    assert st["valid"].dtype == torch.bool
    if chunk_route:
        assert (calls["dict_chunk_encode"], calls["dict_chunk_decode"]) == (1, 1)
    else:
        assert (calls["dict_chunk_encode"], calls["dict_chunk_decode"]) == (0, 0)
    # encode_each_block probes each of the 3 blocks, and so does a frozen
    # encode_blocks outside the rule; exact mode never probes
    assert calls["dict_probe"] == (0 if mode == "exact" else 3 if chunk_route else 6)


def test_chunk_wrappers_check_their_inputs():
    lanes, k = 2, 6
    blocks = torch.zeros((3, lanes, 8), dtype=torch.int32)
    state = (torch.zeros((lanes, 1 << k), dtype=torch.int32), torch.zeros((lanes, 1 << k), dtype=torch.uint8),
             torch.full((lanes, 1 << k), -1, dtype=torch.int32), torch.zeros(lanes, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint8"):
        ops.dict_chunk_encode(blocks, state[0], state[1].bool(), *state[2:], idx_bits=k)
    with pytest.raises(ValueError, match="must be"):
        ops.dict_chunk_encode(blocks, *state, idx_bits=k + 1)
    big = (torch.zeros((1, 1 << 15), dtype=torch.int32), torch.zeros((1, 1 << 15), dtype=torch.uint8),
           torch.zeros((1, 1 << 15), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        ops.dict_chunk_encode(torch.zeros((1, 1, 1), dtype=torch.int32), *big, idx_bits=15)
    with pytest.raises(ValueError, match="idx_bits"):
        ops.dict_chunk_decode(torch.zeros((3, lanes, 8, 2), dtype=torch.int32), *state, idx_bits=0)
    with pytest.raises(ValueError, match="symbol slots"):
        ops.dict_chunk_decode(torch.zeros((3, lanes, 8, 3), dtype=torch.int32), *state, idx_bits=k)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dict_chunk_encode(blocks.transpose(0, 1), *state, idx_bits=k)
    # zero blocks: the state comes back as it was
    codes, bitlen, *st = ops.dict_chunk_encode(blocks[:0], *state, idx_bits=k)
    assert codes.shape == (0, lanes, 8, 2) and bitlen.shape == (0, lanes, 8)
    assert all(torch.equal(a, b) for a, b in zip(st, state))
