"""B1/B2's Hopper decomposition (`repro_torch/csrc/bitpack.cu`,
`csrc/bitunpack.cu`), emulated in numpy thread by thread, against the
port's plain versions (`kernels/ref.py`), the reference's oracles
(`repro.kernels.ref`, `repro.core.bits`) and its Pallas kernels in
interpret mode (`repro.kernels.ops`, at the contract's width and small
blocks, where the interpreter is quick enough).

The emulation follows the kernels: 256 threads, each owning K = 8
consecutive symbols of a round of 2,048 (rounds with a running carry past
that); a scan of the K lengths in registers plus one scan of the thread
totals; the vector path's group rule (4 lengths or 2 codes in range whole or
not at all, taken when the block size is a multiple of 4); B1's ORs into a
shared row that holds row word i at index i + mis and its quad-wise store
with the zero tail; B2's speculative first quads, the staging of the words
a window can read (unstaged shared words hold a sentinel, so a read of one
shows), its extraction by pairs of symbols spread over the threads (a
length as the difference of two offsets) and the window's edge rule. B1's
launch with B4 fused in (`ops.pack_blocks_meta7`) is emulated the same way:
each thread's 8 loaded lengths as one 56-bit value, each group of 4 threads
turning its 224 bits into 7 words by one shuffle from the next thread, round
r of a block at metadata word r*448. Inputs come from numpy with a seed.
Tests marked `cuda` run the kernels themselves on the same shapes."""
import numpy as np
import pytest
import torch

from repro_torch.core import bits as tbits
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

THREADS, PER = 256, 8
ROUND = THREADS * PER
M32 = np.uint64(0xFFFFFFFF)
SENTINEL = 0xDEADBEEF


def _mask(n):
    n = np.clip(np.asarray(n, np.int64), 0, 32).astype(np.uint64)
    return np.where(n >= 32, M32, (np.uint64(1) << np.minimum(n, 31)) - np.uint64(1))


def _shr(x, s):
    s = np.asarray(s, np.int64)
    return np.where(s >= 32, np.uint64(0), x >> np.minimum(s, 31).astype(np.uint64))


def _shl(x, s):
    s = np.asarray(s, np.int64)
    return np.where(s >= 32, np.uint64(0), (x << np.minimum(s, 31).astype(np.uint64)) & M32)


def _round_lengths(blen, start, base, symbols, vec):
    """(first, idx, n): the round's symbols per thread [T, K] and their
    lengths, read from the whole array at the block's `start` as the kernel
    reads them, with the vector path's group rule (groups of 4 lengths)."""
    first = base + np.arange(THREADS)[:, None] * PER
    idx = first + np.arange(PER)[None, :]
    group = first + (np.arange(PER) // 4 * 4)[None, :] if vec else idx
    n = np.where(group < symbols, blen[np.minimum(start + idx, blen.size - 1)], 0)
    return first, idx, n.astype(np.int64)


def _scan(n, carry):
    """Offsets [T, K] from the register scan plus the scan of thread totals,
    and the round's total."""
    local = np.cumsum(n, axis=1) - n
    sums = n.sum(axis=1)
    return carry + (np.cumsum(sums) - sums)[:, None] + local, int(sums.sum())


def _mis(blk, row_words, base_mis):
    return (base_mis + blk * row_words) % 4


def emulate_pack(codes, blen, symbols, out_words, base_mis=0):
    """B1 on uint32[nb*S, 2] codes and int32[nb*S] lengths -> (uint32[nb, OW],
    int32[nb]); `base_mis` is the output tensor's misalignment in words."""
    nb = blen.size // symbols
    vec = symbols % 4 == 0
    words = np.full((nb, out_words), SENTINEL, np.uint32)
    nbits = np.zeros(nb, np.int32)
    for blk in range(nb):
        start = blk * symbols
        mis = _mis(blk, out_words, base_mis)
        nq = (out_words + mis + 3) // 4
        buf = np.zeros(4 * nq, np.uint64)
        carry = 0
        for base in range(0, symbols, ROUND):
            first, idx, n = _round_lengths(blen, start, base, symbols, vec)
            pair = first + (np.arange(PER) // 2 * 2)[None, :] if vec else idx
            code = codes[np.minimum(start + idx, blen.size - 1)].astype(np.uint64)
            code = np.where((pair < symbols)[..., None], code, np.uint64(0))
            off, total = _scan(n, carry)
            c0 = code[..., 0] & _mask(np.minimum(n, 32))
            c1 = code[..., 1] & _mask(n - 32)
            w, s = off >> 5, off & 31
            parts = (c0 << s.astype(np.uint64)) & M32, _shr(c0, 32 - s) | _shl(c1, s), _shr(c1, 32 - s)
            for dw, part in enumerate(parts):
                sel = (n > 0) & (part != 0) & (w + dw < out_words)
                np.bitwise_or.at(buf, mis + w[sel] + dw, part[sel])
            carry += total
        live = min(out_words, (carry + 31) >> 5)
        for q in range(nq):  # the quad-wise store, the zero tail from registers
            w0 = 4 * q - mis
            v = buf[4 * q:4 * q + 4] if w0 < live else np.zeros(4, np.uint64)
            for j in range(4):
                if 0 <= w0 + j < out_words:
                    words[blk, w0 + j] = v[j]
        nbits[blk] = carry
    return words, nbits


def emulate_unpack(words, blen, base_mis=0):
    """B2 on uint32[nb, W] rows and int32[nb*S] lengths -> uint32[nb*S, 2]."""
    nb, in_words = words.shape
    symbols = blen.size // nb
    vec = symbols % 4 == 0
    out = np.full((nb * symbols, 2), SENTINEL, np.uint32)
    for blk in range(nb):
        row = words[blk].astype(np.uint64)
        mis = _mis(blk, in_words, base_mis)
        nq = (in_words + mis + 3) // 4
        buf = np.full(4 * nq, SENTINEL, np.uint64)  # shared memory before staging

        def load_quad(q):
            w = 4 * q - mis + np.arange(4)
            return np.where((w >= 0) & (w < in_words), row[np.clip(w, 0, in_words - 1)], 0)

        pre = {q: load_quad(q) for q in range(min(nq, THREADS))}
        staged, carry = 0, 0
        for base in range(0, symbols, ROUND):
            _, _, n = _round_lengths(blen, blk * symbols, base, symbols, vec)
            off, total = _scan(n, carry)
            carry += total
            need = min(in_words, max(1, ((carry - 1) >> 5) + 3))
            need_q = (need + mis + 3) // 4
            if need_q > staged:
                if staged == 0:
                    for q, v in pre.items():
                        buf[4 * q:4 * q + 4] = v
                start = min(nq, THREADS) if staged == 0 else staged
                for q in range(start, need_q):
                    buf[4 * q:4 * q + 4] = load_quad(q)
                staged = max(need_q, start)
            offs = np.append(off.reshape(-1), carry)  # shared: K offsets a thread, then the end
            i = 2 * (np.arange(THREADS)[:, None] + np.arange(PER // 2)[None, :] * THREADS)
            for sym in (i, i + 1):  # a thread's pairs: symbols 2p, 2p + 1 for p = t + j*T
                o, n = offs[sym], offs[sym + 1] - offs[sym]
                w, s = o >> 5, o & 31
                g0 = buf[mis + np.minimum(w, in_words - 1)]
                g1 = np.where(w + 1 < in_words, buf[mis + np.minimum(w + 1, in_words - 1)], 0)
                g2 = np.where(w + 2 < in_words, buf[mis + np.minimum(w + 2, in_words - 1)], 0)
                lo = (_shr(g0, s) | _shl(g1, 32 - s)) & _mask(np.minimum(n, 32))
                hi = (_shr(g1, s) | _shl(g2, 32 - s)) & _mask(n - 32)
                lo, hi = np.where(n > 0, lo, 0), np.where(n > 0, hi, 0)
                keep = base + (i if vec else sym) < symbols  # vec: a pair's 16-byte store
                at = blk * symbols + base + sym[keep]
                out[at, 0], out[at, 1] = lo[keep], hi[keep]
    return out


# ---------------------------------------------------------------- inputs --
def _symbols(seed, nb, s, kind="random"):
    """uint32[nb*s, 2] codes masked to int32[nb*s] lengths (0..64)."""
    rng = np.random.default_rng(seed)
    n = nb * s
    codes = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    if kind == "random":
        blen = rng.integers(0, 65, size=n)
        blen[:2] = [0, 64]
    elif kind == "wide":  # every symbol 64 bits: the live prefix reaches 2S words
        blen = np.full(n, 64)
    elif kind == "zero":
        blen = np.zeros(n, np.int64)
    else:  # "path": Rovio-like, short codes (~11 bits a symbol)
        blen = np.minimum(rng.geometric(0.09, size=n), 64)
    codes[:, 0] &= _mask(np.minimum(blen, 32))
    codes[:, 1] &= _mask(blen - 32)
    return codes.astype(np.uint32), blen.astype(np.int32)


def _t(a):
    a = np.asarray(a)
    return tbits.u32_tensor(a, "cpu") if a.dtype == np.uint32 else torch.from_numpy(a.copy())


@pytest.fixture
def reference():
    """(jax.numpy, repro.core.bits, repro.kernels.ops, repro.kernels.ref)."""
    import jax.numpy as jnp
    from repro.core import bits as rbits
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref

    return jnp, rbits, rops, rref


def _check_unpack_symbols(reference, words, blen, got):
    """`got` equals the reference's `bits.unpack_symbols`, block by block."""
    jnp, rbits, _, _ = reference
    nb, s = words.shape[0], blen.size // words.shape[0]
    for b in range(nb):
        r_codes, _ = rbits.unpack_symbols(jnp.asarray(words[b]), jnp.asarray(blen[b * s:(b + 1) * s]))
        np.testing.assert_array_equal(got[b * s:(b + 1) * s], np.asarray(r_codes))


# (nblocks, symbols, out_words, kind): the path's chunk shape, the eval
# volume's tail block, an unaligned size (scalar path), the contract width,
# blocks of 64-bit symbols, all-zero blocks, rows narrower than the live
# prefix, and a block of more than one round.
CASES = [
    (3, 2048, 4098, "path"),
    (2, 2048, 4098, "random"),
    (2, 1776, 3554, "random"),
    (3, 333, 668, "random"),
    (2, 256, 513, "random"),
    (2, 2048, 4098, "wide"),
    (2, 256, 513, "wide"),
    (2, 2048, 4098, "zero"),
    (2, 2048, 700, "random"),
    (3, 333, 101, "wide"),
    (2, 4100, 8202, "random"),
]


@pytest.mark.parametrize("base_mis", [0, 1, 2])
@pytest.mark.parametrize("nb,s,ow,kind", CASES)
def test_pack_emulation_matches_plain_version_and_reference(reference, nb, s, ow, kind, base_mis):
    jnp, rbits, rops, rref = reference
    codes, blen = _symbols(s + ow, nb, s, kind)
    words, nbits = emulate_pack(codes, blen, s, ow, base_mis)
    w_t, n_t = ref.pack_blocks_ref(_t(codes), _t(blen), s, ow)
    np.testing.assert_array_equal(words, tbits.u32_numpy(w_t))
    np.testing.assert_array_equal(nbits, n_t.numpy())
    for b in range(nb):
        w_r, tot_r, _ = rbits.pack_bits(jnp.asarray(codes[b * s:(b + 1) * s]),
                                        jnp.asarray(blen[b * s:(b + 1) * s]), ow)
        np.testing.assert_array_equal(words[b], np.asarray(w_r))
        assert int(nbits[b]) == int(tot_r)
    if ow == 2 * s + 1 and base_mis == 0:  # the Pallas kernel's contract width
        w_k, n_k = rops.pack_blocks(jnp.asarray(codes), jnp.asarray(blen), block=s)
        np.testing.assert_array_equal(words, np.asarray(w_k))
        np.testing.assert_array_equal(nbits, np.asarray(n_k))


@pytest.mark.parametrize("base_mis", [0, 3])
@pytest.mark.parametrize("nb,s,ow,kind", CASES)
def test_unpack_emulation_matches_plain_version_and_reference(reference, nb, s, ow, kind, base_mis):
    jnp, rbits, rops, rref = reference
    codes, blen = _symbols(s + ow, nb, s, kind)
    words = tbits.u32_numpy(ref.pack_blocks_ref(_t(codes), _t(blen), s, ow)[0])
    got = emulate_unpack(words, blen, base_mis)
    np.testing.assert_array_equal(got, tbits.u32_numpy(ref.unpack_blocks_ref(_t(words), _t(blen))))
    _check_unpack_symbols(reference, words, blen, got)
    live = (np.cumsum(blen.reshape(nb, s), axis=1) <= 32 * ow).reshape(-1)
    np.testing.assert_array_equal(got[live], codes[live])  # all that fit the row
    if ow == 2 * s + 1 and base_mis == 0:
        np.testing.assert_array_equal(got, np.asarray(rref.unpack_blocks_ref(
            jnp.asarray(words), jnp.asarray(blen), s)))
        np.testing.assert_array_equal(got, np.asarray(rops.unpack_blocks(
            jnp.asarray(words), jnp.asarray(blen), block=s)))


PAST_THE_ROW = [(4, 64, 40), (2, 333, 20), (2, 2048, 1000), (1, 4100, 300)]


@pytest.mark.parametrize("nb,s,ow", PAST_THE_ROW)
def test_unpack_emulation_random_words_past_the_row(reference, nb, s, ow):
    """Garbage words and lengths whose offsets run past the row: windows
    clamp to the last word, then zeros (B2's edge rule)."""
    jnp, rbits, rops, rref = reference
    rng = np.random.default_rng(nb * s + ow)
    words = rng.integers(0, 2**32, size=(nb, ow), dtype=np.uint64).astype(np.uint32)
    blen = rng.integers(0, 65, size=nb * s).astype(np.int32)
    assert (blen.reshape(nb, s).sum(axis=1) > 32 * ow + 64).all()
    got = emulate_unpack(words, blen, base_mis=1)
    np.testing.assert_array_equal(got, tbits.u32_numpy(ref.unpack_blocks_ref(_t(words), _t(blen))))
    _check_unpack_symbols(reference, words, blen, got)


def emulate_meta7(blen, symbols, base_mis=0):
    """B4 in B1's launch on int32[nb*S] lengths (S % 32 == 0) -> uint32[nb,
    7S/32]: thread t's 56-bit value of its 8 lengths (each `uint32(n) &
    0x7F`), the next thread's by `__shfl_down_sync` (a warp's last lane gets
    its own), thread p of a group of 4 storing words 2p and 2p + 1 (p = 3:
    word 6) of the group's 7 from its 64-bit window [64p, 64p + 64); groups
    past the block store nothing. Every word is stored exactly once."""
    nb = blen.size // symbols
    mw = 7 * symbols // 32
    meta = np.full((nb, mw), SENTINEL, np.uint64)
    writes = np.zeros((nb, mw), np.int64)
    vec = symbols % 4 == 0 and base_mis == 0
    t = np.arange(THREADS)
    p = (t & 3).astype(np.uint64)
    for blk in range(nb):
        for base in range(0, symbols, ROUND):
            first, _, n = _round_lengths(blen, blk * symbols, base, symbols, vec)
            fields = (n.astype(np.int64) & 0xFFFFFFFF & 0x7F).astype(np.uint64)
            v = (fields << (7 * np.arange(PER, dtype=np.uint64))[None, :]).sum(axis=1).astype(np.uint64)
            nxt = np.where(t % 32 < 31, np.roll(v, -1), v)
            w = ((v >> (np.uint64(8) * p)) | (nxt << (np.uint64(56) - np.uint64(8) * p))) & np.uint64(2**64 - 1)
            group = first[:, 0] - (t & 3) * PER
            for i in np.flatnonzero(group < symbols):
                dst = group[i] // 32 * 7 + 2 * (i & 3)
                for k, word in enumerate((w[i] & M32, w[i] >> np.uint64(32))[: 1 if i & 3 == 3 else 2]):
                    meta[blk, dst + k] = word
                    writes[blk, dst + k] += 1
    assert (writes == 1).all()
    return meta.astype(np.uint32)


# (nblocks, symbols, kind): one and two groups of 32, a block of 3 groups,
# the path's chunk rows, two rounds, a round and a partial one, 64-bit and
# zero-width symbols
META7_CASES = [
    (4, 32, "random"), (3, 64, "random"), (3, 96, "zero"), (2, 2048, "path"),
    (2, 4096, "random"), (2, 2080, "random"), (2, 2048, "wide"),
]


@pytest.mark.parametrize("base_mis", [0, 1])
@pytest.mark.parametrize("nb,s,kind", META7_CASES)
def test_fused_meta7_emulation_matches_plain_version_and_reference(reference, nb, s, kind, base_mis):
    """The fused form's 7-bit rows against `pack_meta7_ref`, the reference's
    `bits.pack_meta7` per row and its Pallas `pack_meta7_blocks` in interpret
    mode; lengths 0..64 and, in the random cases, out-of-range lengths (B4
    masks every length to 7 bits)."""
    jnp, rbits, rops, _ = reference
    _, blen = _symbols(s * nb + 7, nb, s, kind)
    if kind == "random":
        blen[[5, 9, 13, 17, 21]] = [-3, 70, 127, 200, -1]
    got = emulate_meta7(blen, s, base_mis)
    np.testing.assert_array_equal(got, tbits.u32_numpy(ref.pack_meta7_ref(_t(blen).view(nb, s))))
    for b in range(nb):
        row = jnp.asarray(blen[b * s:(b + 1) * s])
        np.testing.assert_array_equal(got[b], np.asarray(rbits.pack_meta7(row)))
    np.testing.assert_array_equal(got, np.asarray(rops.pack_meta7(jnp.asarray(blen.reshape(nb, s)))))


def test_fused_pack_plain_version_and_checks():
    """`ops.pack_blocks_meta7` on the CPU is `pack_blocks` plus
    `pack_meta7_blocks`, refuses blocks that are not a multiple of 32
    symbols, and counts nothing."""
    codes, blen = _symbols(3, 4, 64)
    ops.reset_launches()
    words, nbits, meta = ops.pack_blocks_meta7(_t(codes), _t(blen), block=64, out_words=130)
    w_ref, n_ref = ops.pack_blocks(_t(codes), _t(blen), block=64, out_words=130)
    assert torch.equal(words, w_ref) and torch.equal(nbits, n_ref)
    assert torch.equal(meta, ops.pack_meta7_blocks(_t(blen).view(4, 64)))
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.pack_blocks_meta7(_t(codes), _t(blen), block=16)
    assert ops.launch_counts()["pack_blocks_meta7"] == 0


# ---------------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _offset_view(a: torch.Tensor, words: int) -> torch.Tensor:
    """A contiguous copy of `a` whose data starts `words` int32 past a
    16-byte boundary (the kernels' scalar path and unaligned rows)."""
    flat = torch.zeros(a.numel() + words, dtype=a.dtype, device=a.device)
    flat[words:] = a.reshape(-1)
    return flat[words:].view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("nb,s,ow,kind", CASES)
def test_cuda_pack_and_unpack_match_plain_versions(cuda, nb, s, ow, kind, shift):
    codes, blen = _symbols(s + ow, nb, s, kind)
    c, b = _offset_view(_t(codes).to(cuda), 2 * shift), _offset_view(_t(blen).to(cuda), shift)
    ops.reset_launches()
    words, nbits = ops.pack_blocks(c, b, block=s, out_words=ow)
    w_ref, n_ref = ref.pack_blocks_ref(c, b, s, ow)
    assert torch.equal(words, w_ref) and torch.equal(nbits, n_ref)
    rows = _offset_view(words, shift)
    back = ops.unpack_blocks(rows, b)
    assert torch.equal(back, ref.unpack_blocks_ref(rows, b))
    np.testing.assert_array_equal(tbits.u32_numpy(back.cpu()), emulate_unpack(
        tbits.u32_numpy(words.cpu()), blen, base_mis=(rows.data_ptr() >> 2) & 3))
    counts = ops.launch_counts()
    assert counts["pack_blocks"] == 1 and counts["unpack_blocks"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nb,s,ow", PAST_THE_ROW)
def test_cuda_unpack_random_words_past_the_row(cuda, nb, s, ow):
    rng = np.random.default_rng(nb * s + ow)
    words = _t(rng.integers(0, 2**32, size=(nb, ow), dtype=np.uint64).astype(np.uint32)).to(cuda)
    blen = _t(rng.integers(0, 65, size=nb * s).astype(np.int32)).to(cuda)
    assert torch.equal(ops.unpack_blocks(words, blen), ref.unpack_blocks_ref(words, blen))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("nb,s,kind", META7_CASES)
def test_cuda_fused_pack_matches_plain_versions(cuda, nb, s, kind, shift):
    codes, blen = _symbols(s * nb + 7, nb, s, kind)
    c, b = _offset_view(_t(codes).to(cuda), 2 * shift), _offset_view(_t(blen).to(cuda), shift)
    ops.reset_launches()
    words, nbits, meta = ops.pack_blocks_meta7(c, b, block=s, out_words=2 * s + 2)
    w_ref, n_ref = ref.pack_blocks_ref(c, b, s, 2 * s + 2)
    assert torch.equal(words, w_ref) and torch.equal(nbits, n_ref)
    assert torch.equal(meta, ref.pack_meta7_ref(b.view(nb, s)))
    np.testing.assert_array_equal(tbits.u32_numpy(meta.cpu()), emulate_meta7(blen, s, shift))
    counts = ops.launch_counts()
    assert counts["pack_blocks_meta7"] == 1 and counts["pack_blocks"] == 0
