"""B8's section form (`repro_torch/csrc/rans_section.cu`): a section's bytes
to lane states, lane counts and the packed u16 stream. Its algorithm is
emulated in numpy, CTA by CTA and step by step, against the port's plain
version (`kernels/ref.py: rans_section_encode_ref`, which is `rans_encode_ref`
on the chunk grid plus `assemble_stream`) and the reference
(`repro.core.entropy.encode_section`, imported per test, so `pytest -m cuda`
runs where jax is absent).

The emulation follows the kernels: the per-CTA table (cumulative
frequencies mod 2^32, the divisor constants of Granlund-Montgomery's
round-up multiply-high with the quotient taken as a 33-bit sum shifted by
l); the bytes of 32 chunks staged a
quarter chunk at a time (two buffers) at a padded stride; each lane's walk
from its last real row down, with the state update x + q*(4096 - f) + cum;
the i-th emission shifted into an 8-slot quad that lands at slots
[512 - 8m - 8, 512 - 8m) every eighth emission (through the lane's ring
in shared memory and the warp's flush every 64 rows; the last, partial
quad shifted up with zeros); then the copy of each lane's slots [512 - count,
512) to its offset, as u16s of a little-endian array, in aligned 8-slot
groups funnelled from the two source groups each straddles (u16 stores for
the two end groups, which neighbouring runs share), and the odd pad half
zeroed; every output slot is written once. Scratch slots that no store reaches hold a sentinel. Inputs come
from numpy with a seed. Tolerance: zero, bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.core import bits as tbits
from repro_torch.core import entropy as tent
from repro_torch.kernels import ops, ref, rans

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

THREADS, LANES, ROWS, CHUNKS_PER_CTA = 256, 8, 512, 32
PARTS, PART_ROWS, PART_BYTES, FLUSH_ROWS = 4, 128, 1024, 64
STRIDE = PART_BYTES + 16
SENTINEL = 0xBEEF
M32 = (1 << 32) - 1


# ------------------------------------------------------------ the divisor --
def divisor_constants(f: np.ndarray):
    """(fs, magic, l) per frequency (uint64 arrays): 0 reads as 1; l =
    ceil(log2 fs), magic = floor(2^32 (2^l - fs) / fs) + 1."""
    fs = np.where(f == 0, 1, f).astype(np.uint64)
    l = np.array([int(v - 1).bit_length() for v in fs], np.uint64)
    magic = ((((np.uint64(1) << l) - fs) << np.uint64(32)) // fs + np.uint64(1)) & np.uint64(M32)
    return fs, magic, l


def mulhi_div(x: np.ndarray, magic, l):
    """q = (t + x) >> l in 33 bits, t = mulhi(x, magic), in uint64; the same
    number as Granlund-Montgomery's (t + ((x - t) >> 1)) >> (l - 1)."""
    t = (x * magic) >> np.uint64(32)
    q = (t + x) >> l
    gm = np.where(l > 0, (t + ((x - t) >> np.uint64(1))) >> np.maximum(l, np.uint64(1)) - np.uint64(1), x)
    np.testing.assert_array_equal(q, gm)
    return q


def test_reciprocal_division_is_exact_for_every_frequency():
    """Every f in [1, 4096] at x in {0, 1, kf - 1, kf, kf + 1, f*2^20 - 1,
    2^32 - 1} (k seeded, kf < 2^32) and 10^4 seeded random x each, against
    `//` and `%`; and the new state x + q*(4096 - f) + cum against
    (q << 12) + x % f + cum modulo 2^32."""
    rng = np.random.default_rng(19)
    f = np.arange(1, 4097, dtype=np.uint64)
    fs, magic, l = divisor_constants(f)
    assert (magic <= np.uint64(M32)).all() and (l <= 12).all()
    k = rng.integers(1, (2**32 - 2) // f.astype(np.int64)).astype(np.uint64)
    edges = np.stack([np.zeros_like(f), np.ones_like(f), k * f - np.uint64(1), k * f,
                      k * f + np.uint64(1), (f << np.uint64(20)) - np.uint64(1),
                      np.full_like(f, M32)], axis=1)
    xs = np.concatenate([edges, rng.integers(0, 2**32, size=(f.size, 10_000), dtype=np.uint64)],
                        axis=1)
    q = mulhi_div(xs, magic[:, None], l[:, None])
    np.testing.assert_array_equal(q, xs // f[:, None])
    r = xs - q * f[:, None]
    np.testing.assert_array_equal(r, xs % f[:, None])
    cum = rng.integers(0, 4096, size=f.size).astype(np.uint64)[:, None]
    new = (xs + q * ((np.uint64(4096) - f[:, None]) & np.uint64(M32)) + cum) & np.uint64(M32)
    np.testing.assert_array_equal(new, ((q << np.uint64(12)) + r + cum) & np.uint64(M32))


def test_reciprocal_division_beyond_a_quantized_table():
    """Frequencies past 4096 (tables that are not quantized) up to 2^32 - 1."""
    rng = np.random.default_rng(20)
    f = np.concatenate([rng.integers(4097, 2**32, size=3000, dtype=np.uint64),
                        np.array([2**31, 2**31 + 1, 2**32 - 1, 2**16, 65537], np.uint64)])
    fs, magic, l = divisor_constants(f)
    xs = np.concatenate([rng.integers(0, 2**32, size=(f.size, 2000), dtype=np.uint64),
                         np.stack([f - np.uint64(1), f, np.full_like(f, M32)], axis=1)], axis=1)
    xs = np.minimum(xs, np.uint64(M32))
    q = mulhi_div(xs, magic[:, None], l[:, None])
    np.testing.assert_array_equal(q, xs // f[:, None])


# ------------------------------------------------------------- emulation --
def emulate_section(data: np.ndarray, freqs: np.ndarray):
    """The two kernels on bytes uint8[n] and a table int32[256] ->
    (states uint32[C, 8], counts int32[C, 8], words uint32[n // 2 + 1] with
    the stream in its first ceil(E/2), E, scratch uint16[C*8, 512])."""
    n = data.size
    chunks = -(-n // 4096)
    streams = chunks * LANES
    f = freqs.astype(np.uint64) & np.uint64(M32)
    cum = (np.cumsum(f) - f) & np.uint64(M32)  # the block scan, mod 2^32
    fs, magic, l = divisor_constants(f)  # the table's 16-byte entries (m, f, cum, l)
    scratch = np.full((streams, ROWS), SENTINEL, np.uint16)
    states = np.zeros(streams, np.uint64)
    counts = np.zeros(streams, np.int64)
    for cta in range(-(-chunks // CHUNKS_PER_CTA)):
        tid = np.arange(THREADS)
        g = cta * THREADS + tid
        c_local, j = tid // LANES, tid % LANES
        left = n - (cta * CHUNKS_PER_CTA + c_local) * 4096 - j
        rows = np.where(left <= 0, 0, np.minimum(ROWS, (left + 7) // 8))
        x = np.full(THREADS, 1 << 16, np.uint64)
        cnt = np.zeros(THREADS, np.int64)
        acc = np.zeros((THREADS, 8), np.uint16)  # slot k of the quad = position k
        ring = np.zeros((THREADS, 8, 8), np.uint16)  # each lane's 8 quads in shared memory
        fresh = np.zeros(THREADS, np.int64)  # whole quads not flushed yet

        def flush():  # the warp flush: each lane's new quads, one contiguous run
            for i in np.flatnonzero(fresh):
                first = ROWS // 8 - cnt[i] // 8
                for q in range(first, first + fresh[i]):
                    scratch[g[i], 8 * q:8 * q + 8] = ring[i, q & 7]
            fresh[:] = 0
        bufs = [None, None]  # double-buffered quarters: part p in bufs[p & 1]
        for part in range(PARTS - 1, -1, -1):
            stage = np.zeros(CHUNKS_PER_CTA * STRIDE, np.uint8)
            for c in range(CHUNKS_PER_CTA):
                src = (cta * CHUNKS_PER_CTA + c) * 4096 + part * PART_BYTES + np.arange(PART_BYTES)
                ok = src < n  # 16-byte copies zero-fill past n, byte loads too
                stage[c * STRIDE + np.arange(PART_BYTES)] = np.where(ok, data[np.minimum(src, n - 1)], 0)
            bufs[part & 1] = stage
            hi = np.minimum(rows, (part + 1) * PART_ROWS) - 1 - part * PART_ROWS
            for t in range(PART_ROWS - 1, -1, -1):
                live = (g < streams) & (t <= hi)
                s = bufs[part & 1][c_local * STRIDE + j + t * LANES].astype(np.int64)
                ef = fs[s]
                emit = live & ((x >> np.uint64(20)) >= ef)
                acc[emit, 1:] = acc[emit, :-1]
                acc[emit, 0] = (x[emit] & np.uint64(0xFFFF)).astype(np.uint16)
                cnt += emit
                full = emit & (cnt % 8 == 0)
                for i in np.flatnonzero(full):
                    ring[i, ((ROWS - cnt[i]) // 8) & 7] = acc[i]
                fresh += full
                assert (fresh <= 8).all()  # the ring never overruns between flushes
                x = np.where(emit, x >> np.uint64(16), x)
                q = mulhi_div(x, magic[s], l[s])
                xn = (x + q * ((np.uint64(4096) - ef) & np.uint64(M32)) + cum[s]) & np.uint64(M32)
                x = np.where(live, xn, x)
                if t % FLUSH_ROWS == 0:
                    flush()
        for i in np.flatnonzero((g < streams) & (cnt % 8 != 0)):
            p = cnt[i] % 8
            quad = np.concatenate([np.zeros(8 - p, np.uint16), acc[i, :p]])
            scratch[g[i], (ROWS - cnt[i]) // 8 * 8:(ROWS - cnt[i]) // 8 * 8 + 8] = quad
        ok = g < streams
        states[g[ok]], counts[g[ok]] = x[ok], cnt[ok]
    ends = np.cumsum(counts)
    out, writes = emulate_copy(scratch, counts, ends, n)
    e = int(ends[-1]) if streams else 0
    assert (writes[:e + e % 2] == 1).all() and not writes[e + e % 2:].any()
    words = out.view("<u4")
    return (states.astype(np.uint32).reshape(chunks, LANES), counts.astype(np.int32).reshape(chunks, LANES),
            words, e, scratch)


def emulate_copy(scratch: np.ndarray, counts: np.ndarray, ends: np.ndarray, n: int):
    """The copy kernel: warp w moves lane w's slots [512 - count, 512) to
    [end - count, end) of the u16 output; its lane i takes the i-th aligned
    8-slot destination group, built from the two aligned source groups it
    straddles (zeros for a group with none of the run's slots) shifted by
    the run's offset mod 8; whole groups are one 16-byte store, the two end
    groups u16 stores of the run's slots. -> (uint16 output, writes per slot)."""
    flat = np.concatenate([scratch.reshape(-1), np.zeros(8, np.uint16)])
    out = np.full(2 * (n // 2 + 1), SENTINEL, np.uint16)
    writes = np.zeros(out.size, np.int64)
    streams = counts.size
    for w in range(streams):
        cw, end = int(counts[w]), int(ends[w])
        if w == streams - 1 and end % 2:
            out[end], writes[end] = 0, writes[end] + 1  # the odd pad half
        if cw == 0:
            continue
        s0, d0 = w * ROWS + ROWS - cw, end - cw
        s1, d1 = s0 + cw, d0 + cw
        dq, r = (s0 - d0) >> 3, (s0 - d0) & 7
        for g in range(d0 >> 3, ((d1 - 1) >> 3) + 1):
            def group(q):
                return flat[8 * q:8 * q + 8] if 8 * q + 7 >= s0 and 8 * q < s1 else np.zeros(8, np.uint16)
            window = np.concatenate([group(g + dq), group(g + dq + 1) if r else np.zeros(8, np.uint16)])
            v = window[r:r + 8]
            slots = 8 * g + np.arange(8)
            keep = (slots >= d0) & (slots < d1)
            out[slots[keep]] = v[keep]
            writes[slots[keep]] += 1
    return out, writes


def _bytes(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n + len(kind))
    if kind == "constant":
        return np.full(n, 9, np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    return (rng.zipf(1.4, n) - 1).clip(0, 255).astype(np.uint8)  # skewed


def _table(data: np.ndarray) -> np.ndarray:
    return tent.quantize_freqs(torch.bincount(torch.from_numpy(data), minlength=256)).to(
        torch.int32).numpy()


SIZES = [1, 4095, 4096, 4097, 300_000]
KINDS = ["constant", "uniform", "skewed"]


def _check_against_plain(data, freqs, got):
    states, counts, words, e, scratch = got
    p_states, p_counts, p_words, p_e = ref.rans_section_encode_ref(
        torch.from_numpy(data), torch.from_numpy(freqs))
    np.testing.assert_array_equal(states, tbits.u32_numpy(p_states))
    np.testing.assert_array_equal(counts, p_counts.numpy())
    assert e == int(p_e)
    np.testing.assert_array_equal(words[:(e + 1) // 2], tbits.u32_numpy(p_words)[:(e + 1) // 2])
    assert not tbits.u32_numpy(p_words)[(e + 1) // 2:].any()
    return p_states, p_counts, p_words


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_emulation_matches_plain_version(n, kind):
    data = _bytes(kind, n)
    freqs = _table(data)
    got = emulate_section(data, freqs)
    _check_against_plain(data, freqs, got)
    states, counts, words, e, scratch = got
    # reverse-slot emission: each lane's run fills slots [512 - count, 512),
    # its quads reach down to the next multiple of 8, nothing below
    for w, cw in enumerate(counts.reshape(-1)):
        low = ROWS - -(-int(cw) // 8) * 8
        assert (scratch[w, :low] == SENTINEL).all()
        assert not scratch[w, low:ROWS - cw].any()
    if kind == "constant":
        assert e == 0  # a single symbol at 4096 never renormalises


def test_plain_version_is_the_contract_kernel_plus_assembly():
    """`rans_section_encode_ref` equals `rans_encode_ref` on `chunk_grid`,
    then `assemble_stream`, packed two u16s to a word (odd pad zero)."""
    data = _bytes("skewed", 3 * 4096 - 79)  # 3,323 u16s: an odd count
    freqs = torch.from_numpy(_table(data))
    t = torch.from_numpy(data)
    states, counts, words, e = ops.rans_section_encode(t, freqs)
    syms, mask = rans.chunk_grid(t)
    s2, flags, vals = ref.rans_encode_ref(syms, mask, freqs)
    stream, c2 = rans.assemble_stream(flags, vals)
    assert torch.equal(states, s2) and torch.equal(counts, c2) and int(e) == stream.numel()
    u = tbits.u32_numpy(stream)
    if u.size % 2:
        u = np.concatenate([u, np.zeros(1, np.uint32)])
    np.testing.assert_array_equal(tbits.u32_numpy(words)[: u.size // 2], u[0::2] | (u[1::2] << 16))
    assert stream.numel() % 2 == 1  # the case exercises the pad


def test_unquantized_table_with_frequencies_past_4096():
    """A table that is not a quantized one (frequencies past 4096, an
    unquantized histogram): the emulation against the plain version."""
    data = _bytes("skewed", 5000)
    freqs = np.bincount(data, minlength=256).astype(np.int32) * 7 + 1
    got = emulate_section(data, freqs)
    _check_against_plain(data, freqs, got)


# (section words, kind): 4, 4,092, 4,096, 4,100 and 300,000 bytes
WORD_SIZES = [1, 1023, 1024, 1025, 75_000]


def _words(kind: str, nw: int) -> np.ndarray:
    rng = np.random.default_rng(nw * 3 + len(kind))
    if kind == "constant":
        return np.full(nw, 0x07070707, np.uint32)
    if kind == "uniform":
        return rng.integers(0, 2**32, nw, dtype=np.uint64).astype(np.uint32)
    return rng.zipf(1.3, nw).clip(0, 2**31).astype(np.uint32)


@pytest.fixture
def rent():
    """The reference's entropy stage (`repro.core.entropy`)."""
    from repro.core import entropy

    return entropy


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nw", WORD_SIZES)
def test_encode_section_words_equal_reference(rent, nw, kind):
    raw = _words(kind, nw)
    ours = tent.encode_section(raw, "cpu")
    np.testing.assert_array_equal(ours, rent.encode_section(raw))
    back, used = tent.decode_section(ours, raw.size, "cpu")
    np.testing.assert_array_equal(back, raw)
    assert used == ours.size


def test_wrapper_checks_inputs_and_does_not_count_cpu_calls():
    ops.reset_launches()
    freqs = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError, match="uint8"):
        ops.rans_section_encode(torch.zeros(8, dtype=torch.int32), freqs)
    with pytest.raises(ValueError, match="256"):
        ops.rans_section_encode(torch.zeros(8, dtype=torch.uint8), freqs[:255])
    states, counts, words, e = ops.rans_section_encode(torch.zeros(0, dtype=torch.uint8), freqs)
    assert states.shape == (0, 8) and int(e) == 0 and words.numel() == 1
    assert ops.launch_counts()["rans_section_encode"] == 0


# ---------------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mis", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_cuda_section_encode_matches_plain_version(cuda, n, kind, mis):
    data = _bytes(kind, n)
    flat = torch.zeros(n + mis, dtype=torch.uint8, device=cuda)
    flat[mis:] = torch.from_numpy(data).to(cuda)
    d = flat[mis:]
    freqs = torch.from_numpy(_table(data)).to(cuda)
    ops.reset_launches()
    states, counts, words, e = ops.rans_section_encode(d, freqs)
    p_states, p_counts, p_words, p_e = ref.rans_section_encode_ref(d, freqs)
    assert int(e) == int(p_e)
    k = (int(e) + 1) // 2
    assert torch.equal(states, p_states) and torch.equal(counts, p_counts)
    assert torch.equal(words[:k], p_words[:k])
    assert ops.launch_counts()["rans_section_encode"] == 1
