"""B9's section form (`repro_torch/csrc/rans_section_decode.cu`): a section's
packed u16 stream words, lane states and lane counts to its bytes. Its
plain version (`kernels/ref.py: rans_section_decode_ref`) is held against
the reference's decode (`repro.core.entropy._decode_device` on the padded
stream, states and counts its `decode_section` builds, imported per test so
`pytest -m cuda` runs where jax is absent), and the kernel's algorithm is
emulated in numpy, thread by thread and step by step, against both.

The emulation follows the kernel: the per-CTA slot table built from marks
(s + 1 at each symbol's first slot) and a running maximum, each of the 256
threads over its 16 consecutive slots and then a block scan of the threads'
maxima (a warp scan and the warps' totals), packed as `sym | (f - 1) << 8 |
(slot - cum) << 20`; each lane's offset as the int32 difference of its end and count; the
lane's ring of 64 u16s in shared memory, four quads staged before the
walk and one more at a checkpoint every 8 steps wherever fewer than 32 are
staged ahead (a 16-byte copy for a quad wholly inside the stream, the
guarded reads of the reference's padded stream otherwise); every read
checks that the ring slot holds the position asked for and that its copy
has landed (issued at least two checkpoints back, or before the walk, or
stored at once), and every overwrite that the slot's old position was
read; the step x2 = f*(x >> 12) + (slot - cum), the renorm taking the u16
read after the previous one; each warp's tile of 4 chunks x 128 bytes,
written a byte per lane per step and stored every 16 steps, 16 bytes per
thread, up to byte n. Every byte below n is stored exactly once. Inputs come
from numpy with a seed; sections are coded by the port's B8 section form,
which `tests/test_torch_rans_section.py` holds to the reference's encode.
Tolerance: zero, bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.core import bits as tbits
from repro_torch.core import entropy as tent
from repro_torch.kernels import ops, rans, ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

LANES, ROWS, CHUNK = 8, 512, 4096
RING, AHEAD, CHECK, TILE_ROWS = 64, 32, 8, 16
M32 = (1 << 32) - 1
SENTINEL = 0xEE


# ------------------------------------------------------------ the table --
def emulate_table(freqs: np.ndarray) -> np.ndarray:
    """The CTA's slot table (uint32[4096]) from a table int32[256]."""
    f = freqs.astype(np.int64) & M32
    cum = (np.cumsum(f) - f) & M32  # warp 0's scan, mod 2^32
    tab = np.zeros(4096, np.int64)
    for s in range(256):  # thread s's mark; an accepted table's starts are distinct
        if f[s] != 0 and cum[s] < 4096:
            assert tab[cum[s]] == 0
            tab[cum[s]] = s + 1
    m = np.maximum.accumulate(tab.reshape(256, 16), axis=1)  # each thread's 16 slots
    inc = np.maximum.accumulate(m[:, -1].reshape(8, 32), axis=1)  # the warp scans
    in_warp = np.concatenate([np.zeros((8, 1), np.int64), inc[:, :-1]], axis=1)
    warps = np.concatenate([[0], np.maximum.accumulate(inc[:, -1])[:-1]])  # earlier warps' totals
    before = np.maximum(in_warp, warps[:, None]).reshape(256, 1)
    slot = np.arange(4096).reshape(256, 16)
    s = (np.maximum(m, before) - 1) & 0xFF
    e = s | ((f[s] - 1) & 0xFFF) << 8 | ((slot - cum[s]) & 0xFFF) << 20
    return e.reshape(-1).astype(np.uint32)


def accepted_tables():
    """(name, int32[256]) tables the decoder accepts: non-negative, summing
    to 4096."""
    rng = np.random.default_rng(31)
    for s in (0, 97, 255):
        t = np.zeros(256, np.int32)
        t[s] = 4096
        yield f"single_{s}", t
    t = np.zeros(256, np.int32)
    t[1::2] = 32  # zero-interleaved: every other symbol absent
    yield "zero_interleaved", t
    t = np.zeros(256, np.int32)
    t[[3, 4, 250]] = [1, 4094, 1]  # leading and trailing zeros, f = 1 at both ends
    yield "sparse_edges", t
    yield "uniform", np.full(256, 16, np.int32)
    t = np.ones(256, np.int32)
    t[200] += 4096 - 256
    yield "ones_and_one", t
    for k in range(3):
        h = np.bincount((rng.zipf(1.2 + 0.3 * k, 20_000) - 1).clip(0, 255), minlength=256)
        yield f"quantized_{k}", tent.quantize_freqs(torch.from_numpy(h)).to(torch.int32).numpy()
    for k in range(12):  # random supports of 1..256 symbols, random splits of 4096
        support = np.sort(rng.choice(256, size=int(rng.integers(1, 257)), replace=False))
        cuts = np.sort(rng.choice(np.arange(1, 4096), size=support.size - 1, replace=False))
        t = np.zeros(256, np.int32)
        t[support] = np.diff(np.concatenate([[0], cuts, [4096]]))
        yield f"random_{k}", t


@pytest.mark.parametrize("name,freqs", list(accepted_tables()))
def test_slot_entries_are_exact_for_every_accepted_table(name, freqs):
    """Each slot's entry carries the slot table's symbol, its frequency
    minus one and the slot's offset into it, and the one-lookup step equals
    the reference's three-lookup step for every slot at 64 states each."""
    assert int(freqs.sum()) == 4096 and (freqs >= 0).all()
    e = emulate_table(freqs).astype(np.int64)
    sym = e & 0xFF
    lut = tent.slot_table(torch.from_numpy(freqs)).numpy()
    cum = tent.cum_freqs(torch.from_numpy(freqs)).numpy()
    slot = np.arange(4096)
    np.testing.assert_array_equal(sym, lut)
    np.testing.assert_array_equal(((e >> 8) & 0xFFF) + 1, freqs[sym])
    np.testing.assert_array_equal(e >> 20, slot - cum[sym])
    rng = np.random.default_rng(len(name))
    x = (rng.integers(1 << 16, 1 << 32, (64, 4096), dtype=np.uint64) & ~np.uint64(4095)) | slot.astype(np.uint64)
    xs = (x >> np.uint64(12)).astype(np.int64)
    one = (((e >> 8) & 0xFFF) * xs + xs + (e >> 20)) & M32
    three = (freqs[lut].astype(np.int64) * xs + slot - cum[lut]) & M32
    np.testing.assert_array_equal(one, three)


# ------------------------------------------------------------ emulation --
def emulate_decode(words: np.ndarray, total: int, freqs: np.ndarray, states: np.ndarray,
                   counts: np.ndarray, n: int, aligned: bool = True) -> np.ndarray:
    """The kernel on a section (words uint32[ceil(total/2)], states uint32
    [C, 8], counts int32[C, 8]) -> uint8[n]; `aligned` is whether the words
    start on a 16-byte boundary (16-byte copies) or not (guarded reads)."""
    c_n = states.shape[0]
    streams = c_n * LANES
    cap = rans.decode_cap(c_n)
    tab = emulate_table(freqs).astype(np.int64)
    u16 = np.stack([words & 0xFFFF, words >> 16], axis=1).reshape(-1).astype(np.int64)
    threads = -(-streams // 32) * 32
    g = np.arange(threads)
    real = g < streams
    c, j = g >> 3, g & 7
    left = n - c * CHUNK - j
    rows = np.where(real & (left > 0), np.minimum(ROWS, (left + 7) // 8), 0)
    cflat = counts.reshape(-1).astype(np.int64)
    ends = np.cumsum(cflat)
    p0 = np.zeros(threads, np.int64)
    p0[:streams] = ((ends - cflat + 2**31) % 2**32) - 2**31  # int32, wrapping
    x = np.zeros(threads, np.int64)
    x[:streams] = states.reshape(-1).astype(np.int64)
    base = p0 & ~7
    r = p0 - base
    f = np.where(real, 0, 1 << 30)
    ring = np.zeros((threads, RING), np.int64)
    ring_pos = np.full((threads, RING), -1, np.int64)  # the relative position a slot holds
    landed = np.full((threads, RING), np.iinfo(np.int64).max)  # checkpoint after which it is readable
    checks = 0  # checkpoints done (the same for every warp that runs them)

    def read_u16(pos):
        e = np.clip(pos, 0, cap - 1)
        return np.where(e < total, u16[np.minimum(e, max(total - 1, 0))] if total else 0, 0)

    def stage(lanes, issued):
        for i in lanes:
            lo = base[i] + f[i]
            slots = (f[i] & (RING - 1)) + np.arange(8)
            old = ring_pos[i, slots]
            assert ((old < 0) | (old < r[i])).all(), "a staged quad overwrote an unread u16"
            ring[i, slots] = read_u16(lo + np.arange(8))
            ring_pos[i, slots] = f[i] + np.arange(8)
            copy = aligned and lo >= 0 and lo + 8 <= total
            landed[i, slots] = issued + 2 if copy else -1  # a copy waits two checkpoints
            f[i] += 8

    def read(i):
        slot = r[i] & (RING - 1)
        assert ring_pos[i, slot] == r[i], "the ring slot holds another position"
        assert landed[i, slot] <= checks, "read before its copy landed"
        return ring[i, slot]

    for _ in range(AHEAD // 8):  # before the walk, waited for at once
        stage(np.flatnonzero(real), -2)
    val = np.array([read(i) if real[i] else 0 for i in range(threads)], np.int64)

    out = np.full(n, SENTINEL, np.int64)
    writes = np.zeros(n, np.int64)
    warps = threads // 32
    lo_w = rows.reshape(warps, 32).min(axis=1)
    hi_w = rows.reshape(warps, 32).max(axis=1)
    tile = np.zeros((warps, 4, 144), np.int64)
    for t0 in range(0, ROWS, TILE_ROWS):
        runs = np.repeat(t0 < hi_w, 32)  # the warps that walk this block
        for rr in range(TILE_ROWS):
            live = runs & (t0 + rr < rows)
            e = tab[x & 4095]
            xs = x >> 12
            x2 = (((e >> 8) & 0xFFF) * xs + xs + (e >> 20)) & M32
            need = live & (x2 < (1 << 16))
            x = np.where(live, np.where(need, ((x2 << 16) | val) & M32, x2), x)
            r = r + need
            for i in np.flatnonzero(need):
                val[i] = read(i)
            for i in np.flatnonzero(live):
                tile[i // 32, (i & 31) >> 3, 8 * rr + j[i]] = e[i] & 0xFF
            if rr % CHECK == CHECK - 1:  # the checkpoint of the warps that walk
                checks += 1
                stage([i for i in np.flatnonzero(runs) if f[i] - r[i] < AHEAD], checks)
        for i in np.flatnonzero(runs):  # the tile's store, 16 bytes a thread up to byte n
            dst = c[i] * CHUNK + 16 * j[i] + t0 * LANES + np.arange(16)
            ok = dst < n
            out[dst[ok]] = tile[i // 32, (i & 31) >> 3, 16 * j[i]:16 * j[i] + 16][ok]
            writes[dst[ok]] += 1
    assert (writes == 1).all()
    return out.astype(np.uint8)


# ---------------------------------------------------------- the reference --
@pytest.fixture
def rent():
    """The reference's entropy stage (`repro.core.entropy`)."""
    from repro.core import entropy

    return entropy


def reference_decode(rent, words, total, freqs, states, counts, n):
    """The reference's decode of a section's parts, padded as its
    `decode_section` pads them (a stream past the padded length raises its
    ValueError)."""
    import jax.numpy as jnp

    c = states.shape[0]
    cp = rans.decode_cap(c) // CHUNK
    u16 = np.stack([words & 0xFFFF, words >> 16], axis=1).reshape(-1)[:total].astype(np.uint32)
    stream = np.zeros(cp * CHUNK, np.uint32)
    stream[:total] = u16
    st = np.full((cp, LANES), rent.RANS_L, np.uint32)
    st[:c] = states
    cn = np.zeros((cp, LANES), np.uint32)
    cn[:c] = counts.astype(np.uint32)
    syms = rent._decode_device(jnp.asarray(stream), jnp.asarray(freqs), jnp.asarray(st),
                               jnp.asarray(cn), jnp.int32(n), cp)
    return np.asarray(syms[:n], np.uint32).astype(np.uint8)


def _bytes(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n * 7 + len(kind))
    if kind == "single":
        return np.full(n, 42, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n).astype(np.uint8)
    return (rng.zipf(1.3, n) - 1).clip(0, 255).astype(np.uint8)  # skewed


def section(data: np.ndarray):
    """(words uint32[ceil(E/2)], E, freqs int32[256], states uint32[C, 8],
    counts int32[C, 8], n) of a section coded by the port's B8 section form."""
    d = torch.from_numpy(data)
    freqs = tent.quantize_freqs(torch.bincount(d, minlength=256)).to(torch.int32)
    states, counts, words, total = ops.rans_section_encode(d, freqs)
    e = int(total)
    return (tbits.u32_numpy(words)[: (e + 1) // 2], e, freqs.numpy(), tbits.u32_numpy(states),
            counts.numpy(), data.size)


def decode_cpu(words, total, freqs, states, counts, n) -> np.ndarray:
    return ops.rans_section_decode(tbits.u32_tensor(words, "cpu"), total, torch.from_numpy(freqs),
                                   tbits.u32_tensor(states, "cpu"), torch.from_numpy(counts), n).numpy()


SIZES = [1, 3, 128, 300, 4096, 4097, 5 * 4096 - 777]
KINDS = ["random", "skewed", "single"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_version_and_emulation_match_reference(rent, n, kind):
    data = _bytes(kind, n)
    args = section(data)
    got = decode_cpu(*args)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, reference_decode(rent, *args))
    np.testing.assert_array_equal(emulate_decode(*args), got)
    if n % 2:  # the guarded reads alone: words off a 16-byte boundary
        np.testing.assert_array_equal(emulate_decode(*args, aligned=False), got)


def corrupt_cases():
    """(name, section parts) the decoder accepts but no encoder wrote:
    random states (lanes read past their runs and past the stream), counts
    moved between lanes with the same total (lanes read their neighbours'
    u16s), a non-zero odd pad half, and a stream of exactly cap u16s whose
    last lanes start at cap (their reads clip to its last u16)."""
    rng = np.random.default_rng(41)
    words, e, freqs, states, counts, n = section(_bytes("skewed", 3 * 4096 + 1001))
    rand_states = rng.integers(0, 2**32, states.shape, dtype=np.uint64).astype(np.uint32)
    yield "random_states", (words, e, freqs, rand_states, counts, n)
    moved = counts.copy().reshape(-1)
    moved[0], moved[1] = moved[0] + moved[1], 0
    moved[9], moved[10] = 0, moved[9] + moved[10]
    yield "moved_counts", (words, e, freqs, states, moved.reshape(counts.shape), n)
    odd = section(_bytes("skewed", 5000))
    assert odd[1] % 2 == 1
    padded = odd[0].copy()
    padded[-1] |= np.uint32(0xABCD0000)
    yield "odd_pad_half", (padded, *odd[1:])
    cap = rans.decode_cap(1)
    full = rng.integers(0, 2**32, cap // 2, dtype=np.uint64).astype(np.uint32)
    at_cap = np.array([[cap, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    yield "stream_at_cap", (full, cap, freqs, rand_states[:1], at_cap, 3000)


@pytest.mark.parametrize("name", [name for name, _ in corrupt_cases()])
def test_corrupt_sections_decode_as_the_reference_does(rent, name):
    args = dict(corrupt_cases())[name]
    got = decode_cpu(*args)
    np.testing.assert_array_equal(got, reference_decode(rent, *args))
    np.testing.assert_array_equal(emulate_decode(*args), got)


def test_stream_past_the_cap_raises_as_the_reference_does(rent):
    words, e, freqs, states, counts, n = section(_bytes("random", 2000))
    cap = rans.decode_cap(1)
    long_words = np.concatenate([words, np.zeros((cap + 8 - e) // 2 + 1, np.uint32)])
    total = 2 * long_words.size
    big = counts.copy()
    big[0, 0] += total - e
    with pytest.raises(ValueError, match="exceeds"):
        decode_cpu(long_words, total, freqs, states, big, n)
    with pytest.raises(ValueError):
        reference_decode(rent, long_words, total, freqs, states, big, n)


def _section_words(kind: str, nw: int) -> np.ndarray:
    rng = np.random.default_rng(nw + len(kind))
    if kind == "skewed":
        return rng.zipf(1.3, nw).clip(0, 2**31).astype(np.uint32)
    return (rng.zipf(1.6, nw) % 7).astype(np.uint32)


@pytest.mark.parametrize("kind", ["skewed", "small"])
@pytest.mark.parametrize("nw", [700, 1024, 2 * 1024 + 5, 5 * 1024 + 3])
def test_decode_section_equals_reference_and_corrupt_states_too(rent, nw, kind):
    """The entropy stage's `decode_section` (the packed words as they sit
    in the section) against the reference's, on sections it coded and on the
    same sections with their lane states perturbed."""
    raw = _section_words(kind, nw)
    sec = rent.encode_section(raw)
    if sec[0] == 0:
        pytest.skip("the raw fallback: nothing for the coder to decode")
    back, used = tent.decode_section(sec, raw.size, "cpu")
    np.testing.assert_array_equal(back, raw)
    assert used == sec.size
    bad = sec.copy()
    states = slice(3 + 128, 3 + 128 + 8 * int(sec[2]))
    bad[states] ^= np.random.default_rng(nw).integers(1, 2**32, bad[states].size, dtype=np.uint64).astype(np.uint32)
    ours, used = tent.decode_section(bad, raw.size, "cpu")
    theirs, used_r = rent.decode_section(bad, raw.size)
    np.testing.assert_array_equal(ours, theirs)
    assert used == used_r


def test_wrapper_checks_inputs_and_does_not_count_cpu_calls():
    words, e, freqs, states, counts, n = section(_bytes("skewed", 5000))
    args = (tbits.u32_tensor(words, "cpu"), e, torch.from_numpy(freqs), tbits.u32_tensor(states, "cpu"),
            torch.from_numpy(counts), n)
    ops.reset_launches()
    with pytest.raises(ValueError, match="words"):
        ops.rans_section_decode(args[0][:-1], *args[1:])
    with pytest.raises(ValueError, match="states"):
        ops.rans_section_decode(*args[:5], n + 4096)
    with pytest.raises(TypeError, match="int32"):
        ops.rans_section_decode(args[0], e, args[2].to(torch.int64), *args[3:])
    assert ops.rans_section_decode(args[0][:0], 0, args[2], args[3][:0], args[4][:0], 0).numel() == 0
    np.testing.assert_array_equal(ops.rans_section_decode(*args).numpy(), _bytes("skewed", 5000))
    assert ops.launch_counts()["rans_section_decode"] == 0


# ---------------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _on(cuda, words, total, freqs, states, counts, n, shift=0):
    w = torch.zeros(words.size + shift, dtype=torch.int32, device=cuda)
    w[shift:] = tbits.u32_tensor(words, cuda)
    return (w[shift:], total, torch.from_numpy(freqs).to(cuda), tbits.u32_tensor(states, cuda),
            torch.from_numpy(counts).to(cuda), n)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_cuda_section_decode_matches_plain_version(cuda, n, kind, shift):
    data = _bytes(kind, n)
    args = _on(cuda, *section(data), shift=shift)
    ops.reset_launches()
    got = ops.rans_section_decode(*args)
    assert torch.equal(got, ref.rans_section_decode_ref(*args))
    np.testing.assert_array_equal(got.cpu().numpy(), data)
    assert ops.launch_counts()["rans_section_decode"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", [name for name, _ in corrupt_cases()])
def test_cuda_corrupt_sections_match_plain_version(cuda, name):
    args = _on(cuda, *dict(corrupt_cases())[name])
    assert torch.equal(ops.rans_section_decode(*args), ref.rans_section_decode_ref(*args))
