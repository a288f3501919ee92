"""B3's Hopper decomposition (`repro_torch/csrc/frame_compact.cu`,
`compact_blocks_kernel`), emulated in numpy thread by thread, against the
port's plain version (`kernels/ref.py: compact_blocks_ref`), the
reference's oracle (`repro.core.bits.compact_payload`) and its Pallas kernel
in interpret mode (`repro.kernels.frame_compact.compact_blocks`, on rows
whose live prefix fits, the Pallas kernel's contract).

The emulation follows the kernel: each warp's prefix of the word counts, 4
counts per lane and a 32-lane inclusive scan per group of 128 blocks (the
vector rule: one 16-byte load of 4 counts when n % 4 == 0); CTA b < n copies
block b with 256 threads, thread j of round k holding the aligned source quad
q0 + j and its neighbour's q0 + j - 1, funnelled by the rows' relative
shift into one aligned destination quad, stored whole (16 bytes) where the
live range covers it and word by word at the two ends; the zero fill of
[total, n*OW) as a scalar head, aligned quads grid-stride over the n CTAs
and a scalar tail; the clipped gather word by word when a live prefix runs
past the array. Both arrays may start 0-3 words past a 16-byte boundary.
Every payload word must be written exactly once. Tolerance: zero, bit for
bit. Tests marked `cuda` run the kernel itself."""
import numpy as np
import pytest
import torch

from repro_torch.core import bits as tbits
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

THREADS, GROUP = 256, 128


def warp_prefix(nbits: np.ndarray, b: int, vec: bool):
    """(before, nw_b, all) as one warp computes them: per group of 128
    counts, lane l holds counts 4l..4l+3 (0 past n) and the lanes' sums are
    scanned; `vec` is the 16-byte load rule (whole groups of 4 in range)."""
    n = nbits.size
    carry, before, nwb = 0, 0, 0
    for g0 in range(0, n, GROUP):
        idx = g0 + np.arange(GROUP).reshape(32, 4)
        ok = (g0 + (idx - g0) // 4 * 4 < n) if vec else (idx < n)
        v = np.where(ok, nbits[np.minimum(idx, n - 1)].astype(np.int64), 0)
        w = (v + 31) >> 5  # floor, as the kernel's arithmetic shift
        s = w.sum(axis=1)
        inc = np.cumsum(s)
        rel = b - g0
        if 0 <= rel < GROUP:
            lane, k = rel >> 2, rel & 3
            before = carry + int(inc[lane] - s[lane] + w[lane, :k].sum())
            nwb = int(w[lane, k])
        carry += int(inc[-1])
    return before, nwb, carry


def emulate_compact(words: np.ndarray, nbits: np.ndarray, wm: int = 0, pm: int = 0):
    """B3 on uint32[n, OW] words and int32[n] bit counts, the source array
    `wm` and the payload `pm` words past a 16-byte boundary -> (payload
    uint32[n*OW], total, writes per payload word)."""
    n, ow = words.shape
    cap = n * ow
    src = np.zeros(wm + cap + 8, np.uint32)  # absolute words from the aligned base
    src[wm:wm + cap] = words.reshape(-1)
    out = np.full(pm + cap + 8, 0xDEADBEEF, np.uint32)
    writes = np.zeros(pm + cap + 8, np.int64)
    vec = n % 4 == 0

    def quads(q, lo, hi):  # aligned quads [q, 4] holding any word of [lo, hi), else zeros
        ok = (4 * q + 3 >= lo) & (4 * q < hi)
        got = src[np.clip(4 * q[:, None] + np.arange(4), 0, src.size - 1)]
        return np.where(ok[:, None], got, 0).astype(np.uint32)

    def store(addr, vals):
        out[addr] = vals
        np.add.at(writes, addr, 1)

    for blk in range(n):
        before, nwb, total = warp_prefix(nbits, blk, vec)
        live = max(0, min(nwb, cap - before))
        a0 = wm + blk * ow
        qs0 = a0 >> 2
        if blk * ow + live > cap:  # the clipped gather
            i = np.arange(live)
            store(pm + before + i, src[wm + np.minimum(blk * ow + i, cap - 1)])
            continue
        if live == 0:
            continue
        d0, d1 = pm + before, pm + before + live
        delta = a0 - d0
        dq, r = delta >> 2, delta & 3
        jend = ((d1 - 1) >> 2) + 2 + dq - qs0
        rounds = -(-jend // THREADS)
        j = np.arange(rounds * THREADS)
        spec = j < 2 * THREADS  # the first two rounds load before the counts
        own = np.where(spec[:, None], quads(qs0 + j, a0, wm + cap), quads(qs0 + j, a0, a0 + live))
        # lane 0 loads its neighbour's quad itself, the other lanes shuffle it up
        prev = np.where(spec[:, None], quads(qs0 + j - 1, a0, wm + cap),
                        quads(qs0 + j - 1, a0, a0 + live))
        up = j % 32 != 0
        prev[up] = own[np.flatnonzero(up) - 1]
        q = qs0 + j - 1 - dq
        keep = (j < jend) & (4 * q + 3 >= d0) & (4 * q < d1)
        both = np.concatenate([prev, own], axis=1)  # the funnel: words r..r+3
        v = both[:, r:r + 4]
        whole = keep & (4 * q >= d0) & (4 * q + 4 <= d1)
        for qq, vv in zip(q[whole], v[whole]):
            store(4 * qq + np.arange(4), vv)
        for qq, vv in zip(q[keep & ~whole], v[keep & ~whole]):
            a = 4 * qq + np.arange(4)
            m = (a >= d0) & (a < d1)
            store(a[m], vv[m])
    _, _, total = warp_prefix(nbits, 0, vec)
    f0, f1 = pm + min(max(total, 0), cap), pm + cap
    qa, qb = (f0 + 3) >> 2, f1 >> 2
    head = np.arange(f0, min(4 * qa, f1))
    store(head, 0)
    if qa <= qb:
        store(np.arange(4 * qb, f1), 0)
    grid = n
    for blk in range(grid):  # grid-stride quads
        q = np.arange(qa + blk * THREADS, qb, grid * THREADS)[:, None] + np.arange(THREADS)
        q = q[q < qb]
        if q.size:
            store((4 * q[:, None] + np.arange(4)).reshape(-1), 0)
    assert not writes[:pm].any() and not writes[pm + cap:].any()
    return out[pm:pm + cap], np.int32(total), writes[pm:pm + cap]


def _case(seed: int, n: int, ow: int, kind: str):
    """uint32[n, OW] random words and int32[n] bit counts: 'random' (up to the
    row), 'zero' (every block zero-width), 'full' (every row live), 'mixed'
    (zero-width and full blocks among random ones), 'path' (~1,130 live words
    in rows of 4,098, the tcomp32 chunk), 'over' (a middle block's prefix
    longer than its row) or 'clipped' (the last block's prefix past the
    array)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, ow), dtype=np.uint64).astype(np.uint32)
    nbits = rng.integers(0, 32 * ow + 1, size=n)
    if kind == "zero":
        nbits[:] = 0
    elif kind == "full":
        nbits[:] = 32 * ow
    elif kind == "mixed":
        nbits[::3] = 0
        nbits[1::5] = 32 * ow
    elif kind == "path":
        nbits = rng.integers(1100 * 32, 1160 * 32, size=n)
    elif kind == "over":
        nbits[n // 2] = 32 * (ow + 7) - 5
    elif kind == "clipped":
        nbits[-1] = 32 * (ow + 9) - 1
    return words, nbits.astype(np.int32)


# (n, OW, kind): n of 1, 3, 128 (the path's chunk) and 300 (three groups of
# 128, not a multiple of 4: the scalar count loads); OW even (4,098: rows 8
# bytes off every second block) and odd (every row shifted by another word)
CASES = [
    (1, 4098, "random"), (1, 4097, "full"), (1, 37, "zero"), (1, 5, "clipped"),
    (3, 4098, "random"), (3, 4097, "mixed"), (3, 33, "over"), (3, 7, "clipped"),
    (128, 4098, "path"), (128, 4097, "random"), (128, 66, "mixed"), (128, 31, "full"),
    (128, 9, "zero"), (128, 12, "over"),
    (300, 61, "random"), (300, 64, "mixed"), (300, 17, "clipped"), (300, 2, "full"),
]


@pytest.fixture
def reference():
    """(jax.numpy, repro.core.bits, repro.kernels.frame_compact)."""
    import jax.numpy as jnp
    from repro.core import bits as rbits
    from repro.kernels import frame_compact as rfc

    return jnp, rbits, rfc


@pytest.mark.parametrize("n,vec", [(n, False) for n in (1, 3, 4, 127, 128, 129, 300, 512)]
                         + [(n, True) for n in (4, 128, 300, 512)])
def test_warp_prefix_matches_exclusive_cumsum(n, vec):
    rng = np.random.default_rng(n)
    nbits = rng.integers(0, 40000, size=n).astype(np.int32)
    nbits[::7] = 0
    nw = (nbits.astype(np.int64) + 31) // 32
    off = np.cumsum(nw) - nw
    for b in sorted({0, n // 2, n - 1, min(n - 1, 128)}):
        before, nwb, total = warp_prefix(nbits, b, vec)
        assert total == int(nw.sum())
        if b < n:
            assert (before, nwb) == (int(off[b]), int(nw[b]))


@pytest.mark.parametrize("wm,pm", [(0, 0), (2, 0), (1, 3), (3, 2)])
@pytest.mark.parametrize("n,ow,kind", CASES)
def test_emulation_matches_plain_version_and_reference(reference, n, ow, kind, wm, pm):
    jnp, rbits, rfc = reference
    words, nbits = _case(n * 131 + ow, n, ow, kind)
    got, total, writes = emulate_compact(words, nbits, wm, pm)
    assert (writes == 1).all(), "every payload word is written exactly once"
    p_t, t_t = ref.compact_blocks_ref(tbits.u32_tensor(words, "cpu"), torch.from_numpy(nbits))
    np.testing.assert_array_equal(got, tbits.u32_numpy(p_t))
    assert int(total) == int(t_t)
    p_r, t_r = rbits.compact_payload(jnp.asarray(words), jnp.asarray(nbits))
    np.testing.assert_array_equal(got, np.asarray(p_r))
    assert int(total) == int(t_r)
    fits = ((nbits.astype(np.int64) + 31) // 32 <= ow).all()
    if fits and n * ow <= 20000 and wm == pm == 0:  # the Pallas kernel's contract, interpreted
        p_k, t_k = rfc.compact_blocks(jnp.asarray(words), jnp.asarray(nbits), interpret=True)
        np.testing.assert_array_equal(got, np.asarray(p_k))
        assert int(total) == int(t_k)


@pytest.mark.parametrize("total_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("pm", [0, 1, 3])
def test_fill_head_body_tail_at_16_byte_grain(total_mod, pm):
    """`total` on and off a 4-word boundary: the head stops at the first
    16-byte boundary after it, the quads end at the last boundary before
    n*OW, the tail takes the rest; none overlaps the live words."""
    n, ow = 6, 11  # cap 66, not a multiple of 4
    words = np.arange(1, n * ow + 1, dtype=np.uint32).reshape(n, ow)
    nbits = np.zeros(n, np.int32)
    nbits[0] = 32 * (4 * 3 + total_mod)  # total = 12 + total_mod words
    got, total, writes = emulate_compact(words, nbits, 0, pm)
    assert int(total) == 12 + total_mod and (writes == 1).all()
    np.testing.assert_array_equal(got[:int(total)], words[0, :int(total)] if total <= ow
                                  else words.reshape(-1)[:int(total)])
    assert not got[int(total):].any()


@pytest.mark.parametrize("ow", [4098, 4097, 4099, 4096])
def test_source_misalignment_of_odd_and_even_rows(ow):
    """Row b starts b*OW words in: with OW = 4,098 every second row is 8
    bytes off a 16-byte boundary, with odd OW every row shifts by one more
    word; the funnel's shift r runs through all four values."""
    n = 8
    words, nbits = _case(ow, n, ow, "random")
    shifts = set()
    for blk in range(n):
        before, _, _ = warp_prefix(nbits, blk, True)
        shifts.add((blk * ow - before) % 4)
    got, total, writes = emulate_compact(words, nbits)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, tbits.u32_numpy(ref.compact_blocks_ref(
        tbits.u32_tensor(words, "cpu"), torch.from_numpy(nbits))[0]))
    assert len(shifts) > 1


# ---------------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _offset_view(a: torch.Tensor, words: int) -> torch.Tensor:
    flat = torch.zeros(a.numel() + words, dtype=a.dtype, device=a.device)
    flat[words:] = a.reshape(-1)
    return flat[words:].view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("n,ow,kind", CASES)
def test_cuda_compact_matches_plain_version(cuda, n, ow, kind, shift):
    words, nbits = _case(n * 131 + ow, n, ow, kind)
    w = _offset_view(tbits.u32_tensor(words, cuda), shift)
    nb = _offset_view(torch.from_numpy(nbits).to(cuda), shift)
    ops.reset_launches()
    pay, tot = ops.compact_blocks(w, nb)
    p_ref, t_ref = ref.compact_blocks_ref(w, nb)
    assert torch.equal(pay, p_ref) and int(tot) == int(t_ref)
    assert ops.launch_counts()["compact_blocks"] == 1
