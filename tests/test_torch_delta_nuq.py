"""Kernels B6/B7 in the ADPCM codec's form (`csrc/delta_nuq.cu`): the
algorithms of the speculative segmented encode and the clamp-add scan
decode, emulated on the CPU in plain torch and held bit for bit against the
plain versions (`kernels/ref.py: adpcm_lane_encode_ref`,
`adpcm_lane_decode_ref`, the serial walk) and the reference's jitted
`ADPCM.encode`/`decode` (`repro/core/algorithms/adpcm.py`), and the decode
rule (`kernels/delta_nuq.py: decode_kernel_for`) that picks the scan.

The encode emulation follows the kernel's algorithm: segments of `seg`
tuples, `threads` segments per tile (CTA); every segment but the lane's
first starts from the clipped raw sample `warm` tuples before it, walked
forward over them; then rounds inside each tile until every segment starts
where its predecessor ends (a mismatched segment re-walks beside a replay
of its own codes and stops where the states' bits agree); then the chain
of tile boundaries from tile 0's end, resolving again each tile whose start
differs. The kernel's integer walk (one lookup and an integer clamp-add
per step, where vmax and dmax are integers) is emulated on its own. The
decode emulation composes int64 clamp-add maps: a doubling
(tree-ordered) scan within each block row, a scan of the rows' maps, each
row's start state from it, as the kernel's two launches do.

Streams: ECG calibrated on its first 8,192 tuples (vmax 1841, dmax 358),
uniform noise over [0, vmax], square and saw waves that clip at 0 and at
vmax, and a ramp steeper than dmax = 1 under vmax = 2^24, on which no guess
ever converges; fresh lanes and a state carried over two calls; qbits 4, 8
and 12. Inputs are made with numpy from a seed. Tests marked `cuda` are in
tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ralg
from repro_torch.core import bits as tbits
from repro_torch.core.algorithms import nuq
from repro_torch.core.calibration import calibrated_kwargs
from repro_torch.data import make_dataset
from repro_torch.kernels import delta_nuq, ops, ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

LANES, MU = 4, 255.0
#: the kernel's constants (csrc/delta_nuq.cu kSeg, kWarm, kSpecThreads)
KERNEL_SPLIT = (delta_nuq.SEGMENT, delta_nuq.WARMUP, delta_nuq.SPEC_THREADS)
#: (seg, warm, threads) of the emulation: the kernel's, small tiles so that
#: short streams cross many tile boundaries, no warm-up, odd sizes
SPLITS = [KERNEL_SPLIT, (16, 8, 4), (8, 0, 3), (5, 3, 2)]
ECG_PARAMS = dict(vmax=1841.0, dmax=358.0)
RAMP_PARAMS = dict(vmax=float(2**24), dmax=1.0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# ----------------------------------------------------------- the emulations --
def spec_encode(blocks, xhat, init, qbits, vmax, dmax, mu, width, seg=64, warm=32, threads=128):
    """The speculative segmented encode, as the kernel runs it, on the CPU.
    Returns the plain version's (codes, bitlen, xhat, init) and a dict of
    counts: `rounds` (most rounds any tile took), `rewalked` (steps walked
    again), `fixed_tiles` (tiles the chain resolved again)."""
    c, lanes, b = blocks.shape
    n = c * b
    raw = blocks.permute(1, 0, 2).reshape(lanes, n)
    xf = tbits._u(raw).clamp(max=delta_nuq.u32_limit(vmax)).to(torch.float32)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, True, "cpu")
    lim, top = delta_nuq.f32(dmax), delta_nuq.f32(vmax)

    def step(xin, xh):
        neg, mag, dq = ref._quantize((xin - xh).clamp(-lim, lim), thr, dec)
        return ref._signed_codes(neg, mag, qbits), (xh + dq).clamp(0.0, top)

    def replay(code, xh):
        return (xh + nuq.mulaw_decode_signed(code, qbits, dmax, mu)).clamp(0.0, top)

    nseg = -(-n // seg)
    first = torch.arange(nseg) * seg  # each segment's first tuple
    rows = torch.arange(lanes)[:, None]
    fresh = ~init
    # the speculative pass
    x = xf[:, (first - warm).clamp(min=0)].clone()
    x[:, 0] = torch.where(fresh, xf[:, 0], xhat)
    for k in range(warm):
        pos = first - warm + k
        ok = (pos >= 0) & (torch.arange(nseg) > 0)
        _, nx = step(xf[:, pos.clamp(min=0)], x)
        x = torch.where(ok, nx, x)
    start = x.clone()
    codes = torch.zeros((lanes, n), dtype=torch.int32)
    for k in range(seg):
        pos = first + k
        ok = pos < n
        p = pos.clamp(max=n - 1)
        cd, nx = step(xf[:, p], x)
        codes[rows, p] = torch.where(ok, cd, codes[rows, p])
        x = torch.where(ok, nx, x)
    end = x
    stats = {"rounds": 0, "rewalked": 0, "fixed_tiles": 0}

    def resolve(segs: torch.Tensor, head: torch.Tensor, use_head: torch.Tensor) -> None:
        """Rounds over the segments `segs` (one tile, consecutive) for the
        lanes where `use_head` (else segment 0 keeps its start)."""
        rounds = 0
        while True:
            rounds += 1
            pred = torch.cat([torch.where(use_head, head, start[:, segs[0]])[:, None],
                              end[:, segs[:-1]]], dim=1)
            redo = _bits(pred) != _bits(start[:, segs])
            now, spec = pred.clone(), start[:, segs].clone()
            walking = redo.clone()
            for k in range(seg):
                pos = first[segs] + k
                ok = pos < n
                p = pos.clamp(max=n - 1)
                walking &= ok & (_bits(now) != _bits(spec))
                if not walking.any():
                    break
                stats["rewalked"] += int(walking.sum())
                old = codes[rows, p]
                spec = torch.where(walking, replay(old, spec), spec)
                cd, nx = step(xf[:, p], now)
                codes[rows, p] = torch.where(walking, cd, old)
                now = torch.where(walking, nx, now)
            changed = redo & (_bits(now) != _bits(spec))
            start[:, segs] = torch.where(redo, pred, start[:, segs])
            end[:, segs] = torch.where(changed, now, end[:, segs])
            if not changed.any():
                break
        stats["rounds"] = max(stats["rounds"], rounds)

    tiles = [torch.arange(nseg)[i: i + threads] for i in range(0, nseg, threads)]
    nobody = torch.zeros(lanes, dtype=torch.bool)
    for segs in tiles:
        resolve(segs, start[:, 0], nobody)
    state = end[:, tiles[0][-1]].clone()
    for segs in tiles[1:]:
        off = _bits(state) != _bits(start[:, segs[0]])
        if off.any():
            stats["fixed_tiles"] += 1
            resolve(segs, state, off)
        state = end[:, segs[-1]].clone()
    out = torch.zeros((c, lanes, b, 2), dtype=torch.int32)
    out[..., 0] = codes.reshape(lanes, c, b).permute(1, 0, 2)
    out[0, :, 0, 0] = torch.where(fresh, blocks[0, :, 0], out[0, :, 0, 0])
    bitlen = torch.full((c, lanes, b), width, dtype=torch.int32)
    bitlen[0, :, 0] = torch.where(fresh, 32, width)
    return (out, bitlen, state, torch.ones_like(init)), stats


def int_walk_encode(blocks, xhat, init, qbits, vmax, dmax, mu, width):
    """The kernel's integer walk (`IntWalk` in csrc/delta_nuq.cu) over each
    lane: for integer vmax V and dmax D, one lookup per step of the clipped
    integer delta's (signed code, integer dequantized value) in a table of
    [-D, D], and an int64 clamp-add. Returns the plain version's (codes,
    bitlen, xhat, init)."""
    c, lanes, b = blocks.shape
    n = c * b
    v, dm = int(vmax), int(dmax)
    thr, dec = delta_nuq.quantizer(qbits, dmax, mu, True, "cpu")
    d = torch.arange(-dm, dm + 1)
    mag = torch.searchsorted(thr, d.abs().to(torch.float32), right=True)
    m = dec[mag]
    assert torch.equal(m, m.round()), "the table is not integral"
    code = ((d < 0).to(torch.int32) << (qbits - 1)) | mag.to(torch.int32)
    dq = torch.where(d < 0, -m, m).to(torch.int64)
    xi = tbits._u(blocks.permute(1, 0, 2).reshape(lanes, n)).clamp(max=v)
    x = torch.where(~init, xi[:, 0], xhat.to(torch.int64))
    codes = torch.zeros((c, lanes, b, 2), dtype=torch.int32)
    flat = torch.empty((lanes, n), dtype=torch.int32)
    for k in range(n):
        i = (xi[:, k] - x).clamp(-dm, dm) + dm
        flat[:, k] = code[i]
        x = (x + dq[i]).clamp(0, v)
    codes[..., 0] = flat.reshape(lanes, c, b).permute(1, 0, 2)
    codes[0, :, 0, 0] = torch.where(~init, blocks[0, :, 0], codes[0, :, 0, 0])
    bitlen = torch.full((c, lanes, b), width, dtype=torch.int32)
    bitlen[0, :, 0] = torch.where(~init, 32, width)
    return codes, bitlen, x.to(torch.float32), torch.ones_like(init)


def _then(a, b, v):
    """Clamp-add maps (d, lo, hi) composed: a, then b."""
    return ((a[0] + b[0]).clamp(-v, v), (a[1] + b[0]).clamp(b[1], b[2]),
            (a[2] + b[0]).clamp(b[1], b[2]))


def _apply(m, x):
    return (x + m[0]).clamp(m[1], m[2])


def scan_decode(codes, xhat, init, qbits, vmax, dmax, mu):
    """The clamp-add scan decode in int64, inside the rule: one map per
    symbol, a doubling scan within each block row, the rows' maps scanned
    into each row's start. Returns the plain version's (values, xhat,
    init)."""
    c, lanes, b, _ = codes.shape
    v = int(vmax)
    w0 = codes[..., 0]
    dq = nuq.mulaw_decode_signed(w0, qbits, dmax, mu).clamp(-vmax, vmax)
    assert torch.equal(dq, dq.round()), "outside the rule"
    d = dq.to(torch.int64)
    lo = torch.zeros_like(d)
    hi = torch.full_like(d, v)
    fresh = ~init
    r = tbits._u(w0[0, :, 0]).clamp(max=delta_nuq.u32_limit(vmax))
    d[0, :, 0] = torch.where(fresh, 0, d[0, :, 0])
    lo[0, :, 0] = torch.where(fresh, r, lo[0, :, 0])
    hi[0, :, 0] = torch.where(fresh, r, hi[0, :, 0])
    inc = (d, lo, hi)  # inclusive scan within each row (last axis), doubling
    off = 1
    while off < b:
        prev = tuple(torch.cat([torch.zeros_like(t[..., :off]), t[..., :-off]], dim=-1) for t in inc)
        prev = (prev[0], prev[1], torch.where(torch.arange(b) < off, v, prev[2]))
        inc = _then(prev, inc, v)
        off *= 2
    x0 = torch.where(fresh, 0, xhat.to(torch.int64))
    carry = (torch.zeros(lanes, dtype=torch.int64), torch.zeros(lanes, dtype=torch.int64),
             torch.full((lanes,), v, dtype=torch.int64))
    out = torch.empty((c, lanes, b), dtype=torch.int64)
    for row in range(c):
        x_in = _apply(carry, x0)
        out[row] = _apply(tuple(t[row] for t in inc), x_in[:, None])
        carry = _then(carry, tuple(t[row, :, -1] for t in inc), v)
    return tbits._i32(out), out[-1, :, -1].to(torch.float32), torch.ones_like(init)


# ---------------------------------------------------------------- streams --
def _ecg(n: int) -> np.ndarray:
    return make_dataset("ecg", n_tuples=n, seed=7).stream()[:n]


def _stream(name: str, n: int, seed: int = 0) -> tuple:
    """(uint32[n], codec params): the streams the kernels must stay exact on."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if name == "ecg":
        return _ecg(8192 + n)[8192:], ECG_PARAMS
    if name == "noise":
        return rng.integers(0, 1842, n).astype(np.uint32), ECG_PARAMS
    if name == "square":  # full swings past both bounds: the state clips at 0 and at vmax
        return np.where((t // 37) % 2 == 0, 0, 4000).astype(np.uint32), ECG_PARAMS
    if name == "saw":  # climbs past vmax (the input clips), then drops to 0
        return ((t % 300) * 13).astype(np.uint32), ECG_PARAMS
    if name == "ramp":  # slope 3 against dmax 1: two walks never meet
        return (5 + 3 * t).astype(np.uint32), RAMP_PARAMS
    raise KeyError(name)


def _blocks(values: np.ndarray, b: int) -> torch.Tensor:
    """(C, L, B) blocks of a stream, as the executor shapes them (each
    block's L x B tuples lane-major)."""
    c = values.size // (LANES * b)
    return tbits.u32_tensor(values[: c * LANES * b].reshape(c, LANES, b), "cpu")


def _fresh():
    return torch.zeros(LANES), torch.zeros(LANES, dtype=torch.bool)


def _same(got, want) -> None:
    for g, w in zip(got, want):
        assert torch.equal(_bits(g) if g.dtype == torch.float32 else g,
                           _bits(w) if w.dtype == torch.float32 else w)


# ------------------------------------------------------------------ encode --
@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "seg%d-warm%d-threads%d" % s)
@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("name", ["ecg", "noise", "square", "saw", "ramp"])
def test_speculative_encode_equals_the_serial_walk(name, qbits, split):
    """Two calls of 3 blocks of 4 x 96 tuples (a fresh call, then the state
    carried): codes, bitlens and state bits equal the plain version's."""
    values, params = _stream(name, 6 * LANES * 96)
    blocks = _blocks(values, 96)
    args = (qbits, params["vmax"], params["dmax"], MU, 8 * ((qbits + 7) // 8))
    st_e, st_r = _fresh(), _fresh()
    for half in (blocks[:3].contiguous(), blocks[3:].contiguous()):
        got, _ = spec_encode(half, *st_e, *args, *split)
        want = ref.adpcm_lane_encode_ref(half, *st_r, *args)
        _same(got, want)
        st_e, st_r = got[2:], want[2:]


def test_speculative_encode_at_the_kernels_split_crosses_tiles():
    """The kernel's constants (64-tuple segments, 32-tuple warm-up, 128 per
    tile) over 3 tiles of an ECG lane: equal to the plain version, and on
    calibrated ECG every guess is right (one round, nothing walked again)."""
    values, params = _stream("ecg", 40 * LANES * 512)
    blocks = _blocks(values, 512)
    args = (8, params["vmax"], params["dmax"], MU, 8)
    got, stats = spec_encode(blocks, *_fresh(), *args, *KERNEL_SPLIT)
    _same(got, ref.adpcm_lane_encode_ref(blocks, *_fresh(), *args))
    assert stats == {"rounds": 1, "rewalked": 0, "fixed_tiles": 0}


def test_never_converging_ramp_degrades_to_a_serial_walk():
    """On the ramp no guess converges: every tile takes one round per
    segment (plus the last that sees no change), every tile boundary is
    resolved again, and the codes are still the serial walk's."""
    values, params = _stream("ramp", 8 * LANES * 64)
    blocks = _blocks(values, 64)
    args = (8, params["vmax"], params["dmax"], MU, 8)
    got, stats = spec_encode(blocks, *_fresh(), *args, 16, 8, 4)
    _same(got, ref.adpcm_lane_encode_ref(blocks, *_fresh(), *args))
    tiles = 8 * 64 // (16 * 4)  # a lane's 512 tuples in tiles of 4 segments of 16
    assert stats["rounds"] == 4 + 1 and stats["fixed_tiles"] == tiles - 1


def test_noise_guesses_converge_within_a_segment():
    """Uniform noise: guesses miss, but each re-walk converges inside its
    segment, so the rounds stop after two."""
    values, params = _stream("noise", 8 * LANES * 512, seed=3)
    blocks = _blocks(values, 512)
    args = (8, params["vmax"], params["dmax"], MU, 8)
    got, stats = spec_encode(blocks, *_fresh(), *args, *KERNEL_SPLIT)
    _same(got, ref.adpcm_lane_encode_ref(blocks, *_fresh(), *args))
    assert stats["rounds"] <= 2


@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("name", ["ecg", "noise", "square", "saw", "ramp"])
def test_integer_walk_equals_the_float_walk(name, qbits):
    """Where vmax and dmax are integers, the kernel walks integer states
    by one table lookup and an integer clamp-add per step; that walk gives
    the float32 walk's codes and states exactly (two calls, state carried)."""
    values, params = _stream(name, 6 * LANES * 96, seed=qbits)
    blocks = _blocks(values, 96)
    args = (qbits, params["vmax"], params["dmax"], MU, 8 * ((qbits + 7) // 8))
    st_i, st_r = _fresh(), _fresh()
    for half in (blocks[:3].contiguous(), blocks[3:].contiguous()):
        got = int_walk_encode(half, *st_i, *args)
        want = ref.adpcm_lane_encode_ref(half, *st_r, *args)
        _same(got, want)
        st_i, st_r = got[2:], want[2:]


@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("name", ["ecg", "noise", "square", "ramp"])
def test_speculative_encode_equals_the_reference_codec(name, qbits):
    """Against the reference's jitted `ADPCM.encode`, block after block with
    the state carried (4 blocks of 4 x 64 tuples), and its decode against
    the scan's where the rule holds."""
    values, params = _stream(name, 4 * LANES * 64, seed=qbits)
    blocks = _blocks(values, 64)
    kw = dict(qbits=qbits, **params)
    rc = ralg.make_codec("adpcm", **kw)
    renc, rdec = jax.jit(rc.encode), jax.jit(rc.decode)
    width = 8 * ((qbits + 7) // 8)
    (codes, bitlen, xhat, _), _ = spec_encode(blocks, *_fresh(), qbits, params["vmax"],
                                              params["dmax"], MU, width, 16, 8, 4)
    rs = rc.init_state(LANES)
    for i in range(blocks.shape[0]):
        rs, enc = renc(rs, jnp.asarray(tbits.u32_numpy(blocks[i])))
        np.testing.assert_array_equal(tbits.u32_numpy(codes[i]), np.asarray(enc.codes))
        np.testing.assert_array_equal(bitlen[i].numpy(), np.asarray(enc.bitlen))
    np.testing.assert_array_equal(xhat.numpy(), np.asarray(rs["xhat"]))
    if delta_nuq.lane_decode_kernel(qbits, params["vmax"], params["dmax"], MU) != delta_nuq.SCAN_DECODE:
        return
    back, _, _ = scan_decode(codes, *_fresh(), qbits, params["vmax"], params["dmax"], MU)
    rs = rc.init_state(LANES)
    for i in range(blocks.shape[0]):
        rs, x = rdec(rs, ralg.Encoded(jnp.asarray(tbits.u32_numpy(codes[i])), jnp.asarray(bitlen[i].numpy())))
        np.testing.assert_array_equal(tbits.u32_numpy(back[i]), np.asarray(x))


# ------------------------------------------------------------------ decode --
def _random_codes(rng, c, b, qbits):
    """Random codes in the codec's slots, a fresh lane's raw first symbol
    anywhere in uint32."""
    w = rng.integers(0, 1 << qbits, (c, LANES, b)).astype(np.uint32)
    w[0, :, 0] = rng.integers(0, 2**32, LANES, dtype=np.uint64).astype(np.uint32)
    codes = np.zeros((c, LANES, b, 2), np.uint32)
    codes[..., 0] = w
    return tbits.u32_tensor(codes, "cpu")


@pytest.mark.parametrize("qbits", [4, 8, 12])
@pytest.mark.parametrize("params", [ECG_PARAMS, dict(vmax=float(2**24), dmax=2.0**21),
                                    dict(vmax=float(2**24), dmax=2.0**26)],
                         ids=["ecg", "2^24", "dq-past-vmax"])
def test_scan_decode_equals_the_serial_walk(params, qbits):
    """Random codes (many clips at both bounds; at vmax = 2^24 sums cross
    it, and with dmax 2^26 single deltas exceed it), fresh and then carried
    over two calls: values and state bits equal the plain version's."""
    assert delta_nuq.lane_decode_kernel(qbits, params["vmax"], params["dmax"], MU) == delta_nuq.SCAN_DECODE
    codes = _random_codes(np.random.default_rng(qbits), 6, 48, qbits)
    args = (qbits, params["vmax"], params["dmax"], MU)
    st_s, st_r = _fresh(), _fresh()
    clips = 0
    for half in (codes[:3].contiguous(), codes[3:].contiguous()):
        got = scan_decode(half, *st_s, *args)
        want = ref.adpcm_lane_decode_ref(half, *st_r, *args)
        _same(got, want)
        v = tbits._u(want[0])
        clips += int(((v == 0) | (v == int(params["vmax"]))).sum())
        st_s, st_r = got[1:], want[1:]
    assert clips >= 10


def test_scan_decode_round_trips_the_speculative_encode():
    values, params = _stream("ecg", 4 * LANES * 128)
    blocks = _blocks(values, 128)
    args = (8, params["vmax"], params["dmax"], MU)
    (codes, _, xhat, _), _ = spec_encode(blocks, *_fresh(), *args, 8, *KERNEL_SPLIT)
    got = scan_decode(codes, *_fresh(), *args)
    _same(got, ref.adpcm_lane_decode_ref(codes, *_fresh(), *args))
    assert torch.equal(_bits(got[1]), _bits(xhat))  # the decoder's state is the encoder's


# ---------------------------------------------------------------- the rule --
def test_decode_rule_cases():
    table = nuq.decode_table(7, 358.0, MU, True)
    assert delta_nuq.decode_kernel_for(table, 1841.0) == delta_nuq.SCAN_DECODE
    assert delta_nuq.decode_kernel_for(table, float(2**24)) == delta_nuq.SCAN_DECODE
    assert delta_nuq.decode_kernel_for(table, 1.0) == delta_nuq.SCAN_DECODE
    for vmax in (1841.5, float(2**24 + 2), 0.0, 0.5, -4.0, float("nan"), float("inf"), 2.0**24 + 1):
        assert delta_nuq.decode_kernel_for(table, vmax) == delta_nuq.SERIAL_DECODE, vmax
    unsnapped = nuq.decode_table(7, 358.0, MU, False)  # the Pallas contract's continuous values
    assert delta_nuq.decode_kernel_for(unsnapped, 1841.0) == delta_nuq.SERIAL_DECODE
    bad = table.copy()
    bad[3] = np.nan
    assert delta_nuq.decode_kernel_for(bad, 1841.0) == delta_nuq.SERIAL_DECODE


def test_calibrated_dmax_that_is_not_an_integer_goes_serial():
    """ECG calibrated on tuples 3,988..8,083: dmax 355.812 is not an
    integer, `decode_table` clips its top entry to it, so the table is not
    integral and the decode takes the serial kernel; ECG's own calibration
    (dmax 358.0) takes the scan."""
    values = _ecg(8192)
    kw = calibrated_kwargs("adpcm", values[3988: 3988 + 4096])
    assert kw["dmax"] != int(kw["dmax"])
    table = nuq.decode_table(7, kw["dmax"], MU, True)
    assert table[-1] == np.float32(kw["dmax"])
    assert delta_nuq.lane_decode_kernel(8, kw["vmax"], kw["dmax"], MU) == delta_nuq.SERIAL_DECODE
    kw = calibrated_kwargs("adpcm", values)
    assert kw == ECG_PARAMS
    assert delta_nuq.lane_decode_kernel(8, kw["vmax"], kw["dmax"], MU) == delta_nuq.SCAN_DECODE


def test_serial_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors both `_serial` wrappers are the plain versions and
    count no launch, as every wrapper."""
    values, params = _stream("saw", 2 * LANES * 32)
    blocks = _blocks(values, 32)
    args = (8, params["vmax"], params["dmax"], MU)
    ops.reset_launches()
    enc = ops.adpcm_lane_encode_serial(blocks, *_fresh(), *args, 8)
    _same(enc, ref.adpcm_lane_encode_ref(blocks, *_fresh(), *args, 8))
    dec = ops.adpcm_lane_decode_serial(enc[0], *_fresh(), *args)
    _same(dec, ref.adpcm_lane_decode_ref(enc[0], *_fresh(), *args))
    assert not any(ops.launch_counts().values())
