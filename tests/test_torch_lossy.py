"""The port's lossy codecs (adpcm, uaadpcm, leb128_nuq, uanuq, pla) and their
mu-law tables against the reference, on the CPU.

The reference's codecs run their quantizer under `jit`, where XLA folds
each division by a constant into a multiplication by its float32
reciprocal; the port's tables (`repro_torch.core.algorithms.nuq`) follow
that folded sequence, so the reference functions are compared jitted:
  * decode tables equal the reference's exactly on a grid of (bits, vmax);
  * encoder codes equal the reference's exactly on the paper's Rovio words
    at the codecs' defaults and on every integer delta ADPCM quantizes at
    its default and ECG-calibrated ranges, and at 11 magnitude bits over
    [0, 2^21] (the tables take XLA's own CPU `log1p`, transcribed);
  * the float32 -> uint32 saturation of the reference's `.astype`;
  * each codec's symbols, bitlens, decoded values and state, block after
    block with carried state, on ECG (calibrated) and Rovio (defaults);
  * frames of either package decode under the other to the same values.
Inputs are made with numpy from a seed and given to both packages."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cstream
from repro.core import algorithms as ralg
from repro.core.algorithms import nuq as rnuq
from repro.core.pipeline import CompressionPipeline as RefCompression
from repro.core.pipeline import DecompressionPipeline as RefDecompression
from repro_torch import api
from repro_torch.core import algorithms as talg
from repro_torch.core import bits as tbits
from repro_torch.core.algorithms import Encoded
from repro_torch.core.algorithms import nuq as tnuq
from repro_torch.core.calibration import calibrated_kwargs
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline
from repro_torch.data import make_dataset

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
LANES = 4
LOSSY = ("adpcm", "uaadpcm", "leb128_nuq", "uanuq", "pla")
U32_MAX = float(2**32 - 1)
#: (bits, vmax) of the decode-table grid: the codecs' defaults, ADPCM's
#: default delta range and an ECG-calibrated one, and unit ranges
TABLE_GRID = [(12, U32_MAX), (8, U32_MAX), (7, 2.0**21), (11, 2.0**21), (7, 360.0),
              (7, 1.0), (11, 1.0)]


def _ecg(n: int = 8 * 8192) -> np.ndarray:
    return make_dataset("ecg", n_tuples=n, seed=7).stream()


def _rovio(words: int) -> np.ndarray:
    return make_dataset("rovio", n_tuples=words // 4, seed=7).stream()[:words]


def _data(name: str):
    """(stream, codec kwargs): ECG calibrated on its first 8,192 tuples, or
    Rovio at the codecs' defaults."""
    return (_ecg(), "ecg") if name == "ecg" else (_rovio(32768), "rovio")


def _kwargs(codec: str, dataset: str, stream: np.ndarray) -> dict:
    return calibrated_kwargs(codec, stream[:8192]) if dataset == "ecg" else {}


# ---------------------------------------------------------------- the tables --
@pytest.mark.parametrize("round_int", [True, False])
@pytest.mark.parametrize("nbits,vmax", TABLE_GRID)
def test_decode_table_equals_jitted_reference(nbits, vmax, round_int):
    codes = jnp.arange(1 << nbits, dtype=jnp.uint32)
    ref = jax.jit(partial(rnuq.mulaw_decode_unsigned, qbits=nbits, vmax=vmax, round_int=round_int))
    theirs = np.asarray(ref(codes))
    ours = tnuq.decode_table(nbits, vmax, tnuq.DEFAULT_MU, round_int)
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    got = tnuq.mulaw_decode_unsigned(torch.arange(1 << nbits, dtype=torch.int32), nbits, vmax,
                                     round_int=round_int)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), theirs.view(np.uint32))


def test_tables_follow_the_jitted_reference(capsys):
    """Why the tables emulate the jitted reference: at (12, 2^32-1) the
    eager reference (true divisions) and a float64 `pow` rounded once both
    differ from what the jitted codecs compute; the counts are printed
    (`pytest -s`), the table's equality is asserted."""
    codes = jnp.arange(4096, dtype=jnp.uint32)
    jitted = np.asarray(jax.jit(partial(rnuq.mulaw_decode_unsigned, qbits=12, vmax=U32_MAX))(codes))
    eager = np.asarray(rnuq.mulaw_decode_unsigned(codes, 12, U32_MAX))
    f32 = np.float32
    y = np.arange(4096, dtype=f32) * (f32(1) / f32(4095))
    p64 = np.power(256.0, y.astype(np.float64)).astype(f32)
    f64_pow = np.clip(np.round((p64 - f32(1)) * ((f32(1) / f32(255)) * f32(U32_MAX))), 0, f32(U32_MAX))
    ours = tnuq.decode_table(12, U32_MAX)
    np.testing.assert_array_equal(ours.view(np.uint32), jitted.view(np.uint32))
    with capsys.disabled():
        print(f"\n(12, 2^32-1) decode entries differing from the jitted reference: "
              f"eager reference {int((eager != jitted).sum())}, float64 pow "
              f"{int((f64_pow.astype(f32) != jitted).sum())}, tables {int((ours != jitted).sum())} of 4096")


def _ref_codes(v: np.ndarray, nbits: int, vmax: float) -> np.ndarray:
    enc = jax.jit(partial(rnuq.mulaw_encode_unsigned, qbits=nbits, vmax=vmax))
    return np.asarray(enc(jnp.asarray(v))).astype(np.int64)


def _port_codes(v: np.ndarray, nbits: int, vmax: float) -> np.ndarray:
    t = torch.from_numpy(v) if v.dtype == np.float32 else tbits.u32_tensor(v, CPU)
    return tnuq.mulaw_encode_unsigned(t, nbits, vmax).numpy().astype(np.int64)


@pytest.mark.parametrize("qbits", [12, 8])
def test_encoder_equals_reference_on_rovio_words_at_defaults(qbits):
    """The uanuq (12) and leb128_nuq (8) defaults over 932,800 Rovio words,
    clipped and converted as the codecs do."""
    words = _rovio(932_800)
    v = np.minimum(words, np.uint32(int(U32_MAX)))
    np.testing.assert_array_equal(_port_codes(v, qbits, U32_MAX), _ref_codes(v, qbits, U32_MAX))


def _ecg_dmax() -> float:
    return calibrated_kwargs("adpcm", _ecg()[:8192])["dmax"]


@pytest.mark.parametrize("dmax", [2.0**21, 360.0, "ecg"])
def test_encoder_equals_reference_on_every_integer_delta(dmax):
    """ADPCM at qbits 8 quantizes integer deltas (its reconstruction snaps
    to integers): 7 magnitude bits, every |d| in [0, dmax], exhaustively."""
    dmax = _ecg_dmax() if dmax == "ecg" else dmax
    d = np.arange(int(dmax) + 1, dtype=np.float32)
    np.testing.assert_array_equal(_port_codes(d, 7, dmax), _ref_codes(d, 7, dmax))


def test_encoder_agreement_rate_at_eleven_magnitude_bits():
    """qbits 12 over [0, 2^21]: 10 of 2,097,153 integer deltas get a code one
    off, where XLA's CPU `log1p` rounds apart from the correctly rounded
    value the tables use (measured; ROADMAP C2). Pinned at >= 1 - 1e-5."""
    d = np.arange(2**21 + 1, dtype=np.float32)
    ours, theirs = _port_codes(d, 11, 2.0**21), _ref_codes(d, 11, 2.0**21)
    differ = ours != theirs
    print(f"11 magnitude bits over [0, 2^21]: {int(differ.sum())} of {d.size} codes differ")
    assert differ.sum() <= 1e-5 * d.size, int(differ.sum())
    assert np.abs(ours - theirs).max() <= 1


def test_encoder_equals_reference_at_eleven_magnitude_bits():
    """qbits 12 over [0, 2^21], every integer delta: with XLA's CPU `log1p`
    transcribed (FMAs included), no code differs (ROADMAP C2)."""
    d = np.arange(2**21 + 1, dtype=np.float32)
    ours, theirs = _port_codes(d, 11, 2.0**21), _ref_codes(d, 11, 2.0**21)
    print(f"11 magnitude bits over [0, 2^21]: {int((ours != theirs).sum())} of {d.size} codes differ")
    np.testing.assert_array_equal(ours, theirs)


def test_log1p_transcription_matches_xla_cpu():
    """`nuq._xla_log1p_f32` against `jax.jit(jnp.log1p)` bit for bit on
    10.5M float32: the small branch [0, 0.41421357) (uniform, and bit
    patterns from 0 so subnormals too), the encoder's range [0, mu], up to
    and past 2^21, bit patterns up to +inf, negatives down past -1, and the
    special values."""
    rng = np.random.default_rng(11)

    def patterns(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint32).view(np.float32)

    samples = [
        rng.uniform(0.0, 0.41421357, 3_000_000).astype(np.float32),
        patterns(0, 0x3ED413CD, 1_500_000),
        rng.uniform(0.0, tnuq.DEFAULT_MU, 2_000_000).astype(np.float32),
        rng.uniform(0.0, 2.0**22, 2_000_000).astype(np.float32),
        patterns(0x3ED413CC, 0x7F800001, 1_500_000),
        rng.uniform(-1.5, 0.0, 500_000).astype(np.float32),
        np.array([0.0, -0.0, 1.1754944e-38, 1e-45, np.inf, -1.0, -2.0, np.nan, 0.41421357,
                  0.41421354, 2.0**21, tnuq.DEFAULT_MU], np.float32),
    ]
    xla = jax.jit(jnp.log1p)
    assert sum(s.size for s in samples) >= 10_000_000
    for x in samples:
        ours = tnuq._xla_log1p_f32(x)
        theirs = np.asarray(xla(jnp.asarray(x)))
        np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))


@pytest.mark.parametrize("qbits,dmax", [(8, 360.0), (4, 1.0)])
def test_signed_quantizer_equals_reference(qbits, dmax):
    """Sign bit + magnitude, both ways, over deltas in [-dmax, dmax]."""
    d = np.linspace(-dmax, dmax, 20001, dtype=np.float32)
    enc = jax.jit(partial(rnuq.mulaw_encode_signed, qbits=qbits, dmax=dmax))
    theirs = np.asarray(enc(jnp.asarray(d)))
    ours = tnuq.mulaw_encode_signed(torch.from_numpy(d), qbits, dmax)
    np.testing.assert_array_equal(tbits.u32_numpy(ours), theirs)
    for round_int in (True, False):
        dec = jax.jit(partial(rnuq.mulaw_decode_signed, qbits=qbits, dmax=dmax, round_int=round_int))
        back = tnuq.mulaw_decode_signed(ours, qbits, dmax, round_int=round_int).numpy()
        np.testing.assert_array_equal(back.view(np.uint32), np.asarray(dec(jnp.asarray(theirs))).view(np.uint32))


@pytest.mark.parametrize("nbits,vmax", [(7, 360.0), (11, 1.0), (8, U32_MAX)])
def test_thresholds_are_the_least_inputs_of_each_code(nbits, vmax):
    """Each threshold has its code and the float32 just below it does not."""
    thr = tnuq.encode_thresholds(nbits, vmax, tnuq.DEFAULT_MU)
    k = np.arange(1, thr.size + 1)
    below = np.nextafter(thr, np.float32(-1))
    assert (tnuq.emulate_encode(thr, nbits, vmax) >= k).all()
    assert (tnuq.emulate_encode(below, nbits, vmax) < k).all()
    assert (np.diff(thr) >= 0).all()


def test_decode_saturates_like_the_reference():
    """At vmax 2^32-1 the top code decodes to float32 4294967296, which the
    reference's `.astype(uint32)` saturates to 4294967295 (a 32-bit mask
    would give 0)."""
    top = tnuq.decode_table(8, U32_MAX)[-1]
    assert top == np.float32(2**32)
    ours = tnuq.to_u32_saturating(torch.tensor([top, 5e9, -1.0, 7.0], dtype=torch.float32))
    theirs = np.asarray(jnp.asarray(np.float32([top, 5e9, -1.0, 7.0])).astype(jnp.uint32))
    np.testing.assert_array_equal(tbits.u32_numpy(ours), theirs)
    for name in ("leb128_nuq", "uanuq"):
        tc, rc = talg.make_codec(name), ralg.make_codec(name)
        x = np.full((1, 4), 2**32 - 1, np.uint32)
        _, enc = tc.encode(None, tbits.u32_tensor(x, CPU))
        _, back = tc.decode(None, enc)
        _, renc = rc.encode(None, jnp.asarray(x))
        _, rback = jax.jit(rc.decode)(None, renc)
        np.testing.assert_array_equal(tbits.u32_numpy(back), np.asarray(rback))
        assert tbits.u32_numpy(back)[0, 0] == 2**32 - 1


def test_mulaw_max_abs_err_is_the_reference_bound():
    for nbits, vmax in TABLE_GRID:
        assert tnuq.mulaw_max_abs_err(nbits, vmax) == rnuq.mulaw_max_abs_err(nbits, vmax)


def test_tables_refuse_widths_past_their_limit():
    with pytest.raises(ValueError, match="code width"):
        tnuq.decode_table(tnuq.MAX_TABLE_BITS + 1, 1.0)


# ----------------------------------------------------------------- the codecs --
def _same_state(codec, ours, theirs):
    ours = talg.state_to_numpy(codec, ours)
    if ours is None:
        assert theirs is None
        return
    for k, v in ours.items():
        np.testing.assert_array_equal(v, np.asarray(theirs[k]), err_msg=k)
        assert v.dtype == np.asarray(theirs[k]).dtype


@pytest.mark.parametrize("dataset", ["ecg", "rovio"])
@pytest.mark.parametrize("codec", LOSSY)
def test_codec_matches_reference_block_by_block(codec, dataset):
    """Symbols, bitlens, decoded values and state over four blocks of 4 x 64
    tuples with the state carried, against the reference's jitted codec."""
    stream, dataset = _data(dataset)
    kw = _kwargs(codec, dataset, stream)
    tc, rc = talg.make_codec(codec, **kw), ralg.make_codec(codec, **kw)
    ts_e, ts_d = tc.init_state(LANES, CPU), tc.init_state(LANES, CPU)
    rs_e, rs_d = rc.init_state(LANES), rc.init_state(LANES)
    renc, rdec = jax.jit(rc.encode), jax.jit(rc.decode)
    for i in range(4):
        blk = stream[4096 + i * LANES * 64: 4096 + (i + 1) * LANES * 64].reshape(LANES, 64)
        ts_e, et = tc.encode(ts_e, tbits.u32_tensor(blk, CPU))
        rs_e, er = renc(rs_e, jnp.asarray(blk))
        np.testing.assert_array_equal(tbits.u32_numpy(et.codes), np.asarray(er.codes))
        np.testing.assert_array_equal(et.bitlen.numpy(), np.asarray(er.bitlen))
        _same_state(tc, ts_e, rs_e)
        ts_d, xt = tc.decode(ts_d, et)
        rs_d, xr = rdec(rs_d, er)
        np.testing.assert_array_equal(tbits.u32_numpy(xt), np.asarray(xr))
        _same_state(tc, ts_d, rs_d)
        bound = tc.error_bound()
        if bound is not None:
            err = np.abs(tbits.u32_numpy(xt).astype(np.int64) - blk.astype(np.int64)).max()
            assert err <= bound


@pytest.mark.parametrize("codec", ["adpcm", "uaadpcm"])
def test_adpcm_chunk_equals_sequential_blocks(codec):
    """One codec-form call over C blocks (one kernel launch on the card)
    gives the symbols and state of C sequential calls."""
    stream = _ecg()
    tc = talg.make_codec(codec, **calibrated_kwargs(codec, stream[:8192]))
    blocks = tbits.u32_tensor(stream[: 5 * LANES * 16].reshape(5, LANES, 16), CPU)
    st_chunk, enc = tc.encode_blocks(tc.init_state(LANES, CPU), blocks)
    st = tc.init_state(LANES, CPU)
    for i in range(5):
        st, e = tc.encode(st, blocks[i])
        assert torch.equal(enc.codes[i], e.codes) and torch.equal(enc.bitlen[i], e.bitlen)
    assert torch.equal(st_chunk["xhat"], st["xhat"]) and torch.equal(st_chunk["init"], st["init"])
    _, back = tc.decode_blocks(tc.init_state(LANES, CPU), enc)
    dec = tc.init_state(LANES, CPU)
    for i in range(5):
        dec, x = tc.decode(dec, Encoded(enc.codes[i], enc.bitlen[i]))
        assert torch.equal(back[i], x)


@pytest.mark.parametrize("codec", LOSSY)
def test_meta_and_params_equal_the_reference(codec):
    assert talg.accepted_params(codec) == ralg.accepted_params(codec)
    tm, rm = talg.make_codec(codec).meta, ralg.make_codec(codec).meta
    assert vars(tm) == vars(rm)
    assert talg.make_codec(codec).error_bound() == ralg.make_codec(codec).error_bound()


# ---------------------------------------------------- frames across packages --
def _specs(codec: str, dataset: str, stream: np.ndarray, entropy=None):
    kw = dict(codec=codec, lanes=LANES, micro_batch_bytes=512, scan_chunk=2, entropy=entropy)
    ts = api.JobSpec(**kw).calibrated(stream[:8192]) if dataset == "ecg" else api.JobSpec(**kw)
    rs = cstream.JobSpec(**kw).calibrated(stream[:8192]) if dataset == "ecg" else cstream.JobSpec(**kw)
    assert ts.to_dict() == rs.to_dict()
    return ts, rs


@pytest.mark.parametrize("dataset", ["ecg", "rovio"])
@pytest.mark.parametrize("codec", LOSSY)
def test_frames_decode_across_packages(codec, dataset):
    """A stream of 10 blocks plus a ragged tail: the frames are
    byte-identical, each package decodes the other's frame to the values
    the other decodes, and bounded codecs stay within `error_bound()`."""
    stream, dataset = _data(dataset)
    ts, rs = _specs(codec, dataset, stream)
    v = stream[8192: 8192 + 10 * 128 + 77]
    ours = CompressionPipeline(ts, device=CPU).compress_to_frame(v).to_bytes()
    theirs = RefCompression(rs).compress_to_frame(v).to_bytes()
    assert ours == theirs
    port_back = DecompressionPipeline(ts, device=CPU).ingest(theirs).values
    ref_back = RefDecompression(rs).ingest(ours).values
    np.testing.assert_array_equal(port_back, ref_back)
    bound = talg.make_codec(codec, **ts.codec_kwargs).error_bound()
    if bound is not None:
        assert np.abs(port_back.astype(np.int64) - v.astype(np.int64)).max() <= bound


@pytest.mark.parametrize("codec", LOSSY)
def test_run_roundtrip_fidelity_on_ecg(codec):
    """`JobSpec(codec).calibrated(sample)` through `run_roundtrip`: the
    fidelity check holds the bounded codecs to `error_bound()`."""
    stream = _ecg()
    spec = api.JobSpec(codec=codec, lanes=LANES, micro_batch_bytes=512).calibrated(stream[:8192])
    pipe, decomp = CompressionPipeline(spec, device=CPU), DecompressionPipeline(spec, device=CPU)
    rt = api.run_roundtrip(pipe, decomp, spec, stream[:3000])
    assert rt.values.size == 3000
    bound = pipe.codec.error_bound()
    if bound is not None:
        assert rt.fidelity.bound == bound and rt.fidelity.max_abs <= bound
    assert rt.wire_bytes < 3000 * 4

