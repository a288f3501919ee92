"""The reference's last public helpers in the port, held to the reference
on the CPU: `Codec.roundtrip` and `Encoded.total_bits`
(`core/algorithms/base.py`), `QuantKVCache`, `init_cache` and `cache_bytes`
(`core/kvcache.py`), `CompactedPayload.block_payloads` and
`ExecutionResult.payload` (`core/pipeline.py`), and `metrics.timed`.

The same numpy inputs from a seed go through both packages. Lossless
codecs must return their input and the reference's output exactly. Lossy
codecs must equal the reference run under `jax.jit`, as its pipelines run
it (ROADMAP C2), and stay within `error_bound()` where the codec has one.
chip_smoke's `helpers` phase holds the card against the CPU path
(`tests/test_torch_helpers_card.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ralg
from repro.core import kvcache as rk
from repro.core import metrics as rmetrics
from repro.core.pipeline import CompressionPipeline as RefCompression
from repro.core.strategies import EngineConfig as RefEngineConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import bits as tbits
from repro_torch.core import kvcache as tk
from repro_torch.core import metrics as tmetrics
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.strategies import EngineConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
#: every codec of Table 1 and raw32
CODECS = ("raw32",) + tuple(talg.PAPER_TABLE1.values())
#: a lossy codec's parameters for a 16-bit walk (the reference's egress
#: tests' settings)
KWARGS = {
    "uanuq": dict(qbits=12, vmax=65535.0),
    "leb128_nuq": dict(qbits=12, vmax=65535.0),
    "adpcm": dict(vmax=65535.0),
    "uaadpcm": dict(vmax=65535.0),
    "pla": dict(eps=8.0),
}


def _walk(seed: int, shape) -> np.ndarray:
    """A 16-bit random walk with repeats (runs for rle, dictionary hits for
    tdic32), uint32 (lanes, B)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, shape) * (rng.random(shape) < 0.6)
    return np.clip(np.cumsum(steps, axis=1) + 30_000, 0, 65535).astype(np.uint32)


def test_codec_list_is_table_one_and_raw32():
    assert len(CODECS) == 11 and set(CODECS) == {"raw32"} | set(ralg.PAPER_TABLE1.values())


@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_matches_the_reference(codec):
    x = _walk(len(codec), (4, 1536))
    tc, rc = talg.make_codec(codec, **KWARGS.get(codec, {})), ralg.make_codec(codec, **KWARGS.get(codec, {}))
    got = tbits.u32_numpy(tc.roundtrip(tbits.u32_tensor(x, CPU)))
    want = np.asarray(jax.jit(rc.roundtrip)(jnp.asarray(x)))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    if not tc.meta.lossy:
        np.testing.assert_array_equal(got, x)
    elif tc.error_bound() is not None:
        assert np.abs(got.astype(np.int64) - x.astype(np.int64)).max() <= tc.error_bound()


@pytest.mark.parametrize("codec", ["raw32", "tcomp32", "rle", "tdic32", "leb128_nuq"])
def test_total_bits_matches_the_reference(codec):
    x = _walk(7, (4, 512))
    tc, rc = talg.make_codec(codec, **KWARGS.get(codec, {})), ralg.make_codec(codec, **KWARGS.get(codec, {}))
    _, enc_t = tc.encode(tc.init_state(4, CPU), tbits.u32_tensor(x, CPU))
    _, enc_r = jax.jit(rc.encode)(rc.init_state(4), jnp.asarray(x))
    total = enc_t.total_bits
    assert total.dim() == 0 and not total.is_floating_point() and total.device == CPU
    assert int(total) == int(enc_r.total_bits) == int(enc_t.bitlen.sum())


@pytest.mark.parametrize("dims", [(4, 2, 256, 2, 32), (3, 1, 64, 1, 16), (2, 3, 384, 4, 8)])
def test_init_cache_matches_the_reference(dims):
    ours, theirs = tk.init_cache(*dims, device="cpu"), rk.init_cache(*dims)
    assert ours.window == theirs.window == dims[2]
    for name in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
        a, b = getattr(ours, name), np.asarray(getattr(theirs, name))
        assert a.device == CPU and tuple(a.shape) == b.shape, name
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert tk.cache_bytes(ours) == rk.cache_bytes(theirs)
    assert tk.cache_bytes(ours.tensors()) == rk.cache_bytes(theirs)


def test_init_cache_takes_the_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.init_cache(1, 1, 128, 1, 8)


@pytest.mark.parametrize("s,w", [(256, 256), (200, 256), (40, 64)])
def test_prefill_layer_writes_both_forms_alike(s, w):
    """A `QuantKVCache` and the same tensors in a dict take the same codes
    and scales; the dataclass's length becomes a 0-d int32 tensor."""
    rng = np.random.default_rng(s + w)
    k = torch.from_numpy(rng.normal(0, 1.5, (2, s, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, s, 2, 16)).astype(np.float32))
    cache = tk.init_cache(3, 2, w, 2, 16, device="cpu")
    ring = {n: t.clone() for n, t in cache.tensors().items() if n != "length"}
    got = tk.prefill_layer(cache, 1, k, v)
    assert got is cache and cache.length.dtype == torch.int32 and int(cache.length) == s
    tk.prefill_layer(ring, 1, k, v)
    assert ring["length"] == s
    for name in ("k_codes", "v_codes", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, name), ring[name]), name


def _pipes(codec: str):
    kw = dict(codec=codec, codec_kwargs=dict(KWARGS.get(codec, {})), micro_batch_bytes=2048, lanes=4,
              calibrate=False)
    return CompressionPipeline(EngineConfig(**kw), device="cpu"), RefCompression(RefEngineConfig(**kw))


@pytest.mark.parametrize("codec", ["rle", "tcomp32", "leb128_nuq"])
def test_block_payloads_match_the_reference_and_the_legacy_collection(codec):
    """Per-block views of the compacted payload: equal to the reference's
    and to the port's `compact=False` collection (`tests/test_egress.py`'s
    check of the reference), views of the fetched arrays, not copies."""
    pipe, ref = _pipes(codec)
    values = np.repeat(np.arange(7, dtype=np.uint32), pipe.block_tuples // 2) * 97
    values = np.concatenate([values, _walk(3, (1, pipe.block_tuples + 300))[0]])
    rc = pipe.execute(pipe.shape_blocks(values), collect_payload=True, compact=True)
    ro = pipe.execute(pipe.shape_blocks(values), collect_payload=True, compact=False)
    want = ref.execute(ref.shape_blocks(values), collect_payload=True, compact=True).compacted.block_payloads()
    views = rc.compacted.block_payloads()
    assert rc.payload is not None and len(rc.payload) == len(views)
    assert len(views) == len(ro.payload) == len(want)
    for a, b, r in zip(views, ro.payload, want):
        assert a.nbits == b.nbits == r.nbits and a.valid == b.valid == r.valid
        assert np.shares_memory(a.words, rc.compacted.payload) or a.words.size == 0
        assert np.shares_memory(a.bitlen, rc.compacted.bitlen) or a.bitlen.size == 0
        np.testing.assert_array_equal(a.bitlen, np.asarray(b.bitlen).ravel())
        np.testing.assert_array_equal(a.bitlen, np.asarray(r.bitlen))
        used = (a.nbits + 31) // 32
        assert a.words.size == used
        np.testing.assert_array_equal(a.words, np.asarray(b.words[:used]))
        np.testing.assert_array_equal(a.words, np.asarray(r.words))


def test_d2h_bytes_meter_both_egress_paths_as_the_reference_does():
    """The pipeline's egress meter: the compacted path fetches less than the
    legacy worst-case buffers, and both equal the reference's counts."""
    pipe, ref = _pipes("tcomp32")
    values = _walk(5, (1, 3 * pipe.block_tuples + 700))[0]
    counts = []
    for p in (pipe, ref):
        row = []
        for compact in (True, False):
            p.reset_d2h()
            p.execute(p.shape_blocks(values), collect_payload=True, compact=compact)
            row.append(p.d2h_bytes)
        counts.append(row)
    assert counts[0] == counts[1]
    assert counts[0][1] > 2 * counts[0][0] > 0


def test_timed_returns_the_result_and_a_positive_time():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": torch.as_tensor(a) + b, "parts": [torch.zeros(2)]}

    out, secs = tmetrics.timed(fn, 2, 3, warmup=2, iters=4)
    assert len(calls) == 6 and int(out["sum"]) == 5 and secs > 0
    ref_out, ref_secs = rmetrics.timed(lambda a, b: jnp.asarray(a) + b, 2, 3)
    assert int(ref_out) == int(out["sum"]) and ref_secs > 0
