"""The port's NUQ-compressed KV cache (`repro_torch.core.kvcache`) against
the reference's (`repro.core.kvcache`), run under `jax.jit` as the
reference's serving path runs it, on the same numpy inputs.

What is exact and what is a rate:
  * the dequantization table is bit-equal (the same float64 construction);
  * scales are bit-equal (absmax + 1e-6) and dequantization of equal codes
    is bit-equal (table lookup times scale);
  * codes: the port's 7-bit mu-law encoder is its host-built threshold
    table (ROADMAP C2), which follows the jitted reference's quantizer but
    evaluates `log1p` in float64 where XLA has its own approximation, so a
    value next to a code boundary can land one code apart. The agreement
    rate is pinned at >= 1 - 1e-5 (one differing code in 100,000) and
    printed under `-s`;
  * the decode read over equal codes agrees to 1e-6 in float32 and exactly
    in bfloat16 (same dequantized blocks, same bf16 roundings of p and the
    PV product, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as rk
from repro_torch.core import kvcache as tk

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CODE_RATE = 1 - 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rate(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_dequant_table_is_bit_equal():
    np.testing.assert_array_equal(tk._DEQUANT_TABLE_8.view(np.uint32), rk._DEQUANT_TABLE_8.view(np.uint32))
    for qbits in (4, 6):
        np.testing.assert_array_equal(tk._build_dequant_table(qbits).view(np.uint32),
                                      rk._build_dequant_table(qbits).view(np.uint32))


@pytest.mark.parametrize("shape,sigma", [((2, 256, 2, 32), 1.0), ((1, 384, 8, 128), 3.0),
                                         ((3, 40, 1, 16), 0.2)])
def test_quantize_block_matches_jitted_reference(shape, sigma):
    x = np.random.default_rng(sum(shape)).normal(0, sigma, shape).astype(np.float32)
    codes_r, scale_r = jax.jit(rk.quantize_block)(x)
    codes_t, scale_t = tk.quantize_block(_t(x))
    np.testing.assert_array_equal(scale_t.numpy().view(np.uint32), np.asarray(scale_r).view(np.uint32))
    assert codes_t.dtype == torch.uint8 and tuple(codes_t.shape) == shape
    rate = _rate(codes_t.numpy(), codes_r)
    diff = np.abs(codes_t.numpy().astype(int) - np.asarray(codes_r).astype(int))
    print(f"quantize_block {shape}: code agreement {rate:.7f} over {x.size} values, max diff {diff.max()}")
    assert rate >= CODE_RATE
    assert diff.max() <= 1  # a differing code is one level apart, never a sign


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_reference(dtype):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 256, (2, 256, 2, 16)).astype(np.uint8)
    scale = rng.uniform(0.1, 3, (2, 2, 2)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda c, s: rk.dequantize_block(c, s, dtype=jdt))(codes, scale)
    got = tk.dequantize_block(_t(codes), _t(scale), dtype=tdt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    want = jax.jit(lambda c, s: rk.dequantize_block_kmajor(c, s, 256, dtype=jdt))(codes, scale)
    got = tk.dequantize_block_kmajor(_t(codes), _t(scale), 256, dtype=tdt)
    assert tuple(got.shape) == (2, 2, 256, 16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _layer(rng, b=2, w=128, kh=2, dh=16):
    k = rng.normal(size=(b, w, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, w, kh, dh)).astype(np.float32)
    kc, ks = jax.jit(rk.quantize_block)(k)
    vc, vs = jax.jit(rk.quantize_block)(v)
    return {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs}


def _port_layer(layer):
    return {k: _t(v) for k, v in layer.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w,pos,window", [(128, 63, None), (128, 127, None), (128, 200, None),
                                          (128, 100, 48), (64, 1000, None), (256, 300, 90)])
def test_decode_attention_quant_matches_reference(dtype, w, pos, window):
    """Blocks of 64 keys over the ring; positions before the ring fills,
    at its end, wrapped around (pos 1000 over W = 64) and windowed."""
    rng = np.random.default_rng(w + pos)
    layer = _layer(rng, w=w)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda q, c: rk.decode_attention_quant(q, c, jnp.asarray(pos), window, kv_block=64))(
        jnp.asarray(q).astype(jdt), layer)
    got = tk.decode_attention_quant(_t(q).to(tdt), _port_layer(layer), pos, window, kv_block=64)
    assert got.dtype == tdt and tuple(got.shape) == (2, 1, 4, 16)
    tol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", [5, 127, 130, 1000])
def test_append_then_attend_matches_reference(pos):
    """The single-view decode: append the token at slot pos % W against its
    group's scale (clipped), then scan the whole ring."""
    rng = np.random.default_rng(pos)
    layer = _layer(rng, w=256)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k_t = rng.normal(0, 2, (2, 1, 2, 16)).astype(np.float32)  # some values clip
    v_t = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
    out_r, cl_r = jax.jit(lambda q, c, k, v: rk.decode_attend_dlse(q, c, k, v, jnp.asarray(pos), None))(
        q, layer, k_t, v_t)
    cl_t = _port_layer(layer)
    out_t, cl_t = tk.decode_attend_dlse(_t(q), cl_t, _t(k_t), _t(v_t), pos, None)
    for name in ("k_codes", "v_codes"):
        rate = _rate(cl_t[name].numpy(), cl_r[name])
        assert rate >= CODE_RATE, (name, rate)
    appended = jax.jit(lambda c, k, v: rk.append_token_layer(c, k, v, jnp.asarray(pos)))(layer, k_t, v_t)
    np.testing.assert_array_equal(cl_t["k_codes"].numpy(), np.asarray(appended["k_codes"]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,w", [(256, 256), (200, 256), (40, 64), (300, 512)])
def test_prefill_layer_matches_reference(s, w):
    """A whole prefill written at slot 0 of layer 1 of a 3-layer cache: S
    padded with zeros to the scale group, scales bit-equal, codes at
    CODE_RATE, the other layers untouched, the length set to S."""
    rng = np.random.default_rng(s + w)
    k = rng.normal(0, 1.5, (2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    ref = jax.jit(lambda c, k, v: rk.prefill_layer(c, jnp.asarray(1), k, v))(rk.init_cache(3, 2, w, 2, 16), k, v)
    got = tk.prefill_layer(tk.init_cache(3, 2, w, 2, 16, device="cpu"), 1, _t(k), _t(v))
    assert int(got.length) == s == int(ref.length)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(got, name).numpy().view(np.uint32),
                                      np.asarray(getattr(ref, name)).view(np.uint32))
    for name in ("k_codes", "v_codes"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert _rate(a, b) >= CODE_RATE, (name, _rate(a, b))
        np.testing.assert_array_equal(a[[0, 2]], b[[0, 2]])


def test_cache_bytes_counts_codes_and_scales():
    cache = {"k_codes": torch.zeros((4, 2, 256, 2, 32), dtype=torch.uint8),
             "k_scale": torch.zeros((4, 2, 2, 2))}
    assert tk.cache_bytes(cache) == 4 * 2 * 256 * 2 * 32 + 4 * 2 * 2 * 2 * 4
