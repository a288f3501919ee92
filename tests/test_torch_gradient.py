"""The port's gradient codec (`repro_torch.core.gradient`) against the
reference's (`repro.core.gradient`, run under `jax.jit`: its quantizer's
divisions by constants fold differently eager, ROADMAP C2), and the
reference's own checks (`tests/test_gradient.py`) mirrored.

Codes and scales are held equal (the mu-law tables are the jitted
reference's, the absmax and the division exact in both); the dequantized
values equal too. The sync's mean over slots sums in another order than
`jnp.mean`: 1e-7 absolute there; error feedback within 2e-5 of a leaf's
absmax (see `test_ef_steps_match_reference`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st  # skips when absent

from repro.core import gradient as rg
from repro_torch.core import gradient as tg
from repro_torch.runtime.elastic import make_mesh

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores


def _cfgs(**kw):
    return rg.GradCompressionConfig(**kw), tg.GradCompressionConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [((513, 37), 2048), ((1000,), 64), ((32773,), 2048), ((7,), 16), ((64, 64), 512), ((3, 5, 7), 32)]


@pytest.mark.parametrize("qbits", [4, 8])
@pytest.mark.parametrize("shape,chunk", CASES)
def test_codes_and_scales_equal_jitted_reference(qbits, shape, chunk):
    x = np.random.default_rng(hash((shape, chunk)) % 2**32).normal(0, 0.02, shape).astype(np.float32)
    rc, tc = _cfgs(qbits=qbits, chunk=chunk)
    rp, rs = jax.jit(lambda a: rg.quantize_tensor(a, rc)[:2])(jnp.asarray(x))
    tp, ts, n = tg.quantize_tensor(_t(x), tc)
    assert n == x.size and tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    want = jax.jit(lambda p, s: rg.dequantize_tensor(p, s, x.size, shape, rc))(rp, rs)
    np.testing.assert_array_equal(tg.dequantize_tensor(tp, ts, n, shape, tc).numpy(), np.asarray(want))


@pytest.mark.parametrize("qbits,max_rel", [(8, 0.05), (4, 0.5)])
def test_roundtrip_relative_error_bounded(qbits, max_rel):
    x = _t(np.random.default_rng(0).normal(0, 0.02, (513, 37)).astype(np.float32))
    xh = tg.roundtrip(x, tg.GradCompressionConfig(qbits=qbits))
    assert float(torch.linalg.norm(x - xh) / torch.linalg.norm(x)) < max_rel


def test_wire_bytes_ratio_and_reference():
    x = torch.zeros((4096, 256))
    assert tg.wire_bytes(x, tg.GradCompressionConfig(qbits=8)) < x.numel() * 4 / 3.9
    assert tg.wire_bytes(x, tg.GradCompressionConfig(qbits=4)) < x.numel() * 4 / 7.8
    for shape in ((5,), (2049,), (513, 37)):
        for qbits in (4, 8):
            rc, tc = _cfgs(qbits=qbits)
            assert tg.wire_bytes(torch.zeros(shape), tc) == rg.wire_bytes(jnp.zeros(shape), rc)


def test_4bit_packing_exact():
    cfg = tg.GradCompressionConfig(qbits=4, chunk=16)
    x = _t(np.linspace(-1, 1, 64, dtype=np.float32))
    packed, scale, n = tg.quantize_tensor(x, cfg)
    assert packed.dtype == torch.uint8 and packed.numel() == 32
    assert torch.equal(tg.dequantize_tensor(packed, scale, n, x.shape, cfg), tg.roundtrip(x, cfg))


def test_qbits_other_than_4_or_8_refused():
    with pytest.raises(ValueError):
        tg.quantize_tensor(torch.zeros(4), tg.GradCompressionConfig(qbits=6))


def test_error_feedback_reduces_bias():
    x = _t(np.random.default_rng(1).normal(0, 0.01, (2048,)).astype(np.float32))
    cfg = tg.GradCompressionConfig(qbits=4)
    one_step = float(torch.linalg.norm(tg.roundtrip(x, cfg) - x) / torch.linalg.norm(x))
    res = tg.ef_init({"g": x})
    acc = torch.zeros_like(x)
    for _ in range(24):
        ghat, res = tg.ef_step({"g": x}, res, cfg)
        acc = acc + ghat["g"]
    assert float(torch.linalg.norm(acc / 24 - x) / torch.linalg.norm(x)) < one_step / 3


@pytest.mark.parametrize("qbits", [4, 8])
def test_ef_steps_match_reference(qbits):
    """Four error-feedback steps on a nested tree: g_hat and the residual
    within 2e-5 of the leaf's absmax of the jitted reference's (a
    quantization level is ~1e-2 of it at 8 bits). Inside the jitted
    `ef_step` XLA fuses the dequantization's products differently than in
    the reference's jitted `roundtrip` alone, whose values the port's
    tables hold exactly (C2): measured 1e-5 relative on g_hat."""
    rng = np.random.default_rng(qbits)
    grads = [{"a": rng.normal(0, 0.01, (300,)).astype(np.float32),
              "n": {"b": rng.normal(0, 1.0, (17, 5)).astype(np.float32)}} for _ in range(4)]
    rc, tc = _cfgs(qbits=qbits, chunk=64)
    rstep = jax.jit(lambda g, r: rg.ef_step(g, r, rc))
    rres = rg.ef_init(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    tres = tg.ef_init({"a": _t(grads[0]["a"]), "n": {"b": _t(grads[0]["n"]["b"])}})
    for g in grads:
        rh, rres = rstep(jax.tree_util.tree_map(jnp.asarray, g), rres)
        th, tres = tg.ef_step({"a": _t(g["a"]), "n": {"b": _t(g["n"]["b"])}}, tres, tc)
        for got, want in ((th["a"], rh["a"]), (th["n"]["b"], rh["n"]["b"]),
                          (tres["a"], rres["a"]), (tres["n"]["b"], rres["n"]["b"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max() + 1e-12)


@settings(max_examples=25, deadline=None)
@given(scale=st.floats(1e-6, 1e4), n=st.integers(1, 400), seed=st.integers(0, 2**16))
def test_property_quantizer_scale_equivariant(scale, n, seed):
    x = np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)
    cfg = tg.GradCompressionConfig(qbits=8, chunk=64)
    a = tg.roundtrip(_t(x), cfg).numpy()
    b = tg.roundtrip(_t(x * scale), cfg).numpy() / scale
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 300), seed=st.integers(0, 2**16))
def test_property_roundtrip_never_overshoots_absmax(n, seed):
    x = np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)
    xh = tg.roundtrip(_t(x), tg.GradCompressionConfig(qbits=8, chunk=32)).numpy()
    assert np.all(np.abs(xh) <= np.abs(x).max() * (1 + 1e-5))


def test_compressed_sync_single_axis_mesh():
    """The reference's one-device check: on a 1-slot mesh the sync is the
    roundtrip (the mean of one), within the 8-bit codec's error; and it
    equals the reference's sync exactly."""
    g = np.random.default_rng(0).normal(0, 0.01, (64,)).astype(np.float32)
    mesh = make_mesh((1,), ("pod",), device="cpu")
    out = tg.compressed_grad_sync({"w": _t(g)}, mesh, axis="pod", cfg=tg.GradCompressionConfig(qbits=8))
    assert float(torch.linalg.norm(out["w"] - _t(g)) / torch.linalg.norm(_t(g))) < 0.05
    want = rg.compressed_grad_sync({"w": jnp.asarray(g)}, jax.make_mesh((1,), ("pod",)), axis="pod",
                                   cfg=rg.GradCompressionConfig(qbits=8))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("qbits", [4, 8])
def test_compressed_sync_four_slots(qbits):
    """Four CPU slots, each with its own gradients: every slot gets the
    mean of the four dequantized trees (the reference's gather form,
    computed here from its jitted codec)."""
    rng = np.random.default_rng(qbits + 10)
    trees = [{"w": rng.normal(0, 0.01, (700,)).astype(np.float32),
              "n": {"b": rng.normal(0, 1, (33, 3)).astype(np.float32)}} for _ in range(4)]
    rc, tc = _cfgs(qbits=qbits, chunk=128)
    mesh = make_mesh((4,), ("pod",), devices=["cpu"] * 4)
    got = tg.compressed_grad_sync([{"w": _t(t["w"]), "n": {"b": _t(t["n"]["b"])}} for t in trees], mesh,
                                  axis="pod", cfg=tc)
    rt = jax.jit(lambda a: rg.roundtrip(a, rc))
    for key in ("w", "b"):
        leaves = [t["w"] if key == "w" else t["n"]["b"] for t in trees]
        want = np.mean(np.stack([np.asarray(rt(jnp.asarray(x))) for x in leaves]), axis=0)
        for slot in got:
            leaf = slot["w"] if key == "w" else slot["n"]["b"]
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=1e-7)
    assert all(torch.equal(got[0]["w"], s["w"]) for s in got)


def test_sync_refusals():
    """`param_specs=` and a mesh with axes beside the sync axis are taken
    (held to the reference's jitted sync on its one-device mesh: specs
    filtered to the sync axis leave the leaf whole); a mesh without the
    axis, or a tree count that is not the mesh's slot count, is refused."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((1,), ("pod",), device="cpu")
    x = np.random.default_rng(5).normal(0, 0.01, (300,)).astype(np.float32)
    rc, tc = _cfgs(chunk=128)
    want = rg.compressed_grad_sync({"w": jnp.asarray(x)}, jax.make_mesh((1,), ("pod",)), "pod", rc,
                                   {"w": P(("pod", "data"))})
    for m, specs in ((mesh, {"w": (("pod", "data"),)}), (make_mesh((1, 1), ("pod", "data"), device="cpu"),
                                                         {"w": (None,)})):
        got = tg.compressed_grad_sync({"w": _t(x)}, m, cfg=tc, param_specs=specs)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        tg.compressed_grad_sync({"w": torch.zeros(3)}, mesh, axis="data")
    wide = make_mesh((2,), ("pod",), devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        tg.compressed_grad_sync({"w": torch.zeros(3)}, wide)
