"""The port's transformer layers (`repro_torch.models.layers`) against the
reference's (`repro.models.layers`, run under `jax.jit` as its serving path
runs them), in float32 on the same numpy inputs at qwen3-1.7b's reduced
width.

Tolerances (float32): 2e-6 for the elementwise layers (rsqrt, pow, sin and
cos of XLA and torch may differ by an ulp; rope's `theta ** x` at theta =
1e6 included), 1e-5 for the layers with matrix products (summation order
over d_model = 128) and for the blocked attention scan (the same order of
ops, sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rl
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CFG = get_arch("qwen3-1.7b").model.reduced(dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(2024)


def test_rms_norm(rng):
    x = rng.normal(0, 3, (2, 7, 128)).astype(np.float32)
    gamma = rng.normal(0, 0.1, (128,)).astype(np.float32)
    want = jax.jit(rl.rms_norm)(x, gamma)
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(gamma))), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("theta,head_dim", [(1e6, 32), (1e4, 128), (1e6, 128)])
def test_rope(rng, theta, head_dim):
    pos = np.broadcast_to(np.arange(300, dtype=np.int32)[None], (2, 300)).copy()
    pos[1] += 1000
    c_r, s_r = jax.jit(rl.rope_angles, static_argnums=(1, 2))(pos, head_dim, theta)
    c_t, s_t = tl.rope_angles(_t(pos), head_dim, theta)
    # angles reach 1300 rad: an ulp of the angle moves sin/cos by ~1e-4 * ulp
    np.testing.assert_allclose(_np(c_t), np.asarray(c_r), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(s_t), np.asarray(s_r), rtol=0, atol=2e-4)
    x = rng.normal(size=(2, 300, 4, head_dim)).astype(np.float32)
    want = jax.jit(rl.apply_rope)(x, c_r, s_r)
    got = tl.apply_rope(_t(x), _t(c_r), _t(s_r))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_swiglu(rng):
    p = {"w_gate": rng.normal(size=(128, 256)) / 11.3, "w_up": rng.normal(size=(128, 256)) / 11.3,
         "w_down": rng.normal(size=(256, 128)) / 16}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    want = jax.jit(rl.swiglu)(p, x)
    got = tl.swiglu({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_attention_qkv(rng, qk_norm):
    cfg = dataclasses.replace(CFG, qk_norm=qk_norm)
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, h * dh)), "wk": rng.normal(size=(d, kh * dh)),
         "wv": rng.normal(size=(d, kh * dh)), "q_norm": rng.normal(0, 0.1, dh),
         "k_norm": rng.normal(0, 0.1, dh)}
    p = {k: (v / (np.sqrt(d) if v.ndim == 2 else 1)).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 50, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(50, dtype=np.int32), (2, 50)).copy()
    want = jax.jit(lambda p, x, pos: rl.attention_qkv(p, cfg, x, pos))(p, x, pos)
    got = tl.attention_qkv({k: _t(v) for k, v in p.items()}, cfg, _t(x), _t(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap,ragged", [(None, None, False), (16, None, True),
                                                    (None, 30.0, True)])
def test_blocked_flash_attention(rng, dtype, window, softcap, ragged):
    """The general scan (positions, kv_valid, window, softcap; keys padded to
    whole blocks) that the raw-cache decode runs. bfloat16 holds the
    reference's roundings (scores and p in bf16): the output agrees to one
    bf16 step."""
    b, sq, sk, h, kh, dh = 2, 5, 70, 4, 2, 32
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kh, dh)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(60, 65, dtype=np.int32), (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    valid = rng.random((b, sk)) < (0.8 if ragged else 1.1)
    jdt = jnp.dtype(dtype)
    want = jax.jit(
        lambda q, k, v, qp, kp, ok: rl.flash_attention(q, k, v, qp, kp, kv_valid=ok, window=window,
                                                       kv_block=32, softcap=softcap)
    )(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), qpos, kpos, valid)
    tdt = getattr(torch, dtype)
    got = tl.flash_attention(*(_t(a).to(tdt) for a in (q, k, v)), _t(qpos), _t(kpos), _t(valid),
                             window=window, kv_block=32, softcap=softcap)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
