"""Kernel B10 (GQA flash-attention forward) in the port against the
reference: on the CPU `ops.flash_attention_fwd` runs its plain version
(`ref.flash_reference`, dense float32 softmax), held against the reference's
Pallas kernel in interpret mode (`repro.kernels.ops.flash_attention_fwd`)
and its dense oracle (`repro.kernels.ref.flash_reference`).

Tolerances: float32, the reference test's own 2e-4 (rtol and atol, as
`tests/test_kernels.py` holds the Pallas kernel to the oracle): both sides
compute in float32 and differ by summation order and by the score scale
(a product with f32(1/sqrt(Dh)) in the kernel, a division in the oracle).
bfloat16 output: one bf16 rounding step, |a - b| <= 2^-7 |b| + 1e-6, since
both sides round float32 results that agree to ~1e-6 into bf16.

Tests marked `cuda` hold the CUDA kernel against the plain version on the
card and skip without one."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn, ops, ref

F32_TOL = 2e-4


@pytest.fixture
def reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref.flash_reference)."""
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro.kernels.ref import flash_reference

    return jnp, rops, flash_reference


@pytest.fixture
def cuda():
    """The CUDA device, or a skip when there is none (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kh, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kh, dh)).astype(np.float32))


def _bf16_close(got: torch.Tensor, want: torch.Tensor) -> None:
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= w.abs() * 2.0**-7 + 1e-6).all()), (g - w).abs().max()


@pytest.mark.parametrize(
    "B,S,H,K,Dh,window,bq,bk",
    [
        (2, 64, 4, 2, 32, None, 16, 32),
        (1, 128, 8, 8, 16, 48, 32, 64),
        (2, 96, 6, 2, 64, None, 32, 32),
        (1, 64, 4, 1, 128, None, 64, 64),  # MQA, full-Dh tile
        (1, 256, 4, 2, 32, 32, 64, 64),  # late rows' leading kv tiles fully masked
    ],
)
def test_plain_version_matches_pallas_and_oracle(reference, B, S, H, K, Dh, window, bq, bk):
    jnp, rops, rflash = reference
    q, k, v = _qkv(B * S + Dh, B, S, S, H, K, Dh)
    got = ops.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), window=window).numpy()
    pallas = rops.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=window, bq=bq, bk=bk)
    oracle = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=F32_TOL, atol=F32_TOL)
    assert np.isfinite(got).all()


def test_plain_version_bf16_matches_pallas(reference):
    """bf16 in, bf16 out: both compute in float32 and round once."""
    jnp, rops, _ = reference
    q, k, v = _qkv(2, 1, 64, 64, 4, 2, 32)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = ops.flash_attention_fwd(*(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                                    for a in (qb, kb, vb)))
    assert got.dtype == torch.bfloat16
    pallas = rops.flash_attention_fwd(qb, kb, vb, bq=32, bk=32)
    _bf16_close(got, torch.from_numpy(np.array(pallas.astype(jnp.float32))))


@pytest.mark.parametrize("S,window,causal", [(23, None, True), (100, 7, True), (77, 20, False),
                                              (1000, None, True)])
def test_plain_version_ragged_lengths_match_oracle(reference, S, window, causal):
    """Any S (the Pallas kernel needs S % bq == 0; the port's kernel masks
    the ragged edge), with and without a window, causal or not."""
    jnp, _, rflash = reference
    q, k, v = _qkv(S, 1, S, S, 4, 2, 32)
    got = ops.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), window=window, causal=causal)
    want = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_windowed_rows_with_masked_leading_tiles_are_finite():
    """-1e30, not -inf: rows whose first 64-key tiles are all masked still
    give finite outputs, equal to attending over their window alone."""
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 300, 300, 2, 1, 16))
    got = ops.flash_attention_fwd(q, k, v, window=10)
    assert torch.isfinite(got).all()
    row = 250
    alone = ops.flash_attention_fwd(q[:, row - 9:row + 1].contiguous(), k[:, row - 9:row + 1].contiguous(),
                                    v[:, row - 9:row + 1].contiguous(), causal=True)
    torch.testing.assert_close(got[:, row], alone[:, -1], rtol=F32_TOL, atol=F32_TOL)


def test_wrapper_checks_inputs_and_counts_no_cpu_call():
    ops.reset_launches()
    q, k, v = (torch.zeros(s) for s in ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ops.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention_fwd(torch.zeros((1, 8, 3, 16)), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 8, 2, 256))
        ops.flash_attention_fwd(torch.zeros((1, 8, 4, 256)), big, big)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    out = ops.flash_attention_fwd(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert ops.launch_counts()["flash_attention_fwd"] == 0


def test_flops_count_the_band():
    """Causal S x S: S(S+1)/2 pairs; a window w: the band's pairs."""
    assert flash_attn.flops(1, 4, 4, 1, 1, None, True) == 4 * 10
    assert flash_attn.flops(2, 4, 4, 3, 8, None, False) == 4 * 2 * 3 * 8 * 16
    assert flash_attn.flops(1, 5, 5, 1, 1, 2, True) == 4 * (1 + 2 + 2 + 2 + 2)
    assert flash_attn.flops(4, 2048, 2048, 16, 128, None, True) == 68_753_031_168
    assert flash_attn.scale(128) == np.float32(1 / np.sqrt(128))


# ---------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,K,Dh,window,dtype",
    [
        (4, 2048, 16, 8, 128, None, torch.bfloat16),  # the serving path's prefill
        (2, 512, 8, 2, 128, None, torch.float32),
        (2, 700, 8, 4, 64, 96, torch.float32),  # windowed, leading tiles masked
        (1, 1000, 4, 2, 32, None, torch.float32),  # ragged
        (2, 300, 4, 1, 128, None, torch.bfloat16),  # MQA
    ],
)
def test_cuda_flash_matches_plain_version(cuda, B, S, H, K, Dh, window, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(S, B, S, S, H, K, Dh))
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    want = ref.flash_reference(q, k, v, window=window)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
