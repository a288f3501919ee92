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

On the card, bf16 inputs with Dh a multiple of 16 run on the tensor-core
kernel, whose p@v takes p as three bf16 terms. A plain-torch emulation of
those numerics (dense, float32 products of the bf16 terms with v) is held
to the plain version under the bf16 rule here, beside the emulations with
one and two terms, which break it: that is why the kernel splits p in
three.

Tests marked `cuda` hold the CUDA kernels against the plain version on the
card, with and without a logit softcap, and skip without one."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn, ops, ref

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

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


def _bf16_outside(got: torch.Tensor, want: torch.Tensor) -> int:
    """Outputs not within one bf16 step (NaN counts as outside)."""
    g, w = got.float(), want.float()
    return int((~((g - w).abs() <= w.abs() * 2.0**-7 + 1e-6)).sum())


def _split_emulation(q, k, v, window, causal, terms, softcap=None):
    """The tensor-core kernel's numerics in dense plain torch: bf16 q.k
    products in float32 (exact) scaled by f32(1/sqrt(Dh)), capped to
    softcap * tanh(s / softcap) when `softcap` is given, masked scores at
    -1e30, float32 p = exp(s - max) and l = sum(p), then p@v as `terms`
    float32 products of bf16 terms of p (each the bf16 rounding of what the
    terms before it leave), summed, divided by max(l, 1e-30), in bf16."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * flash_attn.scale(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    out, rest = 0.0, p
    for _ in range(terms):
        term = rest.bfloat16().float()
        out = out + torch.einsum("bhqk,bkhd->bqhd", term, vv)
        rest = rest - term
    return (out / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]).bfloat16()


def _bf16_qkv(seed, b, sq, sk, h, kh, dh, cancel=False):
    """bf16 q, k, v from a seed; with `cancel`, v minus its mean over the
    keys, so long rows' outputs sit near 0 where the rule is tightest."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kh, dh)).astype(np.float32)
    if cancel:
        v -= v.mean(axis=1, keepdims=True)
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


#: (B, Sq, Sk, H, K, Dh, window, causal, cancel, seed) for the emulation
SPLIT_CASES = [
    (1, 256, 256, 8, 2, 128, None, True, False, 1),  # causal
    (1, 200, 200, 4, 2, 64, 40, True, False, 2),  # windowed
    (2, 150, 100, 4, 2, 32, None, True, False, 3),  # ragged, Sk < Sq
    (1, 100, 180, 4, 2, 48, 30, True, False, 4),  # Sk > Sq, windowed
    (1, 160, 160, 8, 1, 64, None, True, False, 5),  # MQA
    (1, 192, 192, 4, 2, 128, None, True, True, 7),  # v drawn to cancel
    (1, 130, 130, 4, 4, 16, None, False, True, 8),  # not causal, cancelling
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,cancel,seed", SPLIT_CASES)
def test_three_term_split_emulation_is_within_one_bf16_step(B, Sq, Sk, H, K, Dh, window, causal,
                                                            cancel, seed):
    q, k, v = _bf16_qkv(seed, B, Sq, Sk, H, K, Dh, cancel)
    got = _split_emulation(q, k, v, window, causal, terms=3)
    want = ref.flash_reference(q, k, v, window, causal)
    assert _bf16_outside(got, want) == 0
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,cancel,seed", SPLIT_CASES)
def test_three_term_split_emulation_with_cap_is_within_one_bf16_step(B, Sq, Sk, H, K, Dh, window, causal,
                                                                     cancel, seed):
    """With a logit softcap (the kernel caps each scaled score before its
    softmax) three bf16 terms of p still keep every output within one bf16
    step of the capped plain version, and the cap moves some output by more
    than 100x that step."""
    q, k, v = _bf16_qkv(seed, B, Sq, Sk, H, K, Dh, cancel)
    got = _split_emulation(q, k, v, window, causal, terms=3, softcap=1.0)
    want = ref.flash_reference(q, k, v, window, causal, softcap=1.0)
    assert _bf16_outside(got, want) == 0
    uncapped = ref.flash_reference(q, k, v, window, causal).float()
    assert bool(((uncapped - want.float()).abs() > 100 * (want.float().abs() * 2.0**-7 + 1e-6)).any())


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,cancel,seed", SPLIT_CASES)
def test_p_rounded_once_to_bf16_breaks_the_rule(B, Sq, Sk, H, K, Dh, window, causal, cancel, seed):
    """Why p is split: one bf16 rounding of p (a bf16 p@v product) puts
    outputs outside one bf16 step on every case."""
    q, k, v = _bf16_qkv(seed, B, Sq, Sk, H, K, Dh, cancel)
    want = ref.flash_reference(q, k, v, window, causal)
    assert _bf16_outside(_split_emulation(q, k, v, window, causal, terms=1), want) > 0


def test_two_term_split_breaks_the_rule_on_short_rows():
    """Why three terms: p_hi + p_lo carries p to 2^-18 and still puts two
    outputs of this causal case outside one bf16 step (both in short rows,
    where the 1e-6 floor of the rule dominates)."""
    q, k, v = _bf16_qkv(1, 1, 256, 256, 8, 2, 128)
    want = ref.flash_reference(q, k, v)
    got = _split_emulation(q, k, v, None, True, terms=2)
    bad = ~((got.float() - want.float()).abs() <= want.float().abs() * 2.0**-7 + 1e-6)
    assert int(bad.sum()) > 0
    assert int(bad.nonzero()[:, 1].max()) < 64  # positions of short rows
    assert _bf16_outside(_split_emulation(q, k, v, None, True, terms=3), want) == 0


@pytest.mark.parametrize(
    "dtype,Dh,G,aligned,rows,kernel",
    [
        (torch.bfloat16, 128, 2, True, 4096, flash_attn.TENSOR_CORE),  # the lm path
        (torch.bfloat16, 16, 1, True, 1, flash_attn.TENSOR_CORE),
        (torch.bfloat16, 80, 16, True, 100, flash_attn.TENSOR_CORE),
        (torch.bfloat16, 64, 64, True, 100, flash_attn.TENSOR_CORE),
        (torch.bfloat16, 40, 2, True, 100, flash_attn.FMA),  # Dh % 16 != 0
        (torch.bfloat16, 8, 2, True, 100, flash_attn.FMA),
        (torch.bfloat16, 128, 65, True, 100, flash_attn.FMA),  # G > 64
        (torch.bfloat16, 128, 2, False, 100, flash_attn.FMA),  # misaligned
        (torch.bfloat16, 128, 2, True, 2**31, flash_attn.FMA),  # rows past 32-bit indexing
        (torch.float32, 128, 2, True, 4096, flash_attn.FMA),  # float32 contract
        (torch.float32, 64, 1, True, 100, flash_attn.FMA),
        (torch.bfloat16, 256, 16, True, 8192, flash_attn.TENSOR_CORE),  # recurrentgemma's prefill
        (torch.bfloat16, 192, 4, True, 100, flash_attn.TENSOR_CORE),
        (torch.bfloat16, 264, 2, True, 100, flash_attn.FMA),  # past 256 (the wrapper refuses it)
        (torch.float32, 256, 16, True, 8192, flash_attn.FMA),
    ],
)
def test_dispatch_rule(dtype, Dh, G, aligned, rows, kernel):
    assert flash_attn.kernel_for(dtype, Dh, G, aligned, rows) == kernel


def test_tensor_core_wrapper_on_cpu_takes_its_rule_and_no_more():
    """`flash_attention_fwd_tc`: inside the rule the plain version on CPU
    tensors (and no launch counted), outside it a ValueError."""
    ops.reset_launches()
    q, k, v = _bf16_qkv(9, 1, 40, 40, 4, 2, 32)
    torch.testing.assert_close(ops.flash_attention_fwd_tc(q, k, v, window=7),
                               ref.flash_reference(q, k, v, window=7), rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention_fwd_tc"] == 0
    with pytest.raises(ValueError, match="outside the tensor-core kernel's rule"):
        ops.flash_attention_fwd_tc(q.float(), k.float(), v.float())
    q40, k40, v40 = _bf16_qkv(9, 1, 40, 40, 4, 2, 40)
    with pytest.raises(ValueError, match="outside the tensor-core kernel's rule"):
        ops.flash_attention_fwd_tc(q40, k40, v40)


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


@pytest.mark.parametrize(
    "B,Sq,Sk,H,K,Dh,window,causal",
    [
        (1, 96, 96, 16, 1, 256, 40, True),  # recurrentgemma's head: G 16 over one kv head, windowed
        (2, 50, 70, 4, 2, 256, None, True),  # ragged, Sk > Sq
        (1, 40, 40, 4, 2, 192, None, False),
        (1, 33, 33, 2, 1, 136, 9, True),
    ],
)
def test_plain_version_wide_heads_match_oracle(reference, B, Sq, Sk, H, K, Dh, window, causal):
    """Head dims above 128 (ROADMAP C6): both forms' plain versions on the
    CPU against the reference's dense oracle, float32 within 2e-4; the lse
    form's out equal to the plain form's, its lse that of the scaled,
    masked float32 scores (numpy, float64) within 1e-5."""
    jnp, _, rflash = reference
    q, k, v = _qkv(Dh + Sq, B, Sq, Sk, H, K, Dh)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention_fwd(tq, tk, tv, window=window, causal=causal)
    want = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    out, lse = ops.flash_attention_fwd_lse(tq, tk, tv, window=window, causal=causal)
    assert torch.equal(out, got) and lse.shape == (B, H, Sq)
    kk = np.repeat(k, H // K, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * np.float32(1 / np.sqrt(Dh))
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = np.where(mask, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)


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
        big = torch.zeros((1, 8, 2, 264))
        ops.flash_attention_fwd(torch.zeros((1, 8, 4, 264)), big, big)
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
#: chip_smoke.py's FLASH_CASES and wide-head cases like its
#: RECURRENT_FLASH_CASES: (B, Sq, Sk, H, K, Dh, window, causal, dtype)
FLASH_CASES = [
    (4, 2048, 2048, 16, 8, 128, None, True, torch.bfloat16),  # the serving path's prefill
    (2, 512, 512, 8, 2, 128, None, True, torch.float32),
    (2, 700, 700, 8, 4, 64, 96, True, torch.float32),  # windowed, leading tiles masked
    (1, 1000, 1000, 4, 2, 32, None, True, torch.float32),  # ragged
    (2, 300, 300, 4, 1, 128, None, True, torch.bfloat16),  # MQA
    (2, 300, 300, 4, 1, 128, 40, True, torch.float32),  # MQA, windowed
    (2, 700, 700, 8, 4, 64, 96, True, torch.bfloat16),  # Dh 64, windowed
    (2, 333, 250, 8, 2, 80, None, True, torch.bfloat16),  # ragged, Sk < Sq, Dh 80
    (2, 200, 300, 8, 2, 96, 40, True, torch.bfloat16),  # Sk > Sq, windowed, Dh 96
    (1, 250, 250, 4, 4, 128, None, True, torch.bfloat16),  # G 1
    (1, 250, 250, 16, 1, 128, None, True, torch.bfloat16),  # G 16 (MQA)
    (1, 1000, 1000, 4, 2, 32, None, True, torch.bfloat16),  # Dh 32
    (1, 333, 333, 4, 2, 16, 50, True, torch.bfloat16),  # Dh 16, windowed
    (1, 190, 190, 4, 2, 128, None, False, torch.bfloat16),  # not causal
    (1, 200, 200, 4, 2, 40, None, True, torch.bfloat16),  # Dh 40: the FMA kernel in bf16
    (1, 1024, 1024, 16, 1, 256, 512, True, torch.bfloat16),  # recurrentgemma's head, windowed
    (2, 333, 400, 8, 2, 256, 100, True, torch.bfloat16),  # Dh 256, ragged, Sk > Sq
    (1, 500, 500, 8, 2, 192, None, True, torch.bfloat16),  # Dh 192
    (1, 600, 600, 4, 1, 256, 256, True, torch.float32),  # Dh 256 on the FMA kernel
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,dtype", FLASH_CASES)
def test_cuda_flash_matches_plain_version(cuda, B, Sq, Sk, H, K, Dh, window, causal, dtype):
    """`ops.flash_attention_fwd` on the card: the kernel `kernel_for` names
    launches once, within the tolerance of its dtype."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(Sq, B, Sq, Sk, H, K, Dh))
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, window=window, causal=causal)
    kernel = flash_attn.kernel_for(dtype, Dh, H // K)
    assert ops.launch_counts() == {**{n: 0 for n in ops.WRAPPERS}, kernel: 1}
    want = ref.flash_reference(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


#: chip_smoke.py's capped cases, each with its cap: (B, Sq, Sk, H, K, Dh,
#: window, causal, dtype, softcap)
CAP_CASES = [
    (2, 512, 512, 8, 8, 64, None, True, torch.bfloat16, 1.0),  # musicgen's G 1, Dh 64
    (2, 700, 700, 8, 4, 64, 96, True, torch.bfloat16, 2.0),  # windowed: leading tiles masked
    (2, 333, 250, 8, 2, 128, None, True, torch.bfloat16, 1.5),  # ragged, Sk < Sq
    (1, 200, 300, 8, 2, 128, 40, True, torch.bfloat16, 1.0),  # Sk > Sq, windowed
    (1, 333, 400, 8, 2, 256, 100, True, torch.bfloat16, 2.0),  # Dh 256, ragged, windowed
    (1, 190, 190, 4, 2, 128, None, False, torch.bfloat16, 0.5),  # not causal
    (2, 300, 300, 8, 2, 64, 50, True, torch.float32, 1.0),  # float32: the FMA kernel
    (1, 200, 200, 4, 2, 40, None, True, torch.bfloat16, 1.0),  # Dh 40: the FMA kernel in bf16
]


def _tolerance(want: torch.Tensor) -> torch.Tensor:
    """The elementwise rule of the dtype: one bf16 step, or 2e-4 + 2e-4 |w|."""
    w = want.float().abs()
    return w * 2.0**-7 + 1e-6 if want.dtype == torch.bfloat16 else F32_TOL + F32_TOL * w


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,dtype,cap", CAP_CASES)
def test_cuda_flash_with_cap_matches_plain_version(cuda, B, Sq, Sk, H, K, Dh, window, causal, dtype, cap):
    """Both forms of B10 with a logit softcap on the kernel `kernel_for`
    names: out within its dtype's rule of the capped plain version, lse
    within 1e-4 + 1e-5 |plain|, the lse form's out the plain form's; and
    the cap moves some output by more than 100x the rule."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(5 * Sq + Dh, B, Sq, Sk, H, K, Dh))
    kernel = flash_attn.kernel_for(dtype, Dh, H // K)
    lse_form = "flash_attention_fwd_lse" if kernel == flash_attn.TENSOR_CORE else "flash_attention_fwd_lse_fma"
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, window=window, causal=causal, softcap=cap)
    got_lse, lse = ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal, softcap=cap)
    assert ops.launch_counts() == {**{n: 0 for n in ops.WRAPPERS}, kernel: 1, lse_form: 1}
    want, want_lse = ref.flash_reference_lse(q, k, v, window=window, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, got_lse)
    assert bool(((got.float() - want.float()).abs() <= _tolerance(want)).all())
    assert bool(((lse - want_lse).abs() <= 1e-4 + 1e-5 * want_lse.abs()).all())
    uncapped = ref.flash_reference(q, k, v, window=window, causal=causal).float()
    assert bool(((uncapped - want.float()).abs() > 100 * _tolerance(want)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,dtype",
                         [c for c in FLASH_CASES if flash_attn.kernel_for(c[8], c[5], c[3] // c[4])
                          == flash_attn.TENSOR_CORE])
def test_cuda_tensor_core_kernel_matches_plain_version(cuda, B, Sq, Sk, H, K, Dh, window, causal,
                                                       dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(3 * Sq + Sk, B, Sq, Sk, H, K, Dh))
    got = ops.flash_attention_fwd_tc(q, k, v, window=window, causal=causal)
    want = ref.flash_reference(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _bf16_close(got, want)
