"""The training path on the card: B10's log-sum-exp form against its plain
version (out bit for bit the plain form's kernel output, lse within 1e-4 +
1e-5 |plain|), the flash backward and a `make_train_step` step on the card
against the CPU, and the feed's decode through B2. The tests are marked
`cuda` and skip without a GPU; they import neither jax nor the reference
(the CPU parity with the reference is tests/test_torch_train.py's)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import CompressedFeed, zipf_token_stream
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import init_params
from repro_torch.optim import AdamWConfig


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 50])
def test_lse_form_on_the_card(cuda, dtype, window):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((2, 300, 8, 128), (2, 300, 2, 128), (2, 300, 2, 128)))
    ops.reset_launches()
    out, lse = ops.flash_attention_fwd_lse(q, k, v, window=window)
    counter = "flash_attention_fwd_lse" if dtype == torch.bfloat16 else "flash_attention_fwd_lse_fma"
    assert {n: c for n, c in ops.launch_counts().items() if c} == {counter: 1}
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, window=window))
    _, want = ref.flash_reference_lse(q, k, v, window=window)
    assert bool(((lse - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_lse_fma_form_takes_bf16_on_the_card(cuda):
    """The FMA kernel's lse form on bf16 inputs the dispatcher sends to the
    tensor cores: out within one bf16 step, lse within 1e-4 + 1e-5 |plain|,
    one launch on its own counter."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((2, 300, 8, 128), (2, 300, 2, 128), (2, 300, 2, 128)))
    ops.reset_launches()
    out, lse = ops.flash_attention_fwd_lse_fma(q, k, v)
    assert {n: c for n, c in ops.launch_counts().items() if c} == {"flash_attention_fwd_lse_fma": 1}
    want_out, want = ref.flash_reference_lse(q, k, v)
    assert bool(((out.float() - want_out.float()).abs() <= want_out.float().abs() * 2.0**-7 + 1e-6).all())
    assert bool(((lse - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_flash_backward_card_matches_cpu(cuda):
    """float32: the autograd function's gradients on the card within 1e-4
    of the CPU's (B10's float32 kernel against the dense plain version)."""
    rng = np.random.default_rng(2)
    qkv = [rng.normal(size=s).astype(np.float32) for s in ((2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in qkv]
        out = layers.FlashAttention.apply(*ts, 17, True)
        torch.sum(out ** 2).backward()
        grads[dev.type] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda):
    """One float32 step of a reduced model: loss within 1e-5 relative,
    parameters' mean difference within 1e-6."""
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").model.reduced(dtype="float32"), remat="full")
    tree = params_to_numpy(init_params(cfg, 0, "cpu", param_dtype="float32"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = params_from_numpy(tree, cfg, dev, param_dtype="float32")
        init, step = make_train_step(cfg, AdamWConfig(lr=1e-3), device=dev)
        from repro_torch.optim import adamw

        model, _, m = step(model, adamw(AdamWConfig(lr=1e-3))[0](dict(model.named_parameters())),
                           {"inputs": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)})
        out[dev.type] = (m["loss"].item(), params_to_numpy(model))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    a, b = out["cuda"][1]["layers"]["attn"]["wq"], out["cpu"][1]["layers"]["attn"]["wq"]
    assert np.abs(a - b).mean() <= 1e-6


@pytest.mark.cuda
def test_feed_decodes_on_the_card_through_b2(cuda):
    """The trainer's feed at 4 x 1,024: batches equal to the source's
    tokens, one B2 launch each, and B2's codes over a batch's whole stream
    (one block) equal to its plain version's on the same words."""
    ops.reset_launches()
    feed = CompressedFeed(zipf_token_stream(151936, 4, 1024, seed=4), device=cuda).start()
    src = zipf_token_stream(151936, 4, 1024, seed=4)
    try:
        for _ in range(3):
            b = feed.next_batch()
            got = torch.cat([b["inputs"], b["labels"][:, -1:]], dim=1).cpu().numpy()
            np.testing.assert_array_equal(got, next(src))
    finally:
        feed.stop()
    assert ops.launch_counts()["unpack_blocks"] == 3
    payload, _ = feed._pack(next(src))
    words = torch.from_numpy(payload["words"])[None]
    bitlen = torch.from_numpy(payload["bitlen"]).reshape(-1).to(torch.int32)
    codes = ops.unpack_blocks(words.to(cuda), bitlen.to(cuda), block=bitlen.numel())
    assert torch.equal(codes.cpu(), ref.unpack_blocks_ref(words, bitlen))
