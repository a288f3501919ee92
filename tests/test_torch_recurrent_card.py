"""The ssm and hybrid families on the card against the CPU at reduced size:
`rglru_apply` and `mamba2_apply`/`mamba2_decode` in float32 (outputs and
states within 1e-4: float32 products summed in another order on the card,
TF32 off), and a reduced recurrentgemma at head dim 256 in bf16 (its local
attention on B10's tensor-core instance for heads above 128, one launch a
group; logits within 3 % of the largest, as chip_smoke's LM_CHECK). The
tests are marked `cuda` and skip without a GPU; they import neither jax nor
the reference (the CPU parity with the reference is
tests/test_torch_recurrent.py's)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import rglru, ssd
from repro_torch.models.transformer import init_params, prefill


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _params(module) -> dict:
    return {k: v.detach() for k, v in module.params().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 300])
def test_rglru_apply_on_the_card(cuda, s):
    cfg = get_arch("recurrentgemma-9b").model.reduced(dtype="float32")
    model = init_params(cfg, 0, "cpu")
    p = _params(model.groups[0].rec1.rglru)
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(2, cfg.lru_width)).astype(np.float32))
    want = rglru.rglru_apply(p, x, h0)
    got = rglru.rglru_apply({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), h0.to(cuda))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mamba2_apply_and_decode_on_the_card(cuda):
    cfg = get_arch("mamba2-1.3b").model.reduced(dtype="float32")
    model = init_params(cfg, 0, "cpu")
    p = _params(model.layers[0].mixer)
    pc = {k: v.to(cuda) for k, v in p.items()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
    h0 = ssd.init_ssm_state(2, cfg)
    want = ssd.mamba2_apply(p, cfg, x, h0)
    got = ssd.mamba2_apply(pc, cfg, x.to(cuda), h0.to(cuda))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)
    xt = x[:, :1]
    want = ssd.mamba2_decode(p, cfg, xt, want[1], want[2])
    got = ssd.mamba2_decode(pc, cfg, xt.to(cuda), got[1], got[2])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_recurrentgemma_prefill_at_head_dim_256_on_the_card(cuda):
    """5 layers (one group and the tail), 16 query heads over 1 of 256, a
    window of 64 under a 200-token prompt: one tensor-core B10 launch."""
    base = get_arch("recurrentgemma-9b").model
    cfg = base.reduced(n_layers=5, n_heads=16, n_kv_heads=1, head_dim=256, d_model=256, lru_width=256)
    assert (cfg.head_dim, cfg.family, cfg.dtype) == (256, "hybrid", "bfloat16")
    model = init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 200)).astype(np.int32))
    cache_h, logits_h = prefill(model, cfg, toks)
    ops.reset_launches()
    cache_c, logits_c = prefill(model.to(cuda), cfg, toks.to(cuda))
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    assert counts["flash_attention_fwd_tc"] == 1 and counts["flash_attention_fwd"] == 0
    scale = logits_h.float().abs().max().item()
    assert (logits_c.float().cpu() - logits_h.float()).abs().max().item() <= 0.03 * scale
    assert cfg.local_window < 200
    codes = (cache_c["groups"]["attn"]["k_codes"].cpu() == cache_h["groups"]["attn"]["k_codes"]).double().mean()
    assert codes.item() >= 0.8
