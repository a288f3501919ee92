"""The moe family on the card against the CPU at reduced size: `route`
(float32 routing: `sel` equal, gates within 1e-6), `moe_ffn` in float32
(y within 1e-5, aux within 1e-6) and bf16 (routing equal: the router's
product is float32 on both; y within one bf16 step of the CPU's where
every pair agrees), and a reduced qwen3-moe prefill (B10 on the tensor
cores, one launch a layer). The tests are marked `cuda` and skip without
a GPU; they import neither jax nor the reference (the CPU parity with the
reference is tests/test_torch_moe.py's)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.transformer import init_params, prefill


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _ffn_inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": rng.normal(size=(d, e)) / np.sqrt(d),
        "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f),
    }
    x = rng.normal(size=(2, 64, d))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}, torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [("qwen3-moe-30b-a3b", {}), ("mixtral-8x7b", {}),
                                     ("qwen3-moe-30b-a3b", dict(n_experts=16, n_experts_per_token=8,
                                                                capacity_factor=0.5))])
def test_route_on_the_card(cuda, arch, kw):
    cfg = get_arch(arch).model.reduced(**kw)
    p, x = _ffn_inputs(cfg)
    xt = x.reshape(-1, cfg.d_model)
    g_c, s_c, _, aux_c = moe.route(p["router"].to(cuda), cfg, xt.to(cuda))
    g_h, s_h, _, aux_h = moe.route(p["router"], cfg, xt)
    assert torch.equal(s_c.cpu(), s_h)
    assert (g_c.cpu() - g_h).abs().max().item() <= 1e-6
    assert abs(aux_c.item() - aux_h.item()) <= 1e-6
    cap = moe.capacity(xt.shape[0], cfg)
    for a, b in zip(moe._dispatch_indices(s_c.reshape(-1), cfg.n_experts, cap),
                    moe._dispatch_indices(s_h.reshape(-1), cfg.n_experts, cap)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_ffn_on_the_card(cuda, arch, dtype):
    cfg = get_arch(arch).model.reduced(dtype=dtype)
    dt = getattr(torch, dtype)
    p, x = _ffn_inputs(cfg, 1)
    p, x = {k: v.to(dt) for k, v in p.items()}, x.to(dt)
    y_c, aux_c = moe.moe_ffn({k: v.to(cuda) for k, v in p.items()}, cfg, x.to(cuda))
    y_h, aux_h = moe.moe_ffn(p, cfg, x)
    assert y_c.dtype == dt and abs(aux_c.item() - aux_h.item()) <= 1e-6
    d = (y_c.cpu().float() - y_h.float()).abs()
    if dtype == "float32":
        assert d.max().item() <= 1e-5
    else:
        assert bool((d <= y_h.float().abs() * 2.0**-7 + 2.0**-7).all())


@pytest.mark.cuda
def test_reduced_moe_prefill_on_the_card(cuda):
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model.reduced(), n_layers=2)
    model = init_params(cfg, 0, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(3)).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        cache, logits = prefill(model, cfg, toks, 100)
    assert ops.launch_counts()["flash_attention_fwd_tc"] == 2
    assert bool(torch.isfinite(logits).all()) and cache["pos"] == 96
