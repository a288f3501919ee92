"""Attention logit softcaps in the port (kernel B10's plain version and its
lse form, `models/layers.py` `FlashAttention` and `flash_backward`, the
prefill, both decode reads, `loss_fn`) against the reference, whose
blocked scan caps after the score scale and before the mask
(`repro/models/layers.py` `_chunk_attn_update`) and whose training takes
the cap through autodiff (`_flash_ad`). No config of the ten sets a cap,
so the model tests cap a reduced qwen3-1.7b. The reference runs under
`jax.jit`; inputs come from seeded numpy.

Every cap here is small enough to move what it caps: each test asserts the
capped output differs from the uncapped one by more than 100x its
tolerance, so that a path that ignores the cap fails.

Tolerances (float32), and why:
  * B10's plain version against the reference's `flash_attention`: 2e-4
    (the reference kernel test's), both float32, summation order apart;
  * the flash backward against `jax.grad` through `_flash_ad`: 1e-5 in
    relative norm (measured up to 3.1e-7: one closed-form derivative
    against autodiff of the same float32 expressions);
  * prefill logits 1e-4 and decode logits 2e-2 (quantized ring) or 1e-4
    (raw ring), as `tests/test_torch_serve.py` holds the uncapped model;
  * `loss_fn`'s gradients within 1e-5 in relative norm (measured up to
    1.2e-6), the loss 1e-5 relative (measured equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget
from repro.launch import serve as rserve
from repro.models import layers as rl
from repro.models import transformer as rt
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import named_to_tree, params_from_numpy

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

F32_TOL = 2e-4
#: the model tests' cap: qwen3's normed q and k give scaled scores of
#: order 1 at head dim 32, so a cap of 1 bends most of them
MODEL_CAP = 1.0
S, GEN = 150, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _qkv(seed, b, sq, sk, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kh, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kh, dh)).astype(np.float32))


# --------------------------------------------------------------- kernel B10 --
#: (B, Sq, Sk, H, K, Dh, window, causal, cap); Sk != Sq reads keys at
#: positions arange(Sk) against queries at arange(Sq), as B10's contract
CAP_CASES = [
    (2, 40, 40, 4, 2, 16, None, True, 1.0),
    (2, 64, 64, 4, 1, 32, 9, True, 0.5),  # windowed: late rows' leading keys masked
    (1, 37, 50, 4, 2, 16, None, True, 2.0),  # ragged, Sk > Sq
    (1, 40, 29, 8, 2, 64, 12, True, 1.5),  # Sk < Sq, windowed (no row wholly masked), Dh 64
    (1, 30, 30, 2, 2, 128, None, False, 3.0),  # not causal, Dh 128
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,cap", CAP_CASES)
def test_plain_b10_with_cap_matches_reference_scan(B, Sq, Sk, H, K, Dh, window, causal, cap):
    """`ops.flash_attention_fwd(softcap=)` on the CPU (the plain version)
    against the reference's blocked scan with the same cap, and the cap
    moves the output by more than 100x the tolerance."""
    q, k, v = _qkv(B * Sq + Sk + Dh, B, Sq, Sk, H, K, Dh)
    qpos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    want = jax.jit(lambda q, k, v: rl.flash_attention(q, k, v, qpos, kpos, window=window, causal=causal,
                                                      kv_block=16, softcap=cap))(q, k, v)
    got = ops.flash_attention_fwd(_t(q), _t(k), _t(v), window=window, causal=causal, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    plain = ops.flash_attention_fwd(_t(q), _t(k), _t(v), window=window, causal=causal)
    assert (got - plain).abs().max().item() > 100 * F32_TOL


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal,cap", CAP_CASES)
def test_plain_lse_form_with_cap(B, Sq, Sk, H, K, Dh, window, causal, cap):
    """The lse form's out is the plain form's; its lse is the log-sum-exp
    of the capped, masked scores (float64 numpy), within 1e-5."""
    q, k, v = _qkv(7 * Sq + Dh, B, Sq, Sk, H, K, Dh)
    out, lse = ops.flash_attention_fwd_lse(_t(q), _t(k), _t(v), window=window, causal=causal, softcap=cap)
    assert torch.equal(out, ref.flash_reference(_t(q), _t(k), _t(v), window, causal, cap))
    kk = np.repeat(k, H // K, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(Dh)
    s = cap * np.tanh(s / cap)
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = np.where(mask, s, -1e30)
    mx = s.max(axis=-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    _, lse_plain = ops.flash_attention_fwd_lse(_t(q), _t(k), _t(v), window=window, causal=causal)
    assert (lse - lse_plain).abs().max().item() > 100 * 1e-5


def test_masked_keys_are_not_capped():
    """A masked key weighs 0 under a cap: the output of a row equals the
    output over its unmasked keys alone (a capped -1e30 would be -cap and
    give a masked key the weight exp(-cap - m))."""
    q, k, v = (_t(a) for a in _qkv(3, 1, 12, 12, 2, 1, 16))
    got = ops.flash_attention_fwd(q, k, v, window=3, softcap=0.5)
    row = 9
    alone = ops.flash_attention_fwd(q[:, row - 2:row + 1].contiguous(), k[:, row - 2:row + 1].contiguous(),
                                    v[:, row - 2:row + 1].contiguous(), softcap=0.5)
    torch.testing.assert_close(got[:, row], alone[:, -1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [0.0, -1.0, float("inf"), float("nan")])
def test_wrapper_refuses_a_cap_that_is_not_finite_and_positive(bad):
    q, k, v = (torch.zeros(s) for s in ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
    for fn in (ops.flash_attention_fwd, ops.flash_attention_fwd_lse, ops.flash_attention_fwd_lse_fma):
        with pytest.raises(ValueError, match="softcap"):
            fn(q, k, v, softcap=bad)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_backward_with_cap_matches_reference_autodiff(window):
    """dq, dk, dv of `FlashAttention` with a cap against `jax.grad` of the
    reference's capped `flash_attention` (its `_flash_ad` path), within
    1e-5 in relative norm; the cap moves each by more than 100x that."""
    b, s, h, kh, dh = 2, 48, 4, 2, 16
    q, k, v = _qkv(11, b, s, s, h, kh, dh)
    dout = np.random.default_rng(12).normal(size=(b, s, h, dh)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def ref_grads(cap):
        f = lambda q, k, v: jnp.sum(rl.flash_attention(q, k, v, pos, pos, window=window, kv_block=16,
                                                       softcap=cap) * dout)
        return jax.jit(jax.grad(f, (0, 1, 2)))(q, k, v)

    def port_grads(cap):
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out = tl.FlashAttention.apply(tq, tk, tv, window, True, cap)
        torch.sum(out * _t(dout)).backward()
        return tq.grad, tk.grad, tv.grad

    capped, plain = port_grads(1.0), port_grads(None)
    for got, want, uncapped in zip(capped, ref_grads(1.0), plain):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
        assert _rel(uncapped.numpy(), np.asarray(want)) > 100 * 1e-5


# --------------------------------------------------------------- the model --
def _cfgs(dtype="float32", **kw):
    kw.setdefault("attn_logit_softcap", MODEL_CAP)
    return (rget("qwen3-1.7b").model.reduced(dtype=dtype, **kw),
            get_arch("qwen3-1.7b").model.reduced(dtype=dtype, **kw))


class Capped:
    """A capped reduced qwen3-1.7b: reference parameters, their port, the
    jitted reference steps, prompts, and the uncapped port of the same
    parameters."""

    def __init__(self, **kw):
        self.cfg, self.tcfg = _cfgs(**kw)
        self.params = rt.init_params(self.cfg, jax.random.PRNGKey(0))
        self.tree = jax.tree_util.tree_map(np.asarray, self.params)
        self.model = params_from_numpy(self.tree, self.tcfg, "cpu")
        self.uncapped_cfg = dataclasses.replace(self.tcfg, attn_logit_softcap=None)
        cfg = self.cfg
        self.prefill = jax.jit(lambda p, x, n: rt.prefill(p, cfg, x, n), static_argnums=2)
        self.decode = jax.jit(lambda p, c, t: rt.decode_step(p, cfg, c, t))
        rng = np.random.default_rng(1)
        self.toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        self.steps = rng.integers(0, cfg.vocab_size, (GEN, 2, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def quant():
    return Capped()


@pytest.fixture(scope="module")
def raw():
    return Capped(kv_quant=False)


def _port_cache(cache_r):
    return {"pos": int(cache_r["pos"]),
            "layers": {k: torch.from_numpy(np.array(v)) for k, v in cache_r["layers"].items()}}


@pytest.mark.parametrize("which,decode_tol", [("quant", 2e-2), ("raw", 1e-4)])
def test_capped_prefill_and_decode_match_reference(request, which, decode_tol):
    """Prefill logits within 1e-4; decode logits, from the reference's own
    prefill cache carried across, within `decode_tol` (the quantized ring is
    read through bf16 on both sides, ROADMAP C5). The uncapped model on the
    same inputs is more than 100x 1e-4 from the reference's prefill logits,
    and from each decode step's by more than that and 2x `decode_tol`."""
    m = request.getfixturevalue(which)
    cache_r, log_r = m.prefill(m.params, jnp.asarray(m.toks), S + GEN)
    cache_t, log_t = tt.prefill(m.model, m.tcfg, torch.from_numpy(m.toks), S + GEN)
    np.testing.assert_allclose(_np(log_t), np.asarray(log_r), rtol=0, atol=1e-4)
    _, log_u = tt.prefill(m.model, m.uncapped_cfg, torch.from_numpy(m.toks), S + GEN)
    assert np.abs(_np(log_u) - np.asarray(log_r)).max() > 100 * 1e-4
    carried = _port_cache(cache_r)
    uncapped = _port_cache(cache_r)
    for t in m.steps:
        cache_r, lr = m.decode(m.params, cache_r, jnp.asarray(t))
        carried, lt = tt.decode_step(m.model, m.tcfg, carried, torch.from_numpy(t))
        uncapped, lu = tt.decode_step(m.model, m.uncapped_cfg, uncapped, torch.from_numpy(t))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=decode_tol)
        assert np.abs(_np(lu) - np.asarray(lr)).max() > max(100 * 1e-4, 2 * decode_tol)


def test_capped_serve_tokens_equal_the_reference():
    """`serve()` of the capped model: greedy tokens equal to the reference's
    in float32, and other than the uncapped model's."""
    cfg, tcfg = _cfgs()
    batch, prompt_len, gen, seed = 2, 100, 6, 0
    run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
    key = jax.random.PRNGKey(seed)
    tree = jax.tree_util.tree_map(np.asarray, rt.init_params(cfg, key))
    prompts = np.asarray(jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size))
    run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, device="cpu", params=tree,
                         prompts=prompts)
    np.testing.assert_array_equal(run_t.tokens, run_r.tokens)
    run_u = tserve.serve(dataclasses.replace(tcfg, attn_logit_softcap=None), batch=batch,
                         prompt_len=prompt_len, gen=gen, device="cpu", params=tree, prompts=prompts)
    assert not np.array_equal(run_u.tokens, run_r.tokens)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_capped_loss_and_grads_match_reference(remat):
    """`loss_fn` of the capped model in float32 against `jax.value_and_grad`
    of the reference's (its `_flash_ad` path): the loss within 1e-5
    relative, every parameter's gradient within 1e-5 in relative norm; the
    uncapped gradients of the attention weights are more than 100x that
    away."""
    cfg, tcfg = _cfgs(n_layers=2, remat=remat)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, cfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.tree_util.tree_map(np.asarray, g)

    def port(c):
        model = params_from_numpy(tree, c, "cpu", param_dtype="float32")
        tloss, _ = tt.loss_fn(model, c, {k: _t(v) for k, v in batch.items()})
        tloss.backward()
        return tloss.item(), named_to_tree({k: p.grad.numpy() for k, p in model.named_parameters()})

    tloss, got = port(tcfg)
    assert abs(tloss - float(loss)) <= 1e-5 * abs(float(loss))
    _, uncapped = port(dataclasses.replace(tcfg, attn_logit_softcap=None))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node, free = got, uncapped
        for k in path:
            node, free = node[k.key], free[k.key]
        name = "/".join(k.key for k in path)
        assert _rel(node, leaf) <= 1e-5, name
        if name.startswith("layers/attn/"):
            assert _rel(free, leaf) > 100 * 1e-5, name
